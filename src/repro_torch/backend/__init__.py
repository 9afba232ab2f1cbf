"""Pluggable matmul backends for the ALS hot path (port of
``repro.backend``).

Registered: ``torch-dense`` (dense baseline, alias ``jnp-dense``),
``torch-csr`` (padded-CSR gather / scatter, alias ``jnp-csr``),
``cuda-bsr`` (the Hopper kernels, fused half-step; alias ``pallas-bsr``)
and ``cuda-bsr-unfused`` (separate launches; alias ``pallas-bsr-unfused``).
The mesh engines wrap ``torch-csr`` or ``cuda-bsr`` blocks in
:class:`repro_torch.backend.sharded.ShardedBackend` (not registered: it
runs on a ``ShardView`` of one rank's block).
"""
from repro_torch.backend.base import (
    LocalExecution, MatmulBackend, available_backends, default_backend_name,
    get_backend, register_backend, resolve_backend, select_backend,
)
from repro_torch.backend import dense as _dense  # noqa: F401 — registers
from repro_torch.backend import csr as _csr  # noqa: F401 — registers
from repro_torch.backend import cuda_bsr as _cuda_bsr  # noqa: F401 — registers
from repro_torch.kernels.bsr import BSROperand

__all__ = [
    "LocalExecution", "MatmulBackend", "BSROperand", "available_backends",
    "default_backend_name", "get_backend", "register_backend",
    "resolve_backend", "select_backend",
]
