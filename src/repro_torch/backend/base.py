"""Matmul-backend protocol, registry, and selection (port of
``repro.backend.base``).

The ALS hot spot is three products — ``A @ V``, ``A^T @ U`` and the small
Grams ``X^T X`` — and a :class:`MatmulBackend` bundles one implementation of
the trio.  The engine's residual / error / nnz bookkeeping runs through the
reduction hooks ``reduce_u`` / ``reduce_v`` (identity on one device,
:class:`LocalExecution`; mesh sums once the sharded engine is ported) and
the metric hooks ``sqnorm`` / ``relative_error``.

Selection rules (:func:`select_backend` / :func:`default_backend_name`):

* an operand already in a backend's native format picks that backend
  (``BSROperand`` -> ``cuda-bsr``, a dense tensor -> ``torch-dense``);
* sparse *input* (scipy sparse, ``SpCSR``) defaults to ``cuda-bsr`` on every
  device until the padded-CSR backend is ported; on the CPU its kernels run
  their plain versions;
* ``NMFConfig(backend=...)`` overrides everything.  The reference's names
  (``pallas-bsr``, ``pallas-bsr-unfused``, ``jnp-dense``) are registered as
  aliases, so configs carry over.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Protocol, runtime_checkable

import torch

__all__ = ["MatmulBackend", "LocalExecution", "register_backend",
           "get_backend", "available_backends", "select_backend",
           "resolve_backend", "default_backend_name"]


@runtime_checkable
class MatmulBackend(Protocol):
    """Strategy for the three ALS products plus operand ingest."""

    #: registry key, e.g. ``"cuda-bsr"``
    name: str
    #: True when the backend wants the fused relu + threshold-mask epilogue
    fuse_epilogue: bool

    def accepts(self, a) -> bool:
        """True when ``a`` is already this backend's native operand."""
        ...

    def prepare(self, a, dtype=None, device=None):
        """Coerce input (dense, scipy sparse, SpCSR, BSROperand) to this
        backend's native operand on ``device``; host-side, once at
        ingest."""
        ...

    def matmul(self, a, v: torch.Tensor) -> torch.Tensor:
        """A @ V -> (n, k)."""
        ...

    def matmul_t(self, a, u: torch.Tensor) -> torch.Tensor:
        """A^T @ U -> (m, k)."""
        ...

    def gram(self, x: torch.Tensor) -> torch.Tensor:
        """X^T X -> (k, k), the local Gram."""
        ...

    def matmul_with_gram(self, a, v: torch.Tensor):
        """``(A @ V, V^T V)``: one sweep where the backend owns a fused
        kernel, the separate calls otherwise."""
        ...

    def matmul_t_with_gram(self, a, u: torch.Tensor):
        """``(A^T @ U, U^T U)``, same contract."""
        ...

    def reduce_u(self, x: torch.Tensor) -> torch.Tensor:
        ...

    def reduce_v(self, x: torch.Tensor) -> torch.Tensor:
        ...

    def sqnorm(self, a) -> torch.Tensor:
        """``||A||_F^2`` of the operand."""
        ...

    def relative_error(self, a, u: torch.Tensor, v: torch.Tensor,
                       a_sqnorm: torch.Tensor) -> torch.Tensor:
        """``||A - U V^T||_F / ||A||_F``."""
        ...



class LocalExecution:
    """Single-device execution hooks shared by the local backends:
    reductions are identity and the metric hooks delegate to the
    operand-type dispatch in :mod:`repro_torch.core.nmf`."""

    def reduce_u(self, x):
        return x

    def reduce_v(self, x):
        return x

    def matmul_with_gram(self, a, v):
        return self.matmul(a, v), self.gram(v)

    def matmul_t_with_gram(self, a, u):
        return self.matmul_t(a, u), self.gram(u)

    def sqnorm(self, a):
        from repro_torch.core.nmf import _sqnorm

        return _sqnorm(a)

    def relative_error(self, a, u, v, a_sqnorm):
        from repro_torch.core.nmf import _relative_error

        return _relative_error(a, u, v, a_sqnorm)


_REGISTRY: Dict[str, MatmulBackend] = {}


def register_backend(backend: MatmulBackend,
                     aliases: Iterable[str] = ()) -> MatmulBackend:
    """Register a backend singleton under ``backend.name`` and any
    ``aliases``."""
    for key in (backend.name, *aliases):
        _REGISTRY[key] = backend
    return backend


def get_backend(name: str) -> MatmulBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown matmul backend {name!r}; available: "
            f"{available_backends()}") from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


def select_backend(a) -> MatmulBackend:
    """Auto-select by operand type (see module docstring)."""
    for backend in _REGISTRY.values():
        if backend.accepts(a):
            return backend
    raise TypeError(
        f"no registered matmul backend accepts operand of type "
        f"{type(a).__name__}; available: {available_backends()}")


def resolve_backend(a, name: Optional[str] = None) -> MatmulBackend:
    """Backend for an already-ingested operand: the named one (checked
    against the operand type) or the type-selected default."""
    if name is None:
        return select_backend(a)
    backend = get_backend(name)
    if not backend.accepts(a):
        raise TypeError(
            f"backend {name!r} cannot consume operand of type "
            f"{type(a).__name__}; ingest it first with "
            f"get_backend({name!r}).prepare(...)")
    return backend


def default_backend_name(a) -> str:
    """Ingest-time default for raw input: sparse input goes to the BSR
    kernel path; everything else keeps its native format."""
    from repro_torch.sparse.csr import SpCSR

    if hasattr(a, "tocoo") or isinstance(a, SpCSR):
        return "cuda-bsr"
    return select_backend(a).name
