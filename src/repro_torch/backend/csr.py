"""Padded-CSR gather / scatter backend, ``torch-csr`` (port of the
``jnp-csr`` half of ``repro.backend.jnp_backends``; the reference's name is
registered as an alias).

Products by gather + contraction (``A @ V``) and scatter-add
(``A^T @ U``, ``index_add_``, whose float atomics on the card make it
correct to 1e-4 but not bitwise repeatable there).  They are size-triggered:
once the (rows, cap, k) gather / contribution temporary would exceed
``SPMM_CHUNK_ELEMS`` elements, they accumulate over the capacity axis in
``SPMM_CHUNK_WIDTH``-wide slices (``spmm_chunked`` / ``spmm_t_chunked``).
``SPMM_BF16`` additionally gathers in bf16 with f32 accumulation on the
chunked path.  The three are read from the reference's environment
variables (``REPRO_SPMM_CHUNK_ELEMS``, ``REPRO_SPMM_CHUNK_WIDTH``,
``REPRO_SPMM_BF16``).

This is the plain-PyTorch reference path of the port, not a kernel: the
reference leaves the same products to XLA.  Its epilogue is unfused, as the
reference's is: relu, then the eager bisection threshold and mask.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.backend.base import LocalExecution, register_backend
from repro_torch.device import resolve_device
from repro_torch.sparse.csr import (
    SpCSR, from_dense, from_scipy, spmm, spmm_chunked, spmm_t, spmm_t_chunked,
)

__all__ = ["TorchCsrBackend", "SPMM_CHUNK_ELEMS", "SPMM_CHUNK_WIDTH",
           "SPMM_BF16"]

#: element count of the (rows, cap, k) temporary above which the products
#: accumulate over the capacity axis in slices (default 32 Mi elements,
#: 128 MB in f32); monkeypatch the module attribute in tests
SPMM_CHUNK_ELEMS = int(os.environ.get("REPRO_SPMM_CHUNK_ELEMS",
                                      str(32 * 1024 * 1024)))
#: capacity-axis slice width of the chunked accumulation
SPMM_CHUNK_WIDTH = int(os.environ.get("REPRO_SPMM_CHUNK_WIDTH", "64"))
#: gather in bfloat16 (f32 accumulation) on the chunked path
SPMM_BF16 = os.environ.get("REPRO_SPMM_BF16", "0").lower() in ("1", "true")


def _chunked_spmm_config(a: SpCSR, k: int):
    """(use_chunked, compute_dtype) for an (a, k)-shaped product."""
    rows, cap = a.values.shape
    if rows * cap * k <= SPMM_CHUNK_ELEMS or cap <= SPMM_CHUNK_WIDTH:
        return False, None
    return True, (torch.bfloat16 if SPMM_BF16 else None)


class TorchCsrBackend(LocalExecution):
    """Padded-CSR gather / scatter products on ``SpCSR`` operands."""

    name = "torch-csr"
    fuse_epilogue = False

    def accepts(self, a) -> bool:
        return isinstance(a, SpCSR)

    def prepare(self, a, dtype=None, device=None) -> SpCSR:
        device = resolve_device(device)
        if not isinstance(a, SpCSR):
            if hasattr(a, "tocoo"):  # scipy sparse
                a = from_scipy(a)
            else:
                a = from_dense(a if isinstance(a, torch.Tensor)
                               else np.asarray(a))
        values = a.values.to(device=device, dtype=dtype)
        return SpCSR(values, a.cols.to(device), a.shape)

    def matmul(self, a, v):
        chunked, cd = _chunked_spmm_config(a, v.shape[1])
        if chunked:
            return spmm_chunked(a, v, chunk=SPMM_CHUNK_WIDTH,
                                compute_dtype=cd)
        return spmm(a, v)

    def matmul_t(self, a, u):
        chunked, cd = _chunked_spmm_config(a, u.shape[1])
        if chunked:
            return spmm_t_chunked(a, u, chunk=SPMM_CHUNK_WIDTH,
                                  compute_dtype=cd)
        return spmm_t(a, u)

    def gram(self, x):
        return x.T @ x

    def local_dot(self, a, u, v):
        """<A, U V^T> over the stored slots."""
        rows = torch.arange(a.n, device=a.device)[:, None].expand(
            a.cols.shape)
        dots = torch.sum(u[rows] * v[a.cols.long()], dim=-1)
        return torch.sum(a.values * dots)


register_backend(TorchCsrBackend(), aliases=("jnp-csr",))
