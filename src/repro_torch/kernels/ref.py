"""Plain PyTorch versions of every kernel (port of ``repro.kernels.ref``).

Each is the same function as its hand-written kernel.  A wrapper runs it
for CPU tensors (the test suite), and ``chip_smoke.py`` holds each kernel
against it on the card.  None of them is a yardstick of speed.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.bsr import BSR

__all__ = ["bsr_spmm_ref", "bsr_spmm_gram_ref", "gram_ref",
           "project_mask_ref", "unreferenced_rows"]


def bsr_spmm_ref(a: BSR, u: torch.Tensor) -> torch.Tensor:
    """dense(A) @ U over the stored tiles: gather each slot's U slab (rows
    >= m read as zero) and contract tile by tile."""
    nrb, bcap, bm, bk = a.tiles.shape
    n, m = a.shape
    k = u.shape[1]
    ncb = -(-m // bk)
    u_blk = torch.nn.functional.pad(u, (0, 0, 0, ncb * bk - m)).reshape(
        ncb, bk, k)
    slabs = u_blk[a.block_cols.long()]                  # (nrb, bcap, bk, k)
    y = torch.einsum("isrc,iscd->ird", a.tiles.to(u.dtype), slabs)
    return y.reshape(nrb * bm, k)[:n]


def gram_ref(u: torch.Tensor) -> torch.Tensor:
    """U^T U in f32."""
    uf = u.float()
    return uf.T @ uf


def unreferenced_rows(a: BSR, u: torch.Tensor) -> torch.Tensor:
    """U with every row zeroed except those of column blocks that no slot
    of ``a`` references (the Gram correction's operand)."""
    return torch.where(a.uncovered_rows[:, None], u,
                       torch.zeros((), dtype=u.dtype, device=u.device))


def bsr_spmm_gram_ref(a: BSR, u: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dense(A) @ U, U^T U)`` built the way the fused kernel builds it:
    the Gram of every first-occurrence slab (the flags fixed at ingest),
    plus the Gram of the rows no slot references.  Gram in f32."""
    bk = a.bk
    m, k = u.shape
    ncb = -(-m // bk)
    u_blk = torch.nn.functional.pad(u.float(), (0, 0, 0, ncb * bk - m)
                                    ).reshape(ncb, bk, k)
    slabs = u_blk[a.block_cols.long()[a.gram_flags != 0]]   # (nflag, bk, k)
    g = torch.einsum("sjc,sjd->cd", slabs, slabs)
    if a.uncovered_rows is not None:
        g = g + gram_ref(unreferenced_rows(a, u))
    return bsr_spmm_ref(a, u), g


def project_mask_ref(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """``y = max(x, 0); where(y >= tau, y, 0)``."""
    y = torch.clamp_min(x, 0.0)
    return torch.where(y >= tau.to(x.dtype), y, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
