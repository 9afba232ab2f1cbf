"""Plain PyTorch versions of every kernel (port of ``repro.kernels.ref``).

Each is the same function as its hand-written kernel.  A wrapper runs it
for CPU tensors (the test suite), and ``chip_smoke.py`` holds each kernel
against it on the card.  None of them is a yardstick of speed.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.bsr import BSR

__all__ = ["bsr_spmm_ref", "bsr_spmm_gram_ref", "flash_attention_ref",
           "gram_ref", "project_mask_ref", "unreferenced_rows"]


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


#: the flash kernel's masked score (``repro.kernels.flash_attention.NEG_INF``)
FLASH_NEG_INF = -1e30
#: query rows per step of ``flash_attention_ref``: its scores stay
#: (B, H, _FLASH_REF_ROWS, T), so the card can run it at S = 32768
_FLASH_REF_ROWS = 256


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, groups: int = 1) -> torch.Tensor:
    """The flash kernel's function in plain PyTorch, ``_FLASH_REF_ROWS``
    query rows at a time: f32 scores times
    ``hd**-0.5``, masked to -1e30 where key > row (absolute indices), the
    unnormalised ``p = exp(s - max)`` summed in f32, ``p`` cast to v's dtype
    before ``P @ V`` in f32, and ``acc / max(l, 1e-30)`` cast to q's dtype.
    Query head h reads KV head ``h // groups``."""
    b, h, sq, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kf = k.float()[:, :, None]                           # (B, Hkv, 1, T, hd)
    vf = v.float()[:, :, None]
    kpos = torch.arange(t, device=q.device)
    out = torch.empty((b, h, sq, hd), dtype=q.dtype, device=q.device)
    for s0 in range(0, sq, _FLASH_REF_ROWS):
        qc = q[:, :, s0:s0 + _FLASH_REF_ROWS].float()
        c = qc.shape[2]
        qc = qc.reshape(b, hkv, groups, c, hd)
        s = (qc @ kf.transpose(-1, -2)) * hd ** -0.5     # (B, Hkv, G, c, T)
        if causal:
            qpos = torch.arange(s0, s0 + c, device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], FLASH_NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        den = p.sum(-1, keepdim=True).clamp_min(1e-30)
        acc = p.to(v.dtype).float() @ vf
        out[:, :, s0:s0 + c] = (acc / den).reshape(b, h, c, hd).to(q.dtype)
    return out


def project_mask_ref(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """``y = max(x, 0); where(y >= tau, y, 0)``."""
    y = torch.clamp_min(x, 0.0)
    return torch.where(y >= tau.to(x.dtype), y, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
