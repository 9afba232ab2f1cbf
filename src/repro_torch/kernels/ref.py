"""Plain PyTorch versions of every kernel (port of ``repro.kernels.ref``).

Each is the same function as its hand-written kernel.  A wrapper runs it
for CPU tensors (the test suite), and ``chip_smoke.py`` holds each kernel
against it on the card.  None of them is a yardstick of speed.  bf16 input
is computed as the kernels compute it: widened to f32, accumulated in f32,
the product rounded back to bf16 once (the Gram stays f32); the bisection
compares the widened entries with f32 midpoints.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.bsr import BSR

__all__ = ["bsr_spmm_ref", "bsr_spmm_gram_ref", "bsr_spmm_run_partials",
           "flash_attention_ref", "gram_ref", "project_mask_ref",
           "relu_topk_ref", "relu_topk_rounds_ref", "topk_threshold_bisect",
           "unreferenced_rows"]


def _u_blocks(a: BSR, u: torch.Tensor) -> torch.Tensor:
    """U as (column blocks, bk, k), rows >= m read as zero."""
    m, k = u.shape
    ncb = -(-m // a.bk)
    return torch.nn.functional.pad(u, (0, 0, 0, ncb * a.bk - m)).reshape(
        ncb, a.bk, k)


def bsr_spmm_ref(a: BSR, u: torch.Tensor) -> torch.Tensor:
    """dense(A) @ U over the stored tiles: gather each slot's U slab (rows
    >= m read as zero) and contract tile by tile."""
    acc = torch.float32 if u.dtype == torch.bfloat16 else u.dtype
    slabs = _u_blocks(a, u.to(acc))[a.block_cols.long()]  # (nrb, bcap, bk, k)
    y = torch.einsum("isrc,iscd->ird", a.tiles.to(acc), slabs)
    return y.reshape(a.nrb * a.bm, u.shape[1])[:a.shape[0]].to(u.dtype)


def bsr_spmm_run_partials(a: BSR, u: torch.Tensor) -> torch.Tensor:
    """(runs, n, k): what each run of ``a.plan`` adds to dense(A) @ U, the
    products of its own slots only.  The kernels add these in run order
    (inside a row-block only, the rest being zero)."""
    nrb, bcap, bm, bk = a.tiles.shape
    n, k = a.shape[0], u.shape[1]
    slabs = _u_blocks(a, u)[a.block_cols.long()].reshape(nrb * bcap, bk, k)
    per_slot = torch.einsum("src,scd->srd",
                            a.tiles.to(u.dtype).reshape(nrb * bcap, bm, bk),
                            slabs)                      # (slots, bm, k)
    rb_of_slot = torch.arange(nrb * bcap, device=u.device) // bcap
    bounds = a.plan.bounds.tolist()
    out = torch.zeros((len(bounds) - 1, nrb, bm, k), dtype=u.dtype,
                      device=u.device)
    for r, (b0, b1) in enumerate(zip(bounds[:-1], bounds[1:])):
        out[r].index_add_(0, rb_of_slot[b0:b1], per_slot[b0:b1])
    return out.reshape(-1, nrb * bm, k)[:, :n]


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
    u_blk = _u_blocks(a, u.float())
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
                        causal: bool = True, groups: int = 1,
                        lse: bool = False):
    """The flash kernel's function in plain PyTorch, ``_FLASH_REF_ROWS``
    query rows at a time: f32 scores times
    ``hd**-0.5``, masked to -1e30 where key > row (absolute indices), the
    unnormalised ``p = exp(s - max)`` summed in f32, ``p`` cast to v's dtype
    before ``P @ V`` in f32, and ``acc / max(l, 1e-30)`` cast to q's dtype.
    Query head h reads KV head ``h // groups``.  With ``lse`` also returns
    each row's ``max + log(sum p)`` (B, H, Sq) in f32, the kernel's
    log-sum-exp: -inf for a row with no key (T = 0, whose output is
    zero)."""
    b, h, sq, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, hd), dtype=q.dtype, device=q.device)
    rows = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if t == 0:
        out.zero_()
        rows.fill_(-math.inf)
        return (out, rows) if lse else out
    kf = k.float()[:, :, None]                           # (B, Hkv, 1, T, hd)
    vf = v.float()[:, :, None]
    kpos = torch.arange(t, device=q.device)
    for s0 in range(0, sq, _FLASH_REF_ROWS):
        qc = q[:, :, s0:s0 + _FLASH_REF_ROWS].float()
        c = qc.shape[2]
        qc = qc.reshape(b, hkv, groups, c, hd)
        s = (qc @ kf.transpose(-1, -2)) * hd ** -0.5     # (B, Hkv, G, c, T)
        if causal:
            qpos = torch.arange(s0, s0 + c, device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], FLASH_NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        den = l.clamp_min(1e-30)
        acc = p.to(v.dtype).float() @ vf
        out[:, :, s0:s0 + c] = (acc / den).reshape(b, h, c, hd).to(q.dtype)
        rows[:, :, s0:s0 + c] = (m + torch.log(l)).reshape(b, h, c)
    return (out, rows) if lse else out


def project_mask_ref(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """``y = max(x, 0); where(y >= tau, y, 0)``."""
    y = torch.clamp_min(x, 0.0)
    return torch.where(y >= tau.to(x.dtype), y, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def topk_threshold_bisect(x: torch.Tensor, t: int,
                          num_steps: int = 40) -> torch.Tensor:
    """Return ``tau`` (a 0-d device tensor) such that ``count(|x| >= tau)``
    is as close to ``t`` as float bisection allows (count >= t at the
    returned tau).  Every step stays on the device in f32, in the
    reference's arithmetic, so ``tau`` is bitwise the reference's."""
    absx = torch.abs(x)
    absf = absx.float()  # a bf16 entry meets an f32 midpoint in f32
    hi = torch.max(absx).float()
    lo = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(num_steps):
        mid = 0.5 * (lo + hi)
        # too many kept -> raise threshold (lo=mid); too few -> lower it
        over = torch.sum(absf >= mid) > t
        lo = torch.where(over, mid, lo)
        hi = torch.where(over, hi, mid)
    tau = torch.where(torch.sum(absf >= hi) >= t, hi, lo)
    return tau.to(absx.dtype)


def relu_topk_ref(x: torch.Tensor, t: int, num_steps: int = 40
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``FusedReluTopK``'s function: ``relu`` (``clamp_min``), the
    ``num_steps``-step bisection threshold ``tau`` of the relu'd factor,
    then the mask.  Returns ``(out, tau)``."""
    tau = topk_threshold_bisect(torch.clamp_min(x, 0.0), t, num_steps)
    return project_mask_ref(x, tau), tau


def relu_topk_rounds_ref(x: torch.Tensor, t: int, num_steps: int = 40,
                         steps_per_round: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`relu_topk_ref` in the round structure of the kernel: round 0
    takes ``hi = max(relu(x))``; every later round counts the relu'd factor
    at all ``2^s - 1`` midpoints of the next ``s`` bisection steps (a
    heap-ordered tree: node j's children are ``2j+1`` when the count at its
    midpoint exceeds ``t``, ``2j+2`` when not) and at its incoming ``hi``,
    then walks the ``s`` steps.  Every midpoint is ``0.5 * (lo + hi)`` of
    its own node, so ``tau`` is bitwise the one-step-per-round bisection's
    for any ``steps_per_round``.  Stays on the device: no host sync."""
    if steps_per_round < 1:
        raise ValueError(f"steps_per_round must be >= 1, got "
                         f"{steps_per_round}")
    y = torch.clamp_min(x, 0.0)
    absy = torch.abs(y).float()
    hi = torch.max(absy)
    lo = torch.zeros((), dtype=torch.float32, device=x.device)
    left = num_steps
    while True:
        s = min(steps_per_round, left)
        los, his = lo[None], hi[None]
        mids = []
        for _ in range(steps_per_round):
            mid = 0.5 * (los + his)
            mids.append(mid)
            # children in heap order: (count > t: lo = mid), (else: hi = mid)
            los = torch.stack([mid, los], -1).reshape(-1)
            his = torch.stack([his, mid], -1).reshape(-1)
        th = torch.cat(mids + [hi[None]])
        counts = torch.stack([torch.sum(absy >= v) for v in th])
        c_hi = counts[-1]
        node = torch.zeros((), dtype=torch.long, device=x.device)
        for _ in range(s):
            mid, c = th[node], counts[node]
            over = c > t
            lo = torch.where(over, mid, lo)
            hi = torch.where(over, hi, mid)
            c_hi = torch.where(over, c_hi, c)
            node = 2 * node + torch.where(over, 1, 2)
        left -= s
        if left <= 0:
            break
    tau = torch.where(c_hi >= t, hi, lo).to(x.dtype)
    return project_mask_ref(x, tau), tau
