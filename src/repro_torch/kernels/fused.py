"""Fused BSR product + Gram, ``(A @ U, U^T U)`` in one sweep (port of
``repro.kernels.fused``).

Replaces the Pallas TPU kernel ``repro/kernels/fused.py::_spmm_gram_kernel``
(launched by ``bsr_spmm_gram``) with the CUDA C++ kernel in
``csrc/bsr_spmm.cu``: the same template and split plan as ``bsr_spmm``, so
the product is bitwise that kernel's at the same column chunk ``kb``, bound
by the same tile bytes (0.18 ms per f32 orientation at PubMed size).  Tiles
and factor are f32 or bf16; the product comes back in the factor's dtype,
the Gram in f32.  Each stage of the ring carries the slot's
full-rank U slab; where the slot holds the first occurrence of its column
block (flags fixed at ingest), the block that streams it adds slab^T slab
with all seven consumer warps (four entries per warp at a time, the bk-long
dot split across the lanes and added by a shuffle tree) into a per-run
k x k partial.  The run that takes the last ticket adds the runs' partials
in run order, in the same launch: no float atomics, bitwise repeatable.
Flagged slots are thus spread over the runs that stream them.  Column
blocks no slot references are folded in afterwards by the Gram of the
masked U (the port's own ``gram`` kernel); ingest records whether there
are any, so a fully covered operand pays nothing and the check costs no
device sync.

The kernel keeps the k x k Gram partial and two stages of (tile, full-rank
slab) in a block's shared memory, so it takes a rank while
``kernels/autotune.py::fused_working_set`` fits the budget
(``fused_max_k``: 75 at 128 x 128 f32 tiles, 149 at 128 x 64); the
``cuda-bsr`` backend takes the separate launches past that.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bsr import BSR, BSROperand
from repro_torch.kernels import bsr_spmm as spmm_kernel
from repro_torch.kernels.autotune import (
    SMEM_BUDGET, fused_max_k, fused_working_set,
)
from repro_torch.kernels.gram import gram

__all__ = ["bsr_spmm_gram", "bsr_spmm_gram_t"]


def _add_unreferenced(a: BSR, u: torch.Tensor, g: torch.Tensor):
    """Fold in the rows of U that no occupied slot references."""
    if a.uncovered_rows is None:
        return g
    return g + gram(ref.unreferenced_rows(a, u))


def bsr_spmm_gram(a: BSR, u: torch.Tensor, kb: Optional[int] = None,
                  stamps: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dense(A) @ U, U^T U)``; the product is bitwise the port's
    :func:`~repro_torch.kernels.bsr_spmm.bsr_spmm` at the same ``kb`` (same
    kernel template; ``None`` resolves it through the tile ledger, as
    ``bsr_spmm`` does), in ``U``'s dtype; the Gram is f32 and agrees with
    ``U^T U`` to f32 roundoff.  ``stamps`` as for ``bsr_spmm``."""
    if not _build.on_card(a.tiles, a.block_cols, a.gram_flags,
                          a.plan.bounds, u):
        return ref.bsr_spmm_gram_ref(a, u)
    spmm_kernel.check_operands(a, u)
    kb = spmm_kernel.resolve_kb(a, u, kb)
    n, m = a.shape
    k = u.shape[1]
    if fused_working_set(a.bm, a.bk, k, u.element_size()) > SMEM_BUDGET:
        raise ValueError(
            f"the fused kernel takes k <= "
            f"{fused_max_k(a.bm, a.bk, u.element_size())} at {a.bm} x "
            f"{a.bk} {u.dtype} tiles, got {k}")
    y = torch.empty((n, k), dtype=u.dtype, device=u.device)
    g = torch.empty((k, k), dtype=torch.float32, device=u.device)
    tickets, part, gram_part = spmm_kernel.scratch(a, k, kb)
    rc = spmm_kernel._lib().bsr_spmm_gram_run(
        a.tiles.data_ptr(), a.block_cols.data_ptr(), a.gram_flags.data_ptr(),
        u.data_ptr(), y.data_ptr(), part.data_ptr(), gram_part.data_ptr(),
        g.data_ptr(),
        a.plan.bounds.data_ptr(), a.plan.rb_runs.data_ptr(),
        tickets.data_ptr(), spmm_kernel.stamps_ptr(a, stamps), n, m, k,
        a.nrb, a.bcap, a.bm, a.bk, a.plan.runs, kb,
        int(u.dtype == torch.bfloat16), _build.stream_ptr(u.device))
    _build.check_rc(rc, "bsr_spmm_gram")
    _build.count_launch("bsr_spmm_gram")
    return y, _add_unreferenced(a, u, g)


def bsr_spmm_gram_t(a, u: torch.Tensor, kb: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dense(A)^T @ U, U^T U)`` via the transposed-format copy; ``a`` is a
    :class:`BSROperand` or the transposed :class:`BSR` itself."""
    a_t = a.bsr_t if isinstance(a, BSROperand) else a
    return bsr_spmm_gram(a_t, u, kb=kb)
