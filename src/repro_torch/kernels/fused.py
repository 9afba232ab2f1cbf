"""Fused BSR product + Gram, ``(A @ U, U^T U)`` in one sweep (port of
``repro.kernels.fused``).

Replaces the Pallas TPU kernel ``repro/kernels/fused.py::_spmm_gram_kernel``
(launched by ``bsr_spmm_gram``) with the CUDA C++ kernel in
``csrc/bsr_spmm.cu``: while a U slab sits in shared memory for the tile
product, its Gram is added once per distinct referenced column block (the
first-occurrence flags fixed at ingest) into per-row-block partials, which a
second launch sums in row-block order, with no float atomics.  Column blocks
no slot references are folded in afterwards by the Gram of the masked U (the
port's own ``gram`` kernel); ingest records whether there are any, so a
fully covered operand pays nothing and the check costs no device sync.
Bound by the bytes of the stored tiles, like ``bsr_spmm``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bsr import BSR, BSROperand
from repro_torch.kernels import bsr_spmm as spmm_kernel
from repro_torch.kernels.autotune import FUSED_MAX_K
from repro_torch.kernels.gram import gram

__all__ = ["bsr_spmm_gram", "bsr_spmm_gram_t"]


def _add_unreferenced(a: BSR, u: torch.Tensor, g: torch.Tensor):
    """Fold in the rows of U that no occupied slot references."""
    if a.uncovered_rows is None:
        return g
    return g + gram(ref.unreferenced_rows(a, u))


def bsr_spmm_gram(a: BSR, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dense(A) @ U, U^T U)``; the product is bitwise the port's
    :func:`~repro_torch.kernels.bsr_spmm.bsr_spmm` (same kernel template),
    the Gram is f32 and agrees with ``U^T U`` to f32 roundoff."""
    if not _build.on_card(a.tiles, a.block_cols, a.gram_flags, u):
        return ref.bsr_spmm_gram_ref(a, u)
    spmm_kernel.check_operands(a, u)
    n, m = a.shape
    k = u.shape[1]
    if k > FUSED_MAX_K:
        raise ValueError(f"the fused kernel takes k <= {FUSED_MAX_K}, "
                         f"got {k}")
    y = torch.empty((n, k), dtype=torch.float32, device=u.device)
    part = torch.empty((a.nrb, k, k), dtype=torch.float32, device=u.device)
    g = torch.empty((k, k), dtype=torch.float32, device=u.device)
    rc = spmm_kernel._lib().bsr_spmm_gram_f32(
        a.tiles.data_ptr(), a.block_cols.data_ptr(), a.gram_flags.data_ptr(),
        u.data_ptr(), y.data_ptr(), part.data_ptr(), g.data_ptr(),
        n, m, k, a.nrb, a.bcap, a.bm, a.bk, _build.stream_ptr(u.device))
    _build.check_rc(rc, "bsr_spmm_gram")
    _build.count_launch("bsr_spmm_gram")
    return y, _add_unreferenced(a, u, g)


def bsr_spmm_gram_t(a, u: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dense(A)^T @ U, U^T U)`` via the transposed-format copy; ``a`` is a
    :class:`BSROperand` or the transposed :class:`BSR` itself."""
    a_t = a.bsr_t if isinstance(a, BSROperand) else a
    return bsr_spmm_gram(a_t, u)
