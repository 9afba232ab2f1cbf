"""Public entry points of the port's kernels (port of
``repro.kernels.ops``).

Each function dispatches on where its tensors live: on the card it launches
the hand-written CUDA C++ kernel or raises; on the CPU it runs the kernel's
plain PyTorch version.  There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bsr import (
    BSR, BSROperand, bsr_from_dense, bsr_from_scipy, bsr_operand,
    bsr_to_dense, bsr_transpose,
)
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_t
from repro_torch.kernels.fused import bsr_spmm_gram, bsr_spmm_gram_t
from repro_torch.kernels.gram import gram
from repro_torch.kernels.project_mask import project_mask

__all__ = [
    "BSR", "BSROperand", "bsr_from_dense", "bsr_from_scipy", "bsr_operand",
    "bsr_to_dense", "bsr_transpose", "spmm", "spmm_t", "spmm_gram",
    "spmm_t_gram", "fused_project_mask", "gram_matrix",
]


def spmm(a: BSR, u: torch.Tensor, kb: Optional[int] = None) -> torch.Tensor:
    """dense(A) @ U through the BSR kernel (``kb``: its column chunk,
    ``None`` from the tile ledger)."""
    return bsr_spmm(a, u, kb=kb)


def spmm_t(a, u: torch.Tensor, kb: Optional[int] = None) -> torch.Tensor:
    """dense(A)^T @ U through the BSR kernel on the transposed-format copy
    (``a``: BSROperand, or the transposed BSR itself)."""
    return bsr_spmm_t(a, u, kb=kb)


def spmm_gram(a: BSR, u: torch.Tensor, kb: Optional[int] = None):
    """``(dense(A) @ U, U^T U)`` in one fused sweep; Gram in f32."""
    return bsr_spmm_gram(a, u, kb=kb)


def spmm_t_gram(a, u: torch.Tensor, kb: Optional[int] = None):
    """``(dense(A)^T @ U, U^T U)`` fused, on the transposed-format copy."""
    return bsr_spmm_gram_t(a, u, kb=kb)


def fused_project_mask(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    return project_mask(x, tau)


def gram_matrix(u: torch.Tensor) -> torch.Tensor:
    return gram(u)
