"""The Hopper kernel backend: BSR streaming-tile products on ``BSROperand``
(port of ``repro.backend.pallas_bsr``).

``matmul`` / ``matmul_t`` run the CUDA ``bsr_spmm`` kernel on the two BSR
orientations built once at ingest; ``gram`` runs the CUDA Gram kernel.
The half-step hooks ``matmul_with_gram`` / ``matmul_t_with_gram`` run the
fused CUDA spmm + Gram kernel, one sweep for the product and the Gram.  The
epilogue is the fused relu + threshold mask (Triton ``project_mask``).

Two registry entries share the class:

* ``cuda-bsr`` — the default, fused half-step (alias ``pallas-bsr``);
* ``cuda-bsr-unfused`` — separate ``bsr_spmm`` and ``gram`` launches (alias
  ``pallas-bsr-unfused``), the reference the fusion is measured against.
  The fused backend also takes the separate launches when the factor is
  wider than the fused kernel takes (``_fusable``).

On CPU tensors every kernel wrapper runs its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.backend.base import LocalExecution, register_backend
from repro_torch.device import resolve_device
from repro_torch.kernels.autotune import (
    DEFAULT_TILES, FUSED_MAX_K, SMEM_BUDGET, fused_working_set,
)
from repro_torch.kernels.bsr import BSROperand, bsr_operand
from repro_torch.kernels.ops import (
    gram_matrix, spmm, spmm_gram, spmm_t, spmm_t_gram,
)
from repro_torch.sparse.csr import SpCSR, to_scipy


def _numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (host ingest casts in numpy)."""
    if dtype is None:
        return None
    return torch.empty((), dtype=dtype).numpy().dtype


class CudaBsrBackend(LocalExecution):
    """Block-sparse products over the two-orientation BSR operand."""

    fuse_epilogue = True

    def __init__(self, *, fuse_halfstep: bool = True,
                 name: str = "cuda-bsr"):
        self.name = name
        #: False = the separate-launch path (spmm, then gram)
        self.fuse_halfstep = fuse_halfstep

    def accepts(self, a) -> bool:
        return isinstance(a, BSROperand)

    def prepare(self, a, dtype=None, device=None) -> BSROperand:
        """Ingest dense / scipy-sparse / SpCSR / BSR input into the
        two-orientation BSR operand on ``device``; sparse input never
        touches a dense (n, m) matrix."""
        device = resolve_device(device)
        if isinstance(a, BSROperand):
            return a.to(device)
        if isinstance(a, SpCSR):
            a = to_scipy(a)  # nnz-proportional host round-trip
        return bsr_operand(a, bm=DEFAULT_TILES.bm, bk=DEFAULT_TILES.bk,
                           dtype=_numpy_dtype(dtype), device=device)

    def matmul(self, a: BSROperand, v: torch.Tensor) -> torch.Tensor:
        return spmm(a.bsr, v)

    def matmul_t(self, a: BSROperand, u: torch.Tensor) -> torch.Tensor:
        return spmm_t(a.bsr_t, u)

    def gram(self, x: torch.Tensor) -> torch.Tensor:
        # the kernel accumulates in f32; cast back to the factor dtype
        return gram_matrix(x).to(x.dtype)

    def _fusable(self, bsr, x: torch.Tensor) -> bool:
        """The fused kernel holds a ring of at least two (tile, full-rank
        slab) stages and the k x k Gram partial in shared memory, and takes
        k <= FUSED_MAX_K: take the separate launches otherwise (or when
        fusion is off)."""
        if not self.fuse_halfstep:
            return False
        k = x.shape[1]
        ws = fused_working_set(bsr.bm, bsr.bk, k, x.element_size())
        return k <= FUSED_MAX_K and ws <= SMEM_BUDGET

    def matmul_with_gram(self, a: BSROperand, v: torch.Tensor):
        if not self._fusable(a.bsr, v):
            return super().matmul_with_gram(a, v)
        y, g = spmm_gram(a.bsr, v)
        return y, g.to(v.dtype)

    def matmul_t_with_gram(self, a: BSROperand, u: torch.Tensor):
        if not self._fusable(a.bsr_t, u):
            return super().matmul_t_with_gram(a, u)
        y, g = spmm_t_gram(a.bsr_t, u)
        return y, g.to(u.dtype)


register_backend(CudaBsrBackend(), aliases=("pallas-bsr",))
register_backend(CudaBsrBackend(fuse_halfstep=False, name="cuda-bsr-unfused"),
                 aliases=("pallas-bsr-unfused",))
