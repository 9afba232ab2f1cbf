"""The Hopper kernel backend: BSR streaming-tile products on ``BSROperand``
(port of ``repro.backend.pallas_bsr``).

``matmul`` / ``matmul_t`` run the CUDA ``bsr_spmm`` kernel on the two BSR
orientations built once at ingest; ``gram`` runs the CUDA Gram kernel.
The half-step hooks ``matmul_with_gram`` / ``matmul_t_with_gram`` run the
fused CUDA spmm + Gram kernel, one sweep for the product and the Gram.  The
epilogue is the relu + top-t threshold and mask in one CUDA launch
(``relu_topk``).

Two registry entries share the class:

* ``cuda-bsr`` — the default, fused half-step (alias ``pallas-bsr``);
* ``cuda-bsr-unfused`` — separate ``bsr_spmm`` and ``gram`` launches (alias
  ``pallas-bsr-unfused``), the reference the fusion is measured against.
  The fused backend also takes the separate launches when the factor is
  wider than the fused kernel takes at the operand's tiles (``_fusable``).

Tile sizes resolve through the tile ledger
(:func:`repro_torch.kernels.autotune.resolve_tiles`) unless pinned at
construction: ``bm`` / ``bk`` at ingest, ``kb`` (the column chunk) at each
product.

On CPU tensors every kernel wrapper runs its plain version.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.backend.base import LocalExecution, register_backend
from repro_torch.device import resolve_device
from repro_torch.kernels.autotune import (
    SMEM_BUDGET, device_kind, fused_working_set, resolve_tiles,
)
from repro_torch.kernels.bsr import BSROperand, bsr_operand
from repro_torch.kernels.ops import (
    gram_matrix, spmm, spmm_gram, spmm_t, spmm_t_gram,
)
from repro_torch.sparse.csr import SpCSR, to_scipy


class CudaBsrBackend(LocalExecution):
    """Block-sparse products over the two-orientation BSR operand."""

    fuse_epilogue = True

    def __init__(self, bm: int | None = None, bk: int | None = None, *,
                 fuse_halfstep: bool = True, name: str = "cuda-bsr"):
        self.name = name
        #: explicit tile dims pin the ingest blocking; ``None`` resolves per
        #: operand shape through the tile ledger
        self.bm = bm
        self.bk = bk
        #: False = the separate-launch path (spmm, then gram)
        self.fuse_halfstep = fuse_halfstep

    def tile_config(self, n: int, m: int, k: int | None = None,
                    device=None):
        """Ledger-resolved tile sizes for an (n, m[, k]) call site on
        ``device`` (the current card, or the CPU where there is none), with
        the construction-time ``bm`` / ``bk`` pins applied on top."""
        tiles = resolve_tiles(n, m, k, device=device_kind(device))
        if self.bm is not None or self.bk is not None:
            tiles = dataclasses.replace(
                tiles,
                bm=self.bm if self.bm is not None else tiles.bm,
                bk=self.bk if self.bk is not None else tiles.bk)
        return tiles

    def accepts(self, a) -> bool:
        return isinstance(a, BSROperand)

    def prepare(self, a, dtype=None, device=None) -> BSROperand:
        """Ingest dense / scipy-sparse / SpCSR / BSR input into the
        two-orientation BSR operand on ``device``, at the ledger's tiles for
        its shape; sparse input never touches a dense (n, m) matrix.  A
        bf16 ``dtype`` is ingested in f32 on the host and cast on the
        device (numpy has no bf16)."""
        device = resolve_device(device)
        if isinstance(a, BSROperand):
            return a.to(device)
        if isinstance(a, SpCSR):
            a = to_scipy(a)  # nnz-proportional host round-trip
        tiles = self.tile_config(*a.shape, device=device)
        return bsr_operand(a, bm=tiles.bm, bk=tiles.bk, dtype=dtype,
                           device=device)

    def _kb(self, a: BSROperand, x: torch.Tensor) -> int:
        """The column chunk of both orientations' kernels, from the ledger
        entry of the operand's (n, m) and the factor's rank."""
        return self.tile_config(a.n, a.m, x.shape[1], x.device).kb

    def matmul(self, a: BSROperand, v: torch.Tensor) -> torch.Tensor:
        return spmm(a.bsr, v, kb=self._kb(a, v))

    def matmul_t(self, a: BSROperand, u: torch.Tensor) -> torch.Tensor:
        return spmm_t(a.bsr_t, u, kb=self._kb(a, u))

    def gram(self, x: torch.Tensor) -> torch.Tensor:
        # the kernel accumulates in f32; cast back to the factor dtype
        return gram_matrix(x).to(x.dtype)

    def _fusable(self, bsr, x: torch.Tensor) -> bool:
        """The fused kernel holds a ring of at least two (tile, full-rank
        slab) stages and the k x k f32 Gram partial in a block's shared
        memory: take the separate launches where they do not fit (or when
        fusion is off)."""
        if not self.fuse_halfstep:
            return False
        ws = fused_working_set(bsr.bm, bsr.bk, x.shape[1], x.element_size())
        return ws <= SMEM_BUDGET

    def matmul_with_gram(self, a: BSROperand, v: torch.Tensor):
        if not self._fusable(a.bsr, v):
            return super().matmul_with_gram(a, v)
        y, g = spmm_gram(a.bsr, v, kb=self._kb(a, v))
        return y, g.to(v.dtype)

    def matmul_t_with_gram(self, a: BSROperand, u: torch.Tensor):
        if not self._fusable(a.bsr_t, u):
            return super().matmul_t_with_gram(a, u)
        y, g = spmm_t_gram(a.bsr_t, u, kb=self._kb(a, u))
        return y, g.to(u.dtype)


register_backend(CudaBsrBackend(), aliases=("pallas-bsr",))
register_backend(CudaBsrBackend(fuse_halfstep=False, name="cuda-bsr-unfused"),
                 aliases=("pallas-bsr-unfused",))
