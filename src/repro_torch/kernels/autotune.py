"""Tile sizes of the port's kernels (port of ``repro.kernels.autotune``,
reduced to the audited defaults).

The reference resolves tiles through a measured per-device ledger; the port
has no measured entries yet, so every call site uses :data:`DEFAULT_TILES`.
The ledger and the sweep come in a later slice.  The reference's VMEM
budget becomes a per-block shared-memory budget, which ``cuda-bsr`` checks
before it picks the fused spmm + Gram kernel.
"""
from __future__ import annotations

import dataclasses

__all__ = ["TileConfig", "DEFAULT_TILES", "SMEM_BUDGET", "FUSED_MAX_K",
           "fused_working_set"]

#: dynamic shared memory one block may take without opting in to more
#: (``cudaFuncAttributeMaxDynamicSharedMemorySize``); the fused kernel stays
#: under it
SMEM_BUDGET = 48 * 1024

#: widest factor rank the fused kernel's per-thread Gram registers hold
#: (k * k <= 4 entries for each of its 256 threads)
FUSED_MAX_K = 32


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """``bm`` / ``bk``: BSR tile dims (fixed at ingest); ``mask_block``:
    elements each program of the Triton mask kernel handles."""

    bm: int = 128
    bk: int = 128
    mask_block: int = 1024


DEFAULT_TILES = TileConfig()


def fused_working_set(bm: int, bk: int, k: int, itemsize: int = 4) -> int:
    """Shared-memory bytes one block of the fused spmm + Gram kernel holds:
    the full-rank (bk, k) U slab, rows padded to k + 1 words against bank
    conflicts.  The (bm, bk) tile streams through registers, so ``bm`` does
    not enter."""
    del bm
    return bk * (k + 1) * itemsize
