"""Tile sizes of the port's kernels and the shared-memory ring of its BSR
kernels (port of ``repro.kernels.autotune``, reduced to the audited
defaults).

The reference resolves tiles through a measured per-device ledger; the port
has no measured entries yet, so every call site uses :data:`DEFAULT_TILES`.
The ledger and the sweep come in a later slice.  The reference's VMEM
budget becomes the per-block shared-memory budget of a Hopper SM.

The BSR kernels (``csrc/bsr_spmm.cu``) keep a ring of stages in shared
memory, each one slot's whole (bm, bk) f32 tile (one bulk copy) plus that
slot's (bk, w) U slab, stored per quad of rows at ``4 * (w | 1)`` floats
apart; the ring holds as many stages as fit, at most eight.  The fused
kernel also keeps its k x k Gram partial there and holds the full-rank slab
(w = k); the plain kernel holds its column chunk (w <= 8).
:func:`fused_working_set` mirrors the kernel's arithmetic, and ``cuda-bsr``
takes the fused kernel only where two stages fit in :data:`SMEM_BUDGET`.
"""
from __future__ import annotations

import dataclasses

__all__ = ["TileConfig", "DEFAULT_TILES", "SMEM_BUDGET", "FUSED_MAX_K",
           "RING_COLS", "fused_working_set", "ring_stage_bytes"]

#: dynamic shared memory one block may opt in to on an H100
#: (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, 227 KB); the BSR kernels
#: opt in with ``cudaFuncSetAttribute``
SMEM_BUDGET = 227 * 1024

#: widest factor rank the fused kernel takes: its k x k Gram entries go one
#: per warp at a time, so a flagged slot costs k^2 / 8 warp dot products
FUSED_MAX_K = 32

#: factor columns one block of the BSR kernels computes (``kCols``); wider
#: factors add column chunks, each streaming the tiles again
RING_COLS = 8

#: bytes ahead of the ring: the stage barriers and the fix-up flag
_RING_HEADER = 256


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """``bm`` / ``bk``: BSR tile dims (fixed at ingest)."""

    bm: int = 128
    bk: int = 128


DEFAULT_TILES = TileConfig()


def _round128(x: int) -> int:
    return -(-x // 128) * 128


def ring_stage_bytes(bm: int, bk: int, w: int, itemsize: int = 4) -> int:
    """Shared-memory bytes of one stage of the BSR kernels' ring: the
    (bm, bk) tile and the (bk, w) U slab, each rounded up to 128 bytes."""
    return (_round128(bm * bk * itemsize)
            + _round128((bk // 4) * 4 * (w | 1) * itemsize))


def fused_working_set(bm: int, bk: int, k: int, itemsize: int = 4) -> int:
    """Shared-memory bytes the fused spmm + Gram kernel needs at the least:
    the header, the k x k Gram partial and a two-stage ring of (tile,
    full-rank slab) stages."""
    return (_RING_HEADER + _round128(k * k * itemsize)
            + 2 * ring_stage_bytes(bm, bk, k, itemsize))
