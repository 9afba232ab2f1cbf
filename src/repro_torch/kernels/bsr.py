"""Block-CSR (BSR) sparse format + host-side ingest (port of
``repro.kernels.bsr``).

A is stored as dense tiles at sparse block coordinates:

* ``tiles``:      (n_row_blocks, bcap, bm, bk)  — dense tiles
* ``block_cols``: (n_row_blocks, bcap) int32    — column-block index per tile

Rows of blocks are padded to a fixed per-row-block capacity ``bcap``; padded
slots hold zero tiles and block-col 0.  ``A^T @ X`` runs the same kernel on a
transposed-format copy built once at ingest; :class:`BSROperand` bundles the
two orientations.

Ingest is numpy work on the host, step for step the reference's, so the
``tiles`` / ``block_cols`` arrays are bitwise the reference's, ``bcap``
truncation included.  Unlike the reference, it never holds a float64 copy
of a whole tile volume, nor every kept tile gathered at once.  The
per-tile float64 squared norms, which only a ``bcap`` truncation reads
(to rank tiles), run a slab of row-blocks at a time by the reference's
own expression, so each is bitwise the same.  Which tiles a transpose
keeps (those of a positive norm) and which hold an entry come from the
stored entries of a scipy input (O(nnz)), else from each slab's max and
min (:func:`_slot_masks`).  Kept tiles move a slab at a time, within
:data:`SLAB_BYTES` of temporaries.  A scipy input then peaks at about
the two orientations' tile bytes above it.  The tensors move to the
device once, at the end of ingest.  numpy has no bf16: a bf16 operand is
ingested in f32 on the host and its tiles are cast on the device (round
to nearest even).  Ingest also
fixes, per orientation, what the fused spmm + Gram kernel needs to know
about Gram coverage (the reference's
``kernels/fused.py::_coverage``, which ran on the device every call): the
first-occurrence flag of every slot and the rows of U that no slot
references.  Both depend only on ``block_cols``, so the reference's
``lax.cond(jnp.all(covered))`` becomes a host-side ``None`` check with no
device sync per iteration.

Ingest also fixes the CUDA kernels' split of the slot stream
(:func:`split_plan`): the (row-block, slot) pairs, flattened in row-block
order, cut into one run per SM of the operand's card, with lengths that
differ by at most one slot.  It depends only on ``nrb``, ``bcap`` and the
SM count, so a call reads it and never syncs.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import move, resolve_device

__all__ = ["BSR", "BSROperand", "SplitPlan", "bsr_from_dense",
           "bsr_from_scipy", "bsr_dot_uv", "bsr_to_coo", "bsr_to_dense",
           "bsr_transpose", "bsr_operand", "coverage", "plan_runs",
           "replan", "split_plan"]

#: runs of the plan of an operand that lives on the CPU (the H100's SM
#: count); only the tests read it, and moving the operand to a card
#: re-plans for that card
DEFAULT_RUNS = 132

#: host bytes of one slab's temporaries at ingest: the float64 squares of
#: a slab of row-blocks' tiles (one row-block at least), or a slab of kept
#: tiles on their way to their slots; small enough to stay in the host's
#: caches, large enough that a slab's numpy calls dwarf the loop (tests
#: patch it to run many slabs)
SLAB_BYTES = 32 << 20


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the CUDA kernels split the flattened slot stream.

    * ``bounds``:  (runs + 1,) int32 — run r streams slots
      ``bounds[r] .. bounds[r + 1] - 1`` (flat index ``i * bcap + s``);
    * ``rb_runs``: (nrb, 2) int32 — the first and the last run that stream
      a slot of each row-block; a row-block whose two differ is cut, and
      its runs' partial sums are added in run order.
    """

    bounds: torch.Tensor
    rb_runs: torch.Tensor

    @property
    def runs(self) -> int:
        return self.bounds.shape[0] - 1


def split_plan(nrb: int, bcap: int, runs: int):
    """``(bounds, rb_runs)`` as numpy int32 arrays: the ``nrb * bcap``
    slots cut into ``min(runs, nrb * bcap)`` runs whose lengths differ by
    at most one, in order."""
    total = nrb * bcap
    runs = max(1, min(int(runs), total))
    bounds = np.arange(runs + 1, dtype=np.int64) * total // runs
    first_slot = np.arange(nrb, dtype=np.int64) * bcap
    rb_runs = np.stack(
        [np.searchsorted(bounds, first_slot, side="right") - 1,
         np.searchsorted(bounds, first_slot + bcap - 1, side="right") - 1],
        axis=1)
    return bounds.astype(np.int32), rb_runs.astype(np.int32)


def plan_runs(device) -> int:
    """One run per SM of a CUDA ``device``; :data:`DEFAULT_RUNS` for the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return DEFAULT_RUNS


def _make_plan(nrb: int, bcap: int, device, runs: int | None = None
               ) -> SplitPlan:
    bounds, rb_runs = split_plan(nrb, bcap, plan_runs(device) if runs is None
                                 else runs)
    return SplitPlan(torch.from_numpy(bounds).to(device),
                     torch.from_numpy(rb_runs).to(device))


@dataclasses.dataclass(frozen=True)
class BSR:
    tiles: torch.Tensor        # (nrb, bcap, bm, bk)
    block_cols: torch.Tensor   # (nrb, bcap) int32
    shape: Tuple[int, int]
    #: (nrb, bcap) int32: 1 at the first slot that references each column
    #: block, so the fused kernel adds every referenced U slab's Gram once
    gram_flags: torch.Tensor
    #: (m,) bool: rows of U in column blocks no slot references (their Gram
    #: is added separately); ``None`` when every column block is covered
    uncovered_rows: Optional[torch.Tensor]
    #: the CUDA kernels' split of the slot stream over the card's SMs
    plan: SplitPlan
    #: slots whose tile holds a nonzero entry (the rest is padding),
    #: counted on the host at ingest and kept on every device, ``meta``
    #: included
    occupied: int

    @property
    def bm(self) -> int:
        return self.tiles.shape[2]

    @property
    def bk(self) -> int:
        return self.tiles.shape[3]

    @property
    def bcap(self) -> int:
        return self.tiles.shape[1]

    @property
    def nrb(self) -> int:
        return self.tiles.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    def to(self, device, non_blocking: bool = False) -> "BSR":
        """This operand on ``device``, its split re-planned for it;
        ``non_blocking`` copies from pinned host memory without waiting
        (``device.move``)."""
        device = resolve_device(device)
        if self.device == device:
            return self

        def mv(t):
            return move(t, device, non_blocking)

        unc = None if self.uncovered_rows is None else mv(self.uncovered_rows)
        return BSR(mv(self.tiles), mv(self.block_cols), self.shape,
                   mv(self.gram_flags), unc,
                   _make_plan(self.nrb, self.bcap, device), self.occupied)

    def nnz(self) -> torch.Tensor:
        return torch.sum(self.tiles != 0)

    def sqnorm(self) -> torch.Tensor:
        return torch.sum(self.tiles.float() ** 2)


@dataclasses.dataclass(frozen=True)
class BSROperand:
    """A in BSR form plus its transposed-format copy (both built at ingest).
    ``shape`` is the logical (n, m) of A."""
    bsr: BSR
    bsr_t: BSR
    shape: Tuple[int, int]

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def m(self) -> int:
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.bsr.device

    def to(self, device, non_blocking: bool = False) -> "BSROperand":
        return BSROperand(self.bsr.to(device, non_blocking),
                          self.bsr_t.to(device, non_blocking), self.shape)

    def nnz(self) -> torch.Tensor:
        return self.bsr.nnz()

    def sqnorm(self) -> torch.Tensor:
        return self.bsr.sqnorm()


def coverage(block_cols: np.ndarray, ncb: int):
    """First-occurrence flags over the flattened (nrb, bcap) slots and the
    per-column-block covered mask (the reference's ``_coverage``, on the
    host).  A block referenced from several slots is flagged only at its
    first; padding slots reference block 0, so block 0 is always covered."""
    nrb, bcap = block_cols.shape
    size = nrb * bcap
    flat = block_cols.reshape(-1).astype(np.int64)
    pos = np.arange(size, dtype=np.int64)
    first_pos = np.full((ncb,), size, np.int64)
    np.minimum.at(first_pos, flat, pos)
    flags = (first_pos[flat] == pos).astype(np.int32).reshape(nrb, bcap)
    return flags, first_pos < size


def _occupied(tiles: torch.Tensor) -> int:
    """Slots of host ``tiles`` (nrb, bcap, bm, bk) whose tile holds a
    nonzero entry."""
    if tiles.numel() == 0:
        return 0
    lo, hi = torch.aminmax(tiles.reshape(tiles.shape[0] * tiles.shape[1],
                                         -1), dim=1)
    return int(((lo != 0) | (hi != 0)).sum())


def _make_bsr(tiles: np.ndarray, bcols: np.ndarray, shape: Tuple[int, int],
              device, dtype: Optional[torch.dtype] = None,
              occupied: Optional[int] = None) -> BSR:
    """Wrap host arrays as a device :class:`BSR`, with its coverage and its
    occupied-tile count (``occupied`` when the caller counted it at
    ingest); given ``dtype``, the tiles are cast to it on the device."""
    bk = tiles.shape[3]
    m = shape[1]
    ncb = -(-m // bk)
    flags, covered = coverage(bcols, ncb)
    unc = None
    if not covered.all():
        unc = torch.from_numpy(~covered[np.arange(m) // bk]).to(device)
    nrb, bcap = bcols.shape
    host = torch.from_numpy(np.ascontiguousarray(tiles))
    t = host.to(device)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return BSR(t, torch.from_numpy(bcols).to(device), shape,
               torch.from_numpy(flags).to(device), unc,
               _make_plan(nrb, bcap, device),
               _occupied(host) if occupied is None else occupied)


def replan(a: BSR, runs: int) -> BSR:
    """``a`` with its slot stream cut into ``runs`` runs instead of one per
    SM (tests and measurements of the split)."""
    return dataclasses.replace(a, plan=_make_plan(a.nrb, a.bcap, a.device,
                                                  runs))


def _host(a) -> np.ndarray:
    """A host numpy array of ``a``; a bf16 tensor comes back in f32 (numpy
    has no bf16; every bf16 value is exact in f32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def _is_bf16(a) -> bool:
    return isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16


def _ingest_dtypes(dtype):
    """``(host, device)`` for a requested operand dtype (numpy or torch, or
    ``None``): the numpy dtype the host ingest casts to, and the torch dtype
    the tiles are cast to on the device (bf16 only: ingested in f32)."""
    if dtype is None:
        return None, None
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.float32), torch.bfloat16
        return torch.empty((), dtype=dtype).numpy().dtype, None
    return np.dtype(dtype), None


def _slabs(total: int, item_bytes: int):
    """``(start, stop)`` ranges over ``total`` items of ``item_bytes``
    each, every range within :data:`SLAB_BYTES` (one item at least)."""
    step = max(1, SLAB_BYTES // max(int(item_bytes), 1))
    for start in range(0, total, step):
        yield start, min(total, start + step)


def _tile_sqnorms(blocks: np.ndarray) -> np.ndarray:
    """Per-tile float64 squared Frobenius norms of ``blocks`` (nrb, c, bm,
    bk), a slab of row-blocks at a time, each by the reference's expression
    ``(x.astype(np.float64) ** 2).sum(axis=(2, 3))`` on its slab: bitwise
    the whole volume's, with float64 temporaries of one slab (two at once:
    the copy and its square).  Only a ``bcap`` truncation reads their
    values (to rank tiles); everything else needs :func:`_slot_masks`."""
    nrb, c, bm, bk = blocks.shape
    out = np.empty((nrb, c), np.float64)
    for i0, i1 in _slabs(nrb, 2 * 8 * c * bm * bk):
        out[i0:i1] = (blocks[i0:i1].astype(np.float64) ** 2).sum(axis=(2, 3))
    return out


def _slot_masks(blocks: np.ndarray):
    """Two (nrb, c) masks over the tiles of ``blocks`` (nrb, c, bm, bk): the
    slots that hold a nonzero entry (:func:`_occupied`'s count, NaN
    included) and the slots whose float64 squared norm is positive (the
    reference's ``tile_sq > 0``: the tiles a transpose or a block pass
    keeps).  Each comes from a slab's max and min (no temporaries) where
    that is exact: a square of any entry but a float64 one is positive
    exactly when the entry is nonzero, and a NaN anywhere makes the norm
    NaN, which is not positive.  Float64 tiles take the norms."""
    nrb, c, bm, bk = blocks.shape
    any_nz = np.empty((nrb, c), bool)
    pos = np.empty((nrb, c), bool)
    wide = blocks.dtype.kind == "f" and blocks.dtype.itemsize > 4
    for i0, i1 in _slabs(nrb, (16 if wide else 1) * c * bm * bk):
        x = blocks[i0:i1]
        hi, lo = x.max(axis=(2, 3)), x.min(axis=(2, 3))
        any_nz[i0:i1] = (hi != 0) | (lo != 0)
        if wide:
            pos[i0:i1] = (x.astype(np.float64) ** 2).sum(axis=(2, 3)) > 0
        else:
            pos[i0:i1] = (hi > 0) | (lo < 0)
    return any_nz, pos


def _ranking(sq: Optional[np.ndarray], i: np.ndarray, j: np.ndarray):
    """The sort key of the kept items, the squared norms where a
    truncation needs them; without a truncation every item is kept and
    the key is never read for a choice."""
    return sq[i, j] if sq is not None else np.zeros(len(i), np.float64)


def _move_tiles(dst: np.ndarray, dst_at, src: np.ndarray, src_at,
                transpose: bool = False) -> None:
    """``dst[dst_at] = src[src_at]`` over (row-block, slot) index pairs,
    each tile transposed when asked, a slab of tiles at a time: the same
    bytes as numpy's one fancy assignment, without gathering every tile
    at once, and copied by torch on every core."""
    dst_t, src_t = torch.from_numpy(dst), torch.from_numpy(src)
    tile = src.itemsize * src.shape[-2] * src.shape[-1]
    for t0, t1 in _slabs(len(src_at[0]), tile):
        x = src_t[tuple(torch.from_numpy(i[t0:t1]) for i in src_at)]
        dst_t[tuple(torch.from_numpy(i[t0:t1]) for i in dst_at)] = (
            x.transpose(1, 2) if transpose else x)


def _from_dense_np(a: np.ndarray, bm: int, bk: int, bcap: int | None):
    """The reference's dense ingest: ``(tiles, bcols, shape, any_nz,
    pos)``, the last two :func:`_slot_masks`' of the tiles (here every
    kept tile has a positive norm: both are the filled slots)."""
    n, m = a.shape
    ap = np.pad(a, ((0, (-n) % bm), (0, (-m) % bk)))
    nrb, ncb = ap.shape[0] // bm, ap.shape[1] // bk
    blocked = ap.reshape(nrb, bm, ncb, bk).transpose(0, 2, 1, 3)
    # the norms rank blocks only where bcap may truncate
    block_sq = _tile_sqnorms(blocked) if bcap is not None else None
    occ = block_sq > 0 if block_sq is not None else _slot_masks(blocked)[1]
    occ_i, occ_j = np.nonzero(occ)
    cap = bcap
    if cap is None:
        cap = max(int(np.bincount(occ_i, minlength=nrb).max(initial=1)), 1)
    keep, slots, counts = _keep_top_per_group(
        occ_i, _ranking(block_sq, occ_i, occ_j), nrb, cap)
    if (counts > cap).any():
        warnings.warn(
            f"bsr_from_dense: {int((counts > cap).sum())} row-blocks exceed "
            f"bcap={cap}; keeping the {cap} largest-Frobenius-norm "
            "blocks per row-block",
            stacklevel=3,
        )
    tiles = np.zeros((nrb, cap, bm, bk), dtype=a.dtype)
    bcols = np.zeros((nrb, cap), dtype=np.int32)
    i_k, j_k, s_k = occ_i[keep], occ_j[keep], slots[keep]
    _move_tiles(tiles, (i_k, s_k), blocked, (i_k, j_k))
    bcols[i_k, s_k] = j_k
    filled = np.zeros((nrb, cap), bool)
    filled[i_k, s_k] = True
    return tiles, bcols, (n, m), filled, filled


def bsr_from_dense(a, bm: int = 128, bk: int = 128, bcap: int | None = None,
                   device="cpu") -> BSR:
    """Host-side conversion of a dense matrix (numpy or tensor).  An explicit
    ``bcap`` below a row-block's occupancy keeps its ``bcap``
    largest-Frobenius-norm blocks and warns."""
    return _make_bsr(*_from_dense_np(_host(a), bm, bk, bcap)[:3], device,
                     torch.bfloat16 if _is_bf16(a) else None)


def _keep_top_per_group(group_ids, sqnorms, ngroups: int, cap: int):
    """Rank items within each group by descending ``sqnorms``, keep the
    ``cap`` largest per group, and slot the survivors in ascending
    original-index order.  Returns ``(keep, slots, counts)``."""
    group_ids = group_ids.astype(np.int64)
    counts = np.bincount(group_ids, minlength=ngroups)
    by_norm = np.lexsort((-sqnorms, group_ids))
    starts = np.cumsum(counts) - counts
    norm_rank = np.empty(len(group_ids), dtype=np.int64)
    norm_rank[by_norm] = np.arange(len(group_ids)) - starts[group_ids[by_norm]]
    keep = norm_rank < cap
    pos = np.flatnonzero(keep)
    gk = group_ids[pos]
    order = np.argsort(gk, kind="stable")
    kept_counts = np.bincount(gk, minlength=ngroups)
    kept_starts = np.cumsum(kept_counts) - kept_counts
    slots = np.zeros(len(group_ids), dtype=np.int64)
    slots[pos[order]] = np.arange(len(gk)) - kept_starts[gk[order]]
    return keep, slots, counts


def _from_scipy_np(sp_matrix, bm: int, bk: int, bcap: int | None, dtype):
    """The reference's scipy ingest: ``(tiles, bcols, shape, any_nz,
    pos)``, the last two :func:`_slot_masks`' of the tiles, read off the
    stored entries (a kept block's tile holds exactly its entries)."""
    coo = sp_matrix.tocoo()
    coo.sum_duplicates()
    coo.eliminate_zeros()
    n, m = coo.shape
    data = coo.data if dtype is None else coo.data.astype(dtype)
    nrb, ncb = -(-n // bm), -(-m // bk)
    bi = coo.row // bm
    bj = coo.col // bk
    block_id = bi.astype(np.int64) * ncb + bj
    uniq, inv = np.unique(block_id, return_inverse=True)
    ubi = (uniq // ncb).astype(np.int64)
    ubj = (uniq % ncb).astype(np.int32)
    sqnorms = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(sqnorms, inv, data.astype(np.float64) ** 2)
    cap = bcap
    if cap is None:
        counts = np.bincount(ubi, minlength=nrb)
        cap = max(int(counts.max(initial=1)), 1)
    keep_block, slot, counts = _keep_top_per_group(ubi, sqnorms, nrb, cap)
    if (counts > cap).any():
        warnings.warn(
            f"bsr_from_scipy: {int((counts > cap).sum())} row-blocks exceed "
            f"bcap={cap}; keeping the {cap} largest-Frobenius-norm "
            "blocks per row-block",
            stacklevel=3,
        )
    tiles = np.zeros((nrb, cap, bm, bk), dtype=data.dtype)
    bcols = np.zeros((nrb, cap), dtype=np.int32)
    kept_uniq = keep_block[inv]
    e_bi = bi[kept_uniq]
    e_slot = slot[inv[kept_uniq]]
    e_r = (coo.row[kept_uniq] % bm).astype(np.int64)
    e_c = (coo.col[kept_uniq] % bk).astype(np.int64)
    e_val = data[kept_uniq]
    np.add.at(tiles, (e_bi, e_slot, e_r, e_c), e_val)
    bcols[ubi[keep_block], slot[keep_block]] = ubj[keep_block]
    # per kept block: an entry that is nonzero (NaN too), one whose float64
    # square is positive, one that is NaN
    e_blk = inv[kept_uniq]
    e_sq = e_val.astype(np.float64) ** 2

    def some(flags):
        return np.bincount(e_blk, weights=flags, minlength=len(uniq)) > 0

    blk_any = some(e_val != 0)
    blk_pos = some(e_sq > 0) & ~some(np.isnan(e_sq))
    at = (ubi[keep_block], slot[keep_block])
    any_nz = np.zeros((nrb, cap), bool)
    pos = np.zeros((nrb, cap), bool)
    any_nz[at] = blk_any[keep_block]
    pos[at] = blk_pos[keep_block]
    return tiles, bcols, (n, m), any_nz, pos


def bsr_from_scipy(sp_matrix, bm: int = 128, bk: int = 128,
                   bcap: int | None = None, dtype=None, device="cpu") -> BSR:
    """Direct ``scipy.sparse -> BSR`` ingest, never materializing the dense
    matrix; row-blocks over ``bcap`` keep their largest-norm blocks and
    warn."""
    return _make_bsr(*_from_scipy_np(sp_matrix, bm, bk, bcap, dtype)[:3],
                     device)


def bsr_dot_uv(a: BSR, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``<A, U V^T>`` contracted tile-wise in f32: the cross term of the
    relative error, never building the dense (n, m) product."""
    nrb, bcap, bm, bk = a.tiles.shape
    n, m = a.shape
    k = u.shape[1]
    uf = u.float()
    vf = v.float()
    u_blk = torch.nn.functional.pad(uf, (0, 0, 0, nrb * bm - n)).reshape(
        nrb, bm, k)
    ncb = -(-m // bk)
    v_blk = torch.nn.functional.pad(vf, (0, 0, 0, ncb * bk - m)).reshape(
        ncb, bk, k)
    v_blk = v_blk[a.block_cols.long()]  # (nrb, bcap, bk, k); padding -> 0
    return torch.einsum("isrc,ird,iscd->", a.tiles.float(), u_blk, v_blk)


def bsr_to_coo(a: BSR):
    """Host-side element COO ``(rows, cols, vals)`` of the stored
    nonzeros."""
    tiles = _host(a.tiles)
    bcols = a.block_cols.cpu().numpy()
    nz_i, nz_s, nz_r, nz_c = np.nonzero(tiles)
    rows = nz_i * a.bm + nz_r
    cols = bcols[nz_i, nz_s].astype(np.int64) * a.bk + nz_c
    return rows.astype(np.int64), cols, tiles[nz_i, nz_s, nz_r, nz_c]


def bsr_to_dense(a: BSR) -> torch.Tensor:
    """The explicit densifier (oracle for tests)."""
    nrb, bcap, bm, bk = a.tiles.shape
    ncb = -(-a.shape[1] // bk)
    out = torch.zeros((nrb, ncb, bm, bk), dtype=a.tiles.dtype,
                      device=a.device)
    rows = torch.arange(nrb, device=a.device)[:, None].expand(nrb, bcap)
    out.index_put_((rows, a.block_cols.long()), a.tiles, accumulate=True)
    dense = out.permute(0, 2, 1, 3).reshape(nrb * bm, ncb * bk)
    return dense[: a.shape[0], : a.shape[1]]


def _transpose_np(tiles: np.ndarray, bcols: np.ndarray,
                  shape: Tuple[int, int], bcap: int | None,
                  pos: Optional[np.ndarray] = None):
    """The transposed-format host arrays of ``(tiles, bcols, shape)``;
    ``pos`` is the tiles' positive-norm mask (:func:`_slot_masks`) where
    the caller has it.  Only a ``bcap`` truncation needs the norms
    themselves."""
    nrb, _, bm, bk = tiles.shape
    n, m = shape
    ncb = -(-m // bk)
    tile_sq = _tile_sqnorms(tiles) if bcap is not None else None
    if tile_sq is not None:
        pos = tile_sq > 0
    elif pos is None:
        pos = _slot_masks(tiles)[1]
    occ_i, occ_s = np.nonzero(pos)
    occ_j = bcols[occ_i, occ_s].astype(np.int64)
    if bcap is None:
        bcap = max(int(np.bincount(occ_j, minlength=ncb).max(initial=1)), 1)
    keep, slots, counts = _keep_top_per_group(
        occ_j, _ranking(tile_sq, occ_i, occ_s), ncb, bcap)
    if (counts > bcap).any():
        warnings.warn(
            f"bsr_transpose: {int((counts > bcap).sum())} row-blocks of the "
            f"transpose exceed bcap={bcap}; keeping the {bcap} "
            "largest-Frobenius-norm tiles per row-block",
            stacklevel=3,
        )
    tiles_t = np.zeros((ncb, bcap, bk, bm), dtype=tiles.dtype)
    bcols_t = np.zeros((ncb, bcap), dtype=np.int32)
    i_o, s_o, j_o, d_o = occ_i[keep], occ_s[keep], occ_j[keep], slots[keep]
    _move_tiles(tiles_t, (j_o, d_o), tiles, (i_o, s_o), transpose=True)
    bcols_t[j_o, d_o] = i_o
    return tiles_t, bcols_t, (m, n)


def bsr_transpose(a: BSR, bcap: int | None = None) -> BSR:
    """Build the transposed-format copy tile-wise on the host: tile (i, s)
    with block-col j becomes ``tiles[i, s].T`` at row-block j with
    block-col i.  The result lands on ``a``'s device."""
    return _make_bsr(*_transpose_np(_host(a.tiles),
                                    a.block_cols.cpu().numpy(), a.shape,
                                    bcap), a.device, a.tiles.dtype)


def bsr_operand(a, bm: int = 128, bk: int = 128, bcap: int | None = None,
                dtype=None, device="cpu") -> BSROperand:
    """Build the two-orientation :class:`BSROperand` from a dense array, a
    scipy sparse matrix, or an existing :class:`BSR`.  Both orientations
    are built on the host and moved to ``device`` once.  ``dtype`` (numpy or
    torch) is the tiles' dtype; ``torch.bfloat16`` is ingested in f32 and
    cast on the device, as is a bf16 tensor or :class:`BSR` given with no
    ``dtype``."""
    if isinstance(a, BSROperand):
        return a.to(device)
    host_dtype, dev_dtype = _ingest_dtypes(dtype)
    if dtype is None and _is_bf16(a.tiles if isinstance(a, BSR) else a):
        dev_dtype = torch.bfloat16
    if isinstance(a, BSR):
        tiles = _host(a.tiles)
        host = (tiles, a.block_cols.cpu().numpy(), a.shape,
                *_slot_masks(tiles))
    elif hasattr(a, "tocoo"):  # scipy sparse, without a hard scipy import
        host = _from_scipy_np(a, bm, bk, bcap, host_dtype)
    else:
        a = _host(a)
        if host_dtype is not None:
            a = a.astype(host_dtype)
        host = _from_dense_np(a, bm, bk, bcap)
    tiles, bcols, shape, any_nz, pos = host
    # the transpose keeps every tile of a positive norm (no bcap), and
    # each holds an entry: its occupied count is theirs
    host_t = _transpose_np(tiles, bcols, shape, None, pos)
    return BSROperand(
        _make_bsr(tiles, bcols, shape, device, dev_dtype,
                  int(np.count_nonzero(any_nz))),
        _make_bsr(*host_t, device, dev_dtype, int(np.count_nonzero(pos))),
        shape)
