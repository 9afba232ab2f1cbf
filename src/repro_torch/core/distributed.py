"""Shard ingest for the mesh engines (port of ``repro.core.distributed``).

Layout (the reference's DESIGN.md §4): A (n x m) is sharded in 2-D, its
rows over the mesh's row axes (R blocks: ``"data"``, or ``("pod",
"data")`` on a grid of several pods, at the combined row index) and its
columns over ``"model"`` (C blocks); U (n x k) is row-sharded over the row
axes, V (m x k) over ``"model"``.  Each block is held in both orientations, A_ij
and A_ij^T, so both ALS half-steps are forward products (scatter-free).

The reference builds the whole (R, C)-stacked grid in one process and lets
``shard_map`` hand each device its slice.  Here a process is one rank and
holds only its own block: :class:`DistCSR` and :class:`DistBSR` are *this
rank's* (i, j) block, with local ids, and the ingest carves it from the
element COO of the input (work proportional to the stored entries; sparse
input is never made dense).  Two block formats:

* :class:`DistCSR` — padded CSR (``SpCSR``) in both orientations, the
  ``torch-csr`` shards;
* :class:`DistBSR` — a two-orientation :class:`BSROperand` of the block's
  128 x 128 tiles, the ``cuda-bsr`` shards; each block is planned on its
  own (its split of the slot stream over the card's SMs), and a row-block
  with more occupied tiles than ``bcap`` keeps its ``bcap``
  largest-Frobenius-norm tiles, with a warning, as the reference's
  ``distribute_bsr`` does.

:func:`shard_grid` packs all R x C blocks in one process, for tests that
hold the blocks against the reference's stacked arrays.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.bsr import (
    BSR, BSROperand, _keep_top_per_group, _make_bsr, bsr_to_coo,
)
from repro_torch.sparse.csr import SpCSR

__all__ = ["DistCSR", "DistBSR", "distribute_csr",
           "distribute_csr_from_padded", "distribute_bsr", "shard_grid"]


def _block_of(grid: Tuple[int, int],
              shape: Tuple[int, int]) -> Tuple[int, int]:
    (r, c), (n, m) = grid, shape
    return n // r, m // c


@dataclasses.dataclass(frozen=True)
class DistCSR:
    """One rank's (i, j) block of A in padded CSR, both orientations.

    ``fwd`` is A_ij (n_loc x m_loc, local column ids), ``tsp`` A_ij^T
    (m_loc x n_loc).  ``shape`` is the global (n, m), ``grid`` (R, C) and
    ``index`` this block's (i, j)."""

    fwd: SpCSR
    tsp: SpCSR
    shape: Tuple[int, int]
    grid: Tuple[int, int]
    index: Tuple[int, int]

    def to(self, device, non_blocking: bool = False) -> "DistCSR":
        return dataclasses.replace(
            self, fwd=self.fwd.to(device, non_blocking),
            tsp=self.tsp.to(device, non_blocking))


@dataclasses.dataclass(frozen=True)
class DistBSR:
    """One rank's (i, j) block of A as BSR tiles, both orientations:
    ``op.bsr`` tiles A_ij, ``op.bsr_t`` A_ij^T, each with its own split
    plan.  ``shape`` is the global (n, m), ``grid`` (R, C), ``index``
    (i, j)."""

    op: BSROperand
    shape: Tuple[int, int]
    grid: Tuple[int, int]
    index: Tuple[int, int]

    def to(self, device, non_blocking: bool = False) -> "DistBSR":
        return dataclasses.replace(self, op=self.op.to(device, non_blocking))


# ---------------------------------------------------------------------------
# Element COO of any input
# ---------------------------------------------------------------------------

def _coo_of(a, dtype=None):
    """Host element COO ``(rows, cols, vals, (n, m))`` of any ingest input —
    scipy sparse, ``SpCSR``, ``BSR`` / ``BSROperand``, or a dense array or
    tensor.  Work and temporaries are proportional to the stored entries
    for every sparse form; only a dense input touches n * m."""
    if isinstance(a, BSROperand):
        rows, cols, vals = bsr_to_coo(a.bsr)
        shape = a.shape
    elif isinstance(a, BSR):
        rows, cols, vals = bsr_to_coo(a)
        shape = a.shape
    elif isinstance(a, SpCSR):
        values = a.values.detach().cpu().numpy()
        mask = values != 0
        rows = np.broadcast_to(
            np.arange(a.shape[0])[:, None], values.shape)[mask]
        cols = a.cols.detach().cpu().numpy()[mask]
        vals = values[mask]
        shape = a.shape
    elif hasattr(a, "tocoo"):  # scipy sparse, without a hard import
        coo = a.tocoo()
        coo.sum_duplicates()
        coo.eliminate_zeros()
        rows, cols, vals = coo.row, coo.col, coo.data
        shape = coo.shape
    else:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        rows, cols = np.nonzero(a)
        vals = a[rows, cols]
        shape = a.shape
    if dtype is not None:
        vals = vals.astype(dtype)
    return (np.asarray(rows, np.int64), np.asarray(cols, np.int64),
            np.asarray(vals), tuple(int(s) for s in shape))


def _check_grid(shape, grid):
    (n, m), (r, c) = shape, grid
    if n % r or m % c:
        raise ValueError(
            f"matrix shape {(n, m)} must be divisible by the shard grid "
            f"{(r, c)}")


def _select_block(rows, cols, vals, shape, grid, index):
    """The entries of block (i, j), with local ids."""
    n_loc, m_loc = _block_of(grid, shape)
    i, j = index
    keep = ((rows // n_loc) == i) & ((cols // m_loc) == j)
    return rows[keep] - i * n_loc, cols[keep] - j * m_loc, vals[keep]


# ---------------------------------------------------------------------------
# Padded-CSR blocks
# ---------------------------------------------------------------------------

def _pack_csr(line, stored, vals, n_lines: int):
    """Padded CSR of one block: entries grouped by ``line`` with one stable
    sort (their order within a line kept), the slot of an entry its index
    in its run; capacity the longest run (at least 1)."""
    order = np.argsort(line, kind="stable")
    ls = line[order]
    if len(ls):
        new_run = np.concatenate([[True], ls[1:] != ls[:-1]])
        run_starts = np.flatnonzero(new_run)
        run_id = np.cumsum(new_run) - 1
        slot = np.arange(len(ls)) - run_starts[run_id]
        cap = max(int(np.diff(np.append(run_starts, len(ls))).max()), 1)
    else:
        slot = np.zeros(0, dtype=np.int64)
        cap = 1
    values = np.zeros((n_lines, cap), np.float32)
    cols = np.zeros((n_lines, cap), np.int32)
    values[ls, slot] = vals[order]
    cols[ls, slot] = stored[order]
    return values, cols


def _csr_block(rows, cols, vals, shape, grid, index, device) -> DistCSR:
    _check_grid(shape, grid)
    n_loc, m_loc = _block_of(grid, shape)
    lr, lc, lv = _select_block(rows, cols, vals.astype(np.float32), shape,
                               grid, index)
    fv, fc = _pack_csr(lr, lc, lv, n_loc)
    tv, tc = _pack_csr(lc, lr, lv, m_loc)
    dev = resolve_device(device)
    as_t = lambda x: torch.from_numpy(x).to(dev)
    return DistCSR(SpCSR(as_t(fv), as_t(fc), (n_loc, m_loc)),
                   SpCSR(as_t(tv), as_t(tc), (m_loc, n_loc)),
                   tuple(shape), tuple(grid), tuple(index))


def distribute_csr(a_dense, grid: Tuple[int, int], index: Tuple[int, int],
                   device=None) -> DistCSR:
    """Block ``index`` of a dense (n, m) matrix (numpy or tensor) on the
    ``grid``, as padded CSR in both orientations on ``device``."""
    rows, cols, vals, shape = _coo_of(a_dense)
    return _csr_block(rows, cols, vals, shape, grid, index, device)


def distribute_csr_from_padded(a: SpCSR, grid: Tuple[int, int],
                               index: Tuple[int, int],
                               device=None) -> DistCSR:
    """Block ``index`` of a padded-CSR ``SpCSR``, straight from its stored
    entries (never the dense (n, m) matrix)."""
    rows, cols, vals, shape = _coo_of(a)
    return _csr_block(rows, cols, vals, shape, grid, index, device)


# ---------------------------------------------------------------------------
# BSR tile blocks
# ---------------------------------------------------------------------------

def _pack_bsr(line_r, line_c, vals, loc_r: int, loc_c: int, tile_r: int,
              tile_c: int, bcap: Optional[int], orient: str):
    """One block's BSR tiles from its local COO (the reference's
    ``_pack_bsr_shards`` for one shard): a row-block with more occupied
    tiles than ``bcap`` keeps its ``bcap`` largest-Frobenius-norm tiles,
    slotted in ascending block-column order, and warns."""
    nrb = -(-loc_r // tile_r)
    ncb = -(-loc_c // tile_c)
    bi = line_r // tile_r
    bj = line_c // tile_c
    tile_id = bi * ncb + bj
    uniq, inv = np.unique(tile_id, return_inverse=True)
    sqnorms = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(sqnorms, inv, vals.astype(np.float64) ** 2)
    row_group = uniq // ncb
    cap = bcap
    if cap is None:
        counts = np.bincount(row_group, minlength=nrb)
        cap = max(int(counts.max(initial=1)), 1)
    keep, slot, counts = _keep_top_per_group(row_group, sqnorms, nrb, cap)
    if (counts > cap).any():
        warnings.warn(
            f"distribute_bsr: {int((counts > cap).sum())} {orient}row-blocks "
            f"exceed bcap={cap}; keeping the {cap} largest-Frobenius-norm "
            "tiles per row-block",
            stacklevel=4,
        )
    tiles = np.zeros((nrb, cap, tile_r, tile_c), dtype=vals.dtype)
    bcols = np.zeros((nrb, cap), dtype=np.int32)
    kept_e = keep[inv]
    np.add.at(tiles, (bi[kept_e], slot[inv[kept_e]], line_r[kept_e] % tile_r,
                      line_c[kept_e] % tile_c), vals[kept_e])
    u = uniq[keep]
    bcols[u // ncb, slot[keep]] = (u % ncb).astype(np.int32)
    return tiles, bcols


def _bsr_block(rows, cols, vals, shape, grid, index, *, bm, bk, bcap,
               bcap_t, device) -> DistBSR:
    _check_grid(shape, grid)
    n_loc, m_loc = _block_of(grid, shape)
    if vals.dtype.kind != "f":
        vals = vals.astype(np.float32)
    lr, lc, lv = _select_block(rows, cols, vals, shape, grid, index)
    dev = resolve_device(device)
    tiles, bcols = _pack_bsr(lr, lc, lv, n_loc, m_loc, bm, bk, bcap, "")
    tiles_t, bcols_t = _pack_bsr(lc, lr, lv, m_loc, n_loc, bk, bm, bcap_t,
                                 "transposed ")
    op = BSROperand(_make_bsr(tiles, bcols, (n_loc, m_loc), dev),
                    _make_bsr(tiles_t, bcols_t, (m_loc, n_loc), dev),
                    (n_loc, m_loc))
    return DistBSR(op, tuple(shape), tuple(grid), tuple(index))


def distribute_bsr(a, grid: Tuple[int, int], index: Tuple[int, int], *,
                   bm: int = 128, bk: int = 128, bcap: Optional[int] = None,
                   bcap_t: Optional[int] = None, dtype=None,
                   device=None) -> DistBSR:
    """Block ``index`` of any input (scipy sparse, ``SpCSR``, ``BSR`` /
    ``BSROperand``, dense) on the ``grid``, as BSR tiles in both
    orientations on ``device``, each with its own split plan.  ``bcap`` /
    ``bcap_t`` cap the tiles a row-block keeps (``None``: the block's
    largest occupancy, no truncation).  The shape must divide by the
    grid."""
    rows, cols, vals, shape = _coo_of(a, dtype=dtype)
    return _bsr_block(rows, cols, vals, shape, grid, index, bm=bm, bk=bk,
                      bcap=bcap, bcap_t=bcap_t, device=device)


def shard_grid(a, grid: Tuple[int, int], fmt: str = "bsr", device="cpu",
               **kw):
    """Every block of the grid, packed in this process: ``[[block (i, j)
    for j] for i]`` (``fmt`` ``"bsr"`` or ``"csr"``).  The input's COO is
    taken once."""
    rows, cols, vals, shape = _coo_of(a, dtype=kw.pop("dtype", None))
    r, c = grid
    if fmt == "bsr":
        kw = dict(dict(bm=128, bk=128, bcap=None, bcap_t=None), **kw)
        return [[_bsr_block(rows, cols, vals, shape, grid, (i, j),
                            device=device, **kw) for j in range(c)]
                for i in range(r)]
    if fmt == "csr":
        return [[_csr_block(rows, cols, vals, shape, grid, (i, j), device)
                 for j in range(c)] for i in range(r)]
    raise ValueError(f"fmt must be 'bsr' or 'csr', got {fmt!r}")
