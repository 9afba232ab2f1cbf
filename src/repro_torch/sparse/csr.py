"""Padded-CSR static-capacity sparse matrices (port of ``repro.sparse.csr``).

Each row keeps a fixed capacity ``cap`` of (value, col) slots:

* ``values``: (n, cap) float  — padded slots hold 0.0
* ``cols``:   (n, cap) int32  — padded slots hold 0 (safe: value is 0)

Packing and column carving (``from_dense``, ``ColumnSlicer``,
``column_block``) are host-side numpy work, identical to the reference's,
so the ``values`` / ``cols`` arrays are bitwise the reference's; the tensors
move to ``device`` once, at the end.  The products gather and scatter on
the operand's device; ``spmm_chunked`` / ``spmm_t_chunked`` accumulate over
the capacity axis in slices, so the peak temporary is (rows, chunk, k)
rather than (rows, cap, k).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import move

__all__ = ["SpCSR", "from_coo", "from_dense", "from_scipy", "to_scipy",
           "to_dense", "spmm", "spmm_t", "spmm_chunked", "spmm_t_chunked",
           "ColumnSlicer", "column_block"]


@dataclasses.dataclass(frozen=True)
class SpCSR:
    values: torch.Tensor  # (n, cap)
    cols: torch.Tensor    # (n, cap) int32
    shape: Tuple[int, int]  # (n, m)

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def m(self) -> int:
        return self.shape[1]

    @property
    def cap(self) -> int:
        return self.values.shape[1]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device, non_blocking: bool = False) -> "SpCSR":
        """This matrix on ``device``; ``non_blocking`` copies from pinned
        host memory without waiting (``device.move``)."""
        return SpCSR(move(self.values, device, non_blocking),
                     move(self.cols, device, non_blocking), self.shape)

    def nnz(self) -> torch.Tensor:
        return torch.sum(self.values != 0)

    def sqnorm(self) -> torch.Tensor:
        return torch.sum(self.values.float() ** 2)


def _host(x) -> np.ndarray:
    """A numpy view (CPU tensors, numpy arrays) or host copy of ``x``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def from_dense(a, cap: int | None = None, device="cpu") -> SpCSR:
    """Convert a dense (n, m) matrix, keeping at most ``cap`` largest-
    magnitude entries per row (all of them by default).  Slots are in
    descending magnitude, ties by column, as the reference's ``top_k``
    orders them; padded slots hold value 0 and column 0."""
    a = _host(a)
    if not np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    n, m = a.shape
    if cap is None:
        cap = max(int((a != 0).sum(axis=1).max(initial=0)), 1)
    width = min(cap, m)
    order = np.argsort(-np.abs(a), axis=1, kind="stable")[:, :width]
    signed = np.take_along_axis(a, order, axis=1)
    keep = signed != 0
    values = np.zeros((n, cap), dtype=a.dtype)
    colidx = np.zeros((n, cap), dtype=np.int32)
    values[:, :width] = np.where(keep, signed, 0)
    colidx[:, :width] = np.where(keep, order, 0)
    return SpCSR(torch.from_numpy(values).to(device),
                 torch.from_numpy(colidx).to(device), (n, m))


def _pack_rows_topcap(row_ids, col_ids, vals, n: int, m: int, cap: int | None,
                      caller: str, device="cpu") -> SpCSR:
    """Vectorized host packing of element COO into (n, cap) padded rows.

    Rows with more than ``cap`` stored entries keep their ``cap``
    largest-magnitude entries and a warning reports the truncated-row count
    (the reference's policy, step for step)."""
    row_ids = np.asarray(row_ids)
    col_ids = np.asarray(col_ids)
    vals = np.asarray(vals)
    counts = np.bincount(row_ids, minlength=n)
    if cap is None:
        cap = max(int(counts.max(initial=1)), 1)
    order = np.lexsort((-np.abs(vals.astype(np.float64)), row_ids))
    starts = np.cumsum(counts) - counts
    slots = np.arange(len(row_ids)) - starts[row_ids[order]]
    keep = slots < cap
    truncated = int(np.sum(counts > cap))
    if truncated:
        warnings.warn(
            f"{caller}: {truncated} rows have more than cap={cap} stored "
            "nonzeros; keeping the cap largest-magnitude entries per row",
            stacklevel=3,
        )
    values = np.zeros((n, cap), dtype=vals.dtype)
    colidx = np.zeros((n, cap), dtype=np.int32)
    ro, so = row_ids[order][keep], slots[keep]
    values[ro, so] = vals[order][keep]
    colidx[ro, so] = col_ids[order][keep]
    return SpCSR(torch.from_numpy(values).to(device),
                 torch.from_numpy(colidx).to(device), (n, m))


def from_coo(rows, cols, vals, shape: Tuple[int, int], cap: int | None = None,
             device="cpu") -> SpCSR:
    """Build from host COO arrays (numpy); rows with more than ``cap``
    entries keep the ``cap`` largest-magnitude ones, with a warning."""
    n, m = shape
    return _pack_rows_topcap(rows, cols, vals, n, m, cap, "from_coo", device)


def from_scipy(sp_matrix, cap: int | None = None, device="cpu") -> SpCSR:
    """Build from any scipy.sparse matrix; explicit zeros are dropped and
    values keep the input dtype."""
    import scipy.sparse as sps

    csr = sps.csr_matrix(sp_matrix)
    csr.sum_duplicates()
    csr.eliminate_zeros()
    n, m = csr.shape
    counts = np.diff(csr.indptr)
    row_ids = np.repeat(np.arange(n), counts)
    return _pack_rows_topcap(row_ids, csr.indices, csr.data, n, m, cap,
                             "from_scipy", device)


def to_scipy(a: SpCSR):
    """Round-trip back to ``scipy.sparse.csr_matrix`` (duplicate slots are
    summed)."""
    import scipy.sparse as sps

    values = a.values.cpu().numpy()
    cols = a.cols.cpu().numpy()
    mask = values != 0
    rows = np.broadcast_to(np.arange(a.n)[:, None], cols.shape)
    coo = sps.coo_matrix(
        (values[mask], (rows[mask], cols[mask])), shape=a.shape)
    return coo.tocsr()


def to_dense(a: SpCSR) -> torch.Tensor:
    """The explicit densifier (the dense backend's ingest)."""
    out = torch.zeros(a.shape, dtype=a.values.dtype, device=a.device)  # repro: allow[no-densify] body of the explicit densifier itself; callers opt in by name
    rows = torch.arange(a.n, device=a.device)[:, None].expand(a.cols.shape)
    return out.index_put_((rows, a.cols.long()), a.values, accumulate=True)


def spmm(a: SpCSR, u: torch.Tensor) -> torch.Tensor:
    """A @ U for dense U (m, k) -> (n, k) by gather + contraction."""
    gathered = u[a.cols.long()]                      # (n, cap, k)
    return torch.einsum("rc,rck->rk", a.values, gathered)


def spmm_t(a: SpCSR, u: torch.Tensor) -> torch.Tensor:
    """A.T @ U for dense U (n, k) -> (m, k) by scatter-add."""
    k = u.shape[1]
    contrib = a.values[:, :, None] * u[:, None, :]   # (n, cap, k)
    out = torch.zeros((a.m, k), dtype=u.dtype, device=u.device)
    return out.index_add_(0, a.cols.reshape(-1).long(),
                          contrib.reshape(-1, k))


def _cap_chunking(cap: int, chunk: int):
    """Chunking of the capacity axis: (full-chunk count, chunk width,
    remainder width); the remainder is one tail slice, so the peak
    temporary stays ~(rows, chunk, k) for any cap."""
    cw = max(min(int(chunk), cap), 1)
    return cap // cw, cw, cap % cw


def _cap_slices(cap: int, chunk: int):
    """The ``(lo, hi)`` capacity-axis slices of :func:`_cap_chunking`."""
    n_full, cw, rem = _cap_chunking(cap, chunk)
    bounds = [(i * cw, (i + 1) * cw) for i in range(n_full)]
    return bounds + ([(n_full * cw, cap)] if rem else [])


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least f32: f64 operands keep their precision."""
    return torch.promote_types(dtype, torch.float32)


def spmm_chunked(a: SpCSR, u: torch.Tensor, chunk: int = 64,
                 compute_dtype=None) -> torch.Tensor:
    """A @ U accumulated over the capacity axis in ``chunk``-wide slices.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) casts the values and the
    gathered slab before the product, halving the gather traffic; the
    products of two bf16 numbers are exact in f32 and accumulate in f32.
    Matches :func:`spmm` up to f32 summation order."""
    rows, cap = a.values.shape
    k = u.shape[1]
    cd = u.dtype if compute_dtype is None else compute_dtype
    acc = _acc_dtype(u.dtype)
    vc = a.values.to(cd)
    xc = u.to(cd)
    cols = a.cols.long()
    out = torch.zeros((rows, k), dtype=acc, device=u.device)
    for lo, hi in _cap_slices(cap, chunk):
        out += torch.einsum("rc,rck->rk", vc[:, lo:hi].to(acc),
                            xc[cols[:, lo:hi]].to(acc))
    return out.to(u.dtype)


def spmm_t_chunked(a: SpCSR, u: torch.Tensor, chunk: int = 64,
                   compute_dtype=None) -> torch.Tensor:
    """A.T @ U scatter-added over the capacity axis in ``chunk``-wide
    slices: the transpose of :func:`spmm_chunked`, without the (n, cap, k)
    contribution temporary of :func:`spmm_t`.  With ``compute_dtype`` the
    products are formed in it and scatter-added in f32."""
    rows, cap = a.values.shape
    k = u.shape[1]
    cd = u.dtype if compute_dtype is None else compute_dtype
    acc = _acc_dtype(u.dtype)
    vc = a.values.to(cd)
    uc = u.to(cd)
    out = torch.zeros((a.m, k), dtype=acc, device=u.device)
    for lo, hi in _cap_slices(cap, chunk):
        contrib = (vc[:, lo:hi, None] * uc[:, None, :]).to(acc)
        out.index_add_(0, a.cols[:, lo:hi].reshape(-1).long(),
                       contrib.reshape(-1, k))
    return out.to(u.dtype)


class ColumnSlicer:
    """Reusable column-sorted index over a padded-CSR corpus, for carving
    many column chunks of it: one O(nnz log nnz) stable argsort up front,
    then each :meth:`block` is a binary search plus O(chunk nnz) work.
    Chunks are bitwise :func:`column_block`'s and the reference's (the
    slice restores the corpus's row-major element order before packing).
    Host numpy work: chunks come back on the CPU."""

    def __init__(self, a: SpCSR):
        values = _host(a.values)
        cols = _host(a.cols)
        mask = values != 0
        self._rows = np.broadcast_to(
            np.arange(a.n)[:, None], cols.shape)[mask]
        self._cols = cols[mask]
        self._vals = values[mask]
        self._perm = np.argsort(self._cols, kind="stable")
        self._cols_sorted = self._cols[self._perm]
        self._shape = a.shape

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    def _range(self, lo: int, hi: int) -> np.ndarray:
        """Row-major element indices of the columns in ``[lo, hi)``."""
        if not 0 <= lo < hi <= self._shape[1]:
            raise ValueError(
                f"bad column range [{lo}, {hi}) for m={self._shape[1]}")
        i0 = np.searchsorted(self._cols_sorted, lo, side="left")
        i1 = np.searchsorted(self._cols_sorted, hi, side="left")
        return np.sort(self._perm[i0:i1])

    def block(self, lo: int, hi: int, cap: int | None = None) -> SpCSR:
        """``a[:, lo:hi]`` with rebased column ids, on the CPU."""
        idx = self._range(lo, hi)
        return from_coo(self._rows[idx], self._cols[idx] - lo,
                        self._vals[idx], (self._shape[0], hi - lo), cap=cap)

    def max_row_nnz(self, lo: int, hi: int) -> int:
        """Most stored nonzeros of any row inside columns ``[lo, hi)``."""
        idx = self._range(lo, hi)
        if not len(idx):
            return 0
        return int(np.bincount(self._rows[idx]).max())

    def chunk_cap(self, schedule) -> int:
        """One slot capacity for every ``(lo, hi)`` chunk of ``schedule``:
        the largest per-chunk row occupancy, so all chunks share one
        (n, cap) shape."""
        return max(max((self.max_row_nnz(lo, hi) for lo, hi in schedule),
                       default=1), 1)


def column_block(a: SpCSR, lo: int, hi: int, cap: int | None = None) -> SpCSR:
    """Host-side column slice ``a[:, lo:hi]`` with rebased column ids (one
    chunk; carving many chunks should build a :class:`ColumnSlicer`)."""
    return ColumnSlicer(a).block(lo, hi, cap=cap)
