"""Padded-CSR static-capacity sparse matrices (port of ``repro.sparse.csr``).

Each row keeps a fixed capacity ``cap`` of (value, col) slots:

* ``values``: (n, cap) float  — padded slots hold 0.0
* ``cols``:   (n, cap) int32  — padded slots hold 0 (safe: value is 0)

Packing is host-side numpy work, identical to the reference's, so the
``values`` / ``cols`` arrays are bitwise the reference's; the tensors move to
``device`` once, at the end.  The chunked products and ``ColumnSlicer`` of the
reference are not ported yet.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple

import numpy as np
import torch

__all__ = ["SpCSR", "from_coo", "from_scipy", "to_scipy", "to_dense",
           "spmm", "spmm_t"]


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

    def nnz(self) -> torch.Tensor:
        return torch.sum(self.values != 0)

    def sqnorm(self) -> torch.Tensor:
        return torch.sum(self.values.float() ** 2)


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
    out = torch.zeros(a.shape, dtype=a.values.dtype, device=a.device)
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
