"""Top-t magnitude projection primitives (port of ``repro.core.topk``).

The paper's core operation (Alg. 2 steps 2/4): keep only the ``t``
largest-magnitude entries of a matrix, zeroing the rest.

* :func:`topk_project_exact` — sort-based, keeps exactly ``t``; the oracle.
* :func:`topk_project_bisect` — threshold bisection: ``tau`` with
  ``count(|x| >= tau) ~= t`` after a fixed number of float bisection steps
  (``topk_threshold_bisect``, kept with the kernels' plain versions in
  ``kernels/ref.py``), then a mask.  The bisection runs on the device in f32
  with no host sync; it is bitwise the reference's on f32 input.
* :class:`FusedReluTopK` — relu + bisection threshold + mask, the whole
  epilogue in one launch of the ``relu_topk`` kernel on the card.
* :func:`topk_project_columns` — per-column enforcement (paper §4).
* :class:`DistTopK` — the mesh engines' top-t of a factor sharded over a
  mesh axis: a log-spaced histogram of ``|x|``, summed over the axis by one
  ``all_reduce``, gives the threshold (:func:`dist_topk_threshold`).

Ties at the threshold: the bisection keeps every entry equal to the final
``tau``; ``DistTopK`` keeps every entry of ``tau``'s histogram bin.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.project_mask import relu_topk
from repro_torch.kernels.ref import topk_threshold_bisect

__all__ = [
    "topk_threshold_bisect",
    "topk_project_exact",
    "topk_project_bisect",
    "topk_project_columns",
    "FusedReluTopK",
    "DistTopK",
    "dist_topk_threshold",
    "log_histogram",
]


def topk_project_exact(x: torch.Tensor, t: int) -> torch.Tensor:
    """Keep exactly the ``t`` largest-magnitude entries of ``x``."""
    flat = torch.abs(x).reshape(-1)
    t = min(int(t), flat.shape[0])
    if t == 0:
        return torch.zeros_like(x)
    _, idx = torch.topk(flat, t)
    mask = torch.zeros(flat.shape[0], dtype=torch.bool, device=x.device)
    mask[idx] = True
    return torch.where(mask.reshape(x.shape), x, torch.zeros_like(x))


def topk_project_bisect(x: torch.Tensor, t: int,
                        num_steps: int = 40) -> torch.Tensor:
    """Keep (up to threshold ties) the ``t`` largest-magnitude entries."""
    if int(t) >= x.numel():
        return x
    if int(t) == 0:
        return torch.zeros_like(x)
    tau = topk_threshold_bisect(x, t, num_steps)
    return torch.where(torch.abs(x) >= tau, x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class FusedReluTopK:
    """The whole ALS epilogue — relu, then the top-t threshold mask.

    On the card it is one launch of the ``relu_topk`` kernel, which runs
    the bisection and the mask together; on the CPU its plain version
    (``kernels.ref.relu_topk_ref``).  The bisection counts the relu'd
    factor, so ``tau`` is bitwise the reference's.  The engine skips its
    own relu when a sparsifier sets ``fuses_relu``."""

    t: int
    num_steps: int = 40

    fuses_relu = True

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if int(self.t) >= x.numel():
            return torch.clamp_min(x, 0.0)
        if int(self.t) == 0:
            return torch.zeros_like(x)
        return relu_topk(x, self.t, self.num_steps)[0]


def topk_project_columns(x: torch.Tensor, t_per_col: int) -> torch.Tensor:
    """Keep the ``t_per_col`` largest-magnitude entries of every column
    (paper §4), ties broken in stable sort order like the reference."""
    n, k = x.shape
    t = min(int(t_per_col), n)
    if t == 0:
        return torch.zeros_like(x)
    if t >= n:
        return x
    order = torch.argsort(-torch.abs(x), dim=0, stable=True)
    ranks = torch.arange(n, device=x.device)[:, None].expand(n, k)
    rank = torch.empty((n, k), dtype=torch.long, device=x.device)
    rank.scatter_(0, order, ranks)
    return torch.where(rank < t, x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# The mesh variant: histogram threshold over a sharded factor
# ---------------------------------------------------------------------------

def log_histogram(absx: torch.Tensor, gmax: torch.Tensor, nbins: int = 8192):
    """``(hist, log_lo, step)``: the counts of the positive entries of
    ``absx`` in ``nbins`` + 1 log-spaced bins over ``[gmax * 1e-12, gmax]``
    (the reference's f32 arithmetic: ``log(max(|x|, 1e-38))``, ``ceil``,
    ``clip``).  Bin ``b`` counts ``edge[b - 1] < |x| <= edge[b]``, with
    ``edge[b] = exp(log_lo + b * step)``.  The counts are int64 and added
    with ``index_add_``: integer sums are exact in any order, and, unlike
    ``torch.bincount``, it does not read the input's range on the host."""
    log_lo = torch.log(gmax * 1e-12 + 1e-38)
    log_hi = torch.log(gmax + 1e-38)
    step = (log_hi - log_lo) / (nbins - 1)
    flat = absx.reshape(-1)
    logx = torch.log(torch.clamp_min(flat, 1e-38))
    # a NaN entry (an unhealthy factor) lands in bin 0 with weight 0, where
    # the reference's scatter drops its out-of-range index
    q = torch.nan_to_num(torch.ceil((logx - log_lo) / step), nan=0.0)
    idx = torch.clamp(q, 0, nbins).long()
    hist = torch.zeros((nbins + 1,), dtype=torch.int64, device=absx.device)
    hist.index_add_(0, idx, (flat > 0).long())
    return hist, log_lo, step


def dist_topk_threshold(x: torch.Tensor, t: int, mesh, axes,
                        nbins: int = 8192) -> torch.Tensor:
    """``tau`` with ``count(|x| >= tau) ~ t`` over the whole factor, the
    blocks of ``x`` held by the ranks that differ along ``axes`` of
    ``mesh`` (a :class:`repro_torch.launch.mesh.NMFMesh`): the largest
    magnitude by one ``all_reduce(MAX)``, this rank's histogram
    (:func:`log_histogram`) summed by one ``all_reduce(SUM)``, then the
    largest bin edge whose count of entries at or above it reaches ``t``
    (0 when none does).  Resolution one bin, ~0.34% in magnitude at 8192
    bins.  All on the device, no host read."""
    absx = torch.abs(x)
    gmax = mesh.all_reduce(torch.max(absx), axes, op="max")
    hist, log_lo, step = log_histogram(absx, gmax, nbins)
    hist = mesh.all_reduce(hist, axes)
    # counts_ge[b] = entries with |x| >= edge[b]: a suffix sum of the bins
    # above b
    counts_ge = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))[1:]
    bins = torch.arange(nbins, device=x.device)
    bidx = torch.max(torch.where(counts_ge >= t, bins,
                                 torch.full_like(bins, -1)))
    tau = torch.where(bidx < 0, torch.zeros_like(log_lo),
                      torch.exp(log_lo + bidx.to(torch.float32) * step))
    return tau.to(x.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class DistTopK:
    """Mesh top-t sparsifier: keep the ``t`` globally largest-magnitude
    entries of a factor sharded over ``axes`` of ``mesh``
    (:func:`dist_topk_threshold`; every entry at or above ``tau`` is kept,
    so NNZ is within ``tau``'s bin of ``t``).  ``t <= 0`` keeps nothing.
    The mask is a ``where``, as in the reference: the mesh engines' relu is
    the engine's own (``ShardedBackend.fuse_epilogue`` is False), so no
    ``relu_topk`` launch is on the mesh path."""

    t: int
    mesh: object
    axes: tuple
    nbins: int = 8192

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if int(self.t) <= 0:
            return torch.zeros_like(x)
        tau = dist_topk_threshold(x, self.t, self.mesh, self.axes,
                                  self.nbins)
        return torch.where(torch.abs(x) >= tau, x, torch.zeros_like(x))
