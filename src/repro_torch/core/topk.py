"""Top-t magnitude projection primitives (port of ``repro.core.topk``).

The paper's core operation (Alg. 2 steps 2/4): keep only the ``t``
largest-magnitude entries of a matrix, zeroing the rest.

* :func:`topk_project_exact` — sort-based, keeps exactly ``t``; the oracle.
* :func:`topk_project_bisect` — threshold bisection: ``tau`` with
  ``count(|x| >= tau) ~= t`` after a fixed number of float bisection steps,
  then a mask.  The bisection runs on the device in f32 with no host sync;
  it is bitwise the reference's on f32 input.
* :class:`FusedReluTopK` — relu + bisection threshold + mask, the mask in
  one pass of the ``project_mask`` kernel.
* :func:`topk_project_columns` — per-column enforcement (paper §4).

``DistTopK`` (the mesh histogram variant) is not ported yet.  Ties at the
threshold: the bisection keeps every entry equal to the final ``tau``.

The 40-step bisection is a few hundred small launches per call in eager
PyTorch (XLA fused it into the engine's scan); it is measured, not yet
fused, in this slice.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "topk_threshold_bisect",
    "topk_project_exact",
    "topk_project_bisect",
    "topk_project_columns",
    "FusedReluTopK",
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


def topk_threshold_bisect(x: torch.Tensor, t: int,
                          num_steps: int = 40) -> torch.Tensor:
    """Return ``tau`` (a 0-d device tensor) such that ``count(|x| >= tau)``
    is as close to ``t`` as float bisection allows (count >= t at the
    returned tau).  Every step stays on the device in f32, in the
    reference's arithmetic, so ``tau`` is bitwise the reference's."""
    absx = torch.abs(x)
    hi = torch.max(absx).float()
    lo = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(num_steps):
        mid = 0.5 * (lo + hi)
        # too many kept -> raise threshold (lo=mid); too few -> lower it
        over = torch.sum(absx >= mid) > t
        lo = torch.where(over, mid, lo)
        hi = torch.where(over, hi, mid)
    tau = torch.where(torch.sum(absx >= hi) >= t, hi, lo)
    return tau.to(absx.dtype)


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
    """The whole ALS epilogue — relu, then the top-t threshold mask — with
    the mask as one pass of the ``project_mask`` kernel.

    The bisection counts the relu'd factor, so ``tau`` is bitwise the
    reference's; the threshold reaches the kernel as a device tensor.  The
    engine skips its own relu when a sparsifier sets ``fuses_relu``."""

    t: int
    num_steps: int = 40

    fuses_relu = True

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels.ops import fused_project_mask

        if int(self.t) >= x.numel():
            return torch.clamp_min(x, 0.0)
        if int(self.t) == 0:
            return torch.zeros_like(x)
        pos = torch.clamp_min(x, 0.0)
        tau = topk_threshold_bisect(pos, self.t, self.num_steps)
        return fused_project_mask(x, tau)


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
