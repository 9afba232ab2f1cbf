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

``DistTopK`` (the mesh histogram variant) is not ported yet.  Ties at the
threshold: the bisection keeps every entry equal to the final ``tau``.
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
