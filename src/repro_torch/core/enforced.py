"""Enforced Sparsity ALS, paper Algorithm 2: sparsifier factories and the
legacy front door (port of ``repro.core.enforced``).

The factories return callables for the ``sparsify_u`` / ``sparsify_v``
arguments of :func:`repro_torch.core.nmf.als_nmf`.
"""
from __future__ import annotations

import functools
from typing import Optional

from repro_torch.core import topk

__all__ = ["global_topt", "global_topt_exact", "columnwise_topt",
           "enforced_sparsity_nmf"]


def global_topt(t: int, num_steps: int = 40):
    """Keep the ``t`` largest-magnitude entries of the whole matrix
    (bisection threshold, the scalable variant)."""
    return functools.partial(topk.topk_project_bisect, t=t,
                             num_steps=num_steps)


def global_topt_exact(t: int):
    """Exact top-t (sort-based, as the paper does in MATLAB)."""
    return functools.partial(topk.topk_project_exact, t=t)


def columnwise_topt(t_per_col: int):
    """Keep ``t_per_col`` largest entries per column (paper §4)."""
    return functools.partial(topk.topk_project_columns, t_per_col=t_per_col)


def enforced_sparsity_nmf(
    a,
    u0,
    t_u: Optional[int] = None,
    t_v: Optional[int] = None,
    iters: int = 75,
    exact: bool = False,
    columnwise: bool = False,
    track_error: bool = True,
):
    """Algorithm 2 front door: projected ALS with top-t enforcement on U
    and / or V (``None`` leaves a factor dense, Alg. 1 for it);
    ``columnwise=True`` reads t per column (paper §4).  Runs on ``u0``'s
    device, the backend selected from ``a``'s type."""
    from repro_torch.core.nmf import als_nmf

    def mk(t):
        if t is None:
            return None
        if columnwise:
            return columnwise_topt(t)
        return global_topt_exact(t) if exact else global_topt(t)

    return als_nmf(a, u0, iters=iters, sparsify_u=mk(t_u),
                   sparsify_v=mk(t_v), track_error=track_error)
