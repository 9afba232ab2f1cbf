"""Online (streaming) ALS statistics (port of ``repro.core.online``; this
slice ports what ``fit`` needs: the statistics and their seeding).

``fit`` seeds the streaming sufficient statistics

    av = A V      (n, k)
    gv = V^T V    (k, k)

so that a later ``partial_fit`` continues from the fitted model; one extra
half-step product (one fused kernel launch on ``cuda-bsr``) instead of
pinning the corpus.  ``online_als_step`` comes with ``partial_fit`` in a
later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.nmf import Matrix, _resolve

__all__ = ["OnlineStats", "seed_online_stats"]


class OnlineStats(NamedTuple):
    """Sufficient statistics of the stream seen so far."""

    av: torch.Tensor  # (n, k)  sum over chunks of A_c @ V_c
    gv: torch.Tensor  # (k, k)  sum over chunks of V_c^T @ V_c


def seed_online_stats(a: Matrix, v: torch.Tensor, backend=None
                      ) -> OnlineStats:
    """Statistics equivalent to having streamed ``a`` with loadings ``v``."""
    be = _resolve(a, backend)
    av, gv = be.matmul_with_gram(a, v)
    return OnlineStats(av=av, gv=be.reduce_v(gv))
