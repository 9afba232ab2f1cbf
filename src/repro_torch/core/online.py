"""Online (streaming) ALS engine: sufficient-statistics NMF over document
chunks (port of ``repro.core.online``).

The online engine needs one document chunk at a time plus two
accumulators, the memory-limited formulation of Nguyen & Ho
(arXiv:1506.08938):

    stats.av = sum_c A_c V_c      (n, k)
    stats.gv = sum_c V_c^T V_c    (k, k)

One :func:`online_als_step` refines ``U`` against the whole stream seen so
far with ``iters`` inner passes over the chunk:

    V_c = top-t_v( relu( A_c^T U G_U^{-1} ) )        G_U = U^T U
    G_V = forget * stats.gv + V_c^T V_c
    AV  = forget * stats.av + A_c V_c
    U   = top-t_u( relu( AV G_V^{-1} ) )

Every product goes through the backend's half-step hooks, as in the batch
engine (:func:`repro_torch.core.nmf.als_nmf`): on ``cuda-bsr`` each pass is
two launches of the fused spmm + Gram kernel and two of the ``relu_topk``
epilogue.  The reference's ``lax.scan`` is a Python loop here that never
reads a value back to the host: ``forget`` is a device tensor and the
health index a device int.

``fit`` seeds the statistics (:func:`seed_online_stats`) so that a later
``partial_fit`` continues from the fitted model.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core.nmf import (
    Matrix, Sparsifier, _epilogue, _resolve, solve_gram,
)

__all__ = ["OnlineStats", "OnlineStepResult", "init_online_stats",
           "online_als_step", "seed_online_stats"]


class OnlineStats(NamedTuple):
    """Sufficient statistics of the stream seen so far."""

    av: torch.Tensor  # (n, k)  sum over chunks of A_c @ V_c
    gv: torch.Tensor  # (k, k)  sum over chunks of V_c^T @ V_c


class OnlineStepResult(NamedTuple):
    u: torch.Tensor        # (n, k) refined factor
    v: torch.Tensor        # (m_chunk, k) loadings of this chunk's documents
    stats: OnlineStats     # accumulators including this chunk
    health: torch.Tensor   # 0-d int32: first unhealthy inner pass, -1 ok


def init_online_stats(n: int, k: int, dtype=torch.float32,
                      device=None) -> OnlineStats:
    """Zero accumulators for a fresh stream."""
    return OnlineStats(av=torch.zeros((n, k), dtype=dtype, device=device),
                       gv=torch.zeros((k, k), dtype=dtype, device=device))


def seed_online_stats(a: Matrix, v: torch.Tensor, backend=None
                      ) -> OnlineStats:
    """Statistics equivalent to having streamed ``a`` with loadings ``v``:
    one half-step product (one fused launch on ``cuda-bsr``) instead of
    pinning the corpus."""
    be = _resolve(a, backend)
    av, gv = be.matmul_with_gram(a, v)
    return OnlineStats(av=av, gv=be.reduce_v(gv))


def online_als_step(
    a_chunk: Matrix,
    u: torch.Tensor,
    stats: OnlineStats,
    forget: Union[torch.Tensor, float] = 1.0,
    *,
    iters: int = 1,
    sparsify_u: Optional[Sparsifier] = None,
    sparsify_v: Optional[Sparsifier] = None,
    backend=None,
) -> OnlineStepResult:
    """One online-ALS update over a document chunk (n, m_chunk).

    Each of the ``iters`` inner passes recomputes the chunk's statistics
    from the pre-chunk accumulators (inner refinement never counts the
    chunk twice); the last pass's are returned.  ``forget`` < 1 decays the
    old stream.  ``backend`` is a registry name, a backend instance or
    ``None`` to select from the operand type.
    """
    be = _resolve(a_chunk, backend)
    k = u.shape[1]
    m_chunk = a_chunk.shape[1]
    dev = u.device
    if not isinstance(forget, torch.Tensor):
        # a fill, not a copy from the host
        forget = torch.full((), float(forget), dtype=u.dtype, device=dev)
    forget = forget.to(dtype=u.dtype)
    health = torch.full((), -1, dtype=torch.int32, device=dev)
    v = torch.zeros((m_chunk, k), dtype=u.dtype, device=dev)
    gv, av = stats.gv, stats.av
    for it in range(max(int(iters), 1)):
        atu, gu = be.matmul_t_with_gram(a_chunk, u)
        gu = be.reduce_u(gu)
        v = _epilogue(solve_gram(gu, atu), sparsify_v)
        av_c, gv_c = be.matmul_with_gram(a_chunk, v)
        gv = forget * stats.gv + be.reduce_v(gv_c)
        av = forget * stats.av + av_c
        u_new = _epilogue(solve_gram(gv, av), sparsify_u)

        # health monitor, as in the batch engine: non-finite factors or a
        # non-finite Gram accumulator; and, beyond the reference, a
        # non-finite U entering the pass (its Gram), which a top-t epilogue
        # would otherwise mask into an all-zero V and a finite step
        bad_u = be.reduce_u(torch.sum(~torch.isfinite(u_new)))
        bad_v = be.reduce_v(torch.sum(~torch.isfinite(v)))
        bad = ((bad_u + bad_v > 0) | ~torch.isfinite(torch.sum(gv))
               | ~torch.isfinite(torch.sum(gu)))
        health = torch.where((health < 0) & bad, it, health)
        u = u_new
    return OnlineStepResult(u=u, v=v, stats=OnlineStats(av=av, gv=gv),
                            health=health)
