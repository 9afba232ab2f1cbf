"""Registered ALS-family solvers (port of ``repro.nmf.solvers``, first
slice: ``als`` and ``enforced``).

Both run one engine, :func:`repro_torch.core.nmf.als_nmf`, through
:func:`_run_chunked`, which owns the ``tol`` early stop and the health
check.  The engine never syncs with the host; ``_run_chunked`` reads the
health index (and, with ``tol``, the last residual) once per chunk, as the
reference does.

There is deliberately no counterpart of the reference's
``_with_kernel_fallback``: on the card a kernel failure raises instead of
quietly swapping the kernel path for a plain one.
"""
from __future__ import annotations

import torch

from repro_torch.core.nmf import Matrix, als_nmf
from repro_torch.nmf.config import NMFConfig
from repro_torch.nmf.registry import register_solver
from repro_torch.nmf.result import FitResult

__all__ = ["FitHealthError", "solve_als", "solve_enforced"]

#: iteration chunk used when an early-stop tolerance is active
_TOL_CHUNK = 10


class FitHealthError(RuntimeError):
    """The fit's factors went non-finite or its residual exploded."""


def _run_chunked(run, config: NMFConfig, u0: torch.Tensor,
                 solver_name: str) -> FitResult:
    """Drive ``run(u_init, iters) -> NMFResult`` with the early stop and
    the health check.  The engine recomputes V from U at the top of every
    iteration, so restarting a chunk from the previous chunk's U is exactly
    one long run."""
    total = config.iters
    step_base = _TOL_CHUNK if config.tol > 0.0 else total
    parts, u, done, converged = [], u0, 0, False
    while done < total:
        step = min(step_base, total - done)
        res = run(u, step)
        if config.on_unhealthy == "raise" and int(res.health) >= 0:
            raise FitHealthError(
                f"{solver_name} fit went unhealthy (non-finite factors or "
                f"exploding residual) at iteration {done + int(res.health)}")
        parts.append(FitResult.from_nmf_result(res, solver_name))
        u, done = res.u, done + step
        if config.tol > 0.0 and float(res.residual[-1]) <= config.tol:
            converged = True
            break
    return FitResult.concatenate(parts, converged=converged)


def _als_family(a: Matrix, config: NMFConfig, u0: torch.Tensor,
                solver_name: str) -> FitResult:
    from repro_torch.backend import resolve_backend

    n, m = a.shape
    be = resolve_backend(a, config.backend)
    # the kernel backend fuses relu + threshold mask into one kernel pass
    sp_u = config.sparsity.sparsifier(n, config.k, "u",
                                      fused=be.fuse_epilogue)
    sp_v = config.sparsity.sparsifier(m, config.k, "v",
                                      fused=be.fuse_epilogue)

    def run(u_init, iters):
        return als_nmf(a, u_init, iters=iters, sparsify_u=sp_u,
                       sparsify_v=sp_v, track_error=config.track_error,
                       backend=be)

    return _run_chunked(run, config, u0, solver_name)


@register_solver("als")
def solve_als(a: Matrix, config: NMFConfig, u0: torch.Tensor) -> FitResult:
    """Projected ALS (paper Alg. 1); with a non-trivial ``Sparsity`` spec it
    is identical to ``"enforced"``."""
    return _als_family(a, config, u0, "als")


@register_solver("enforced")
def solve_enforced(a: Matrix, config: NMFConfig,
                   u0: torch.Tensor) -> FitResult:
    """Enforced-sparsity ALS (paper Alg. 2): top-t projection of U and/or V
    inside every iteration."""
    return _als_family(a, config, u0, "enforced")
