"""Registered solvers (port of ``repro.nmf.solvers``): ``als``,
``enforced``, ``sequential`` and ``streaming``.

``als`` and ``enforced`` run one engine, :func:`repro_torch.core.nmf.als_nmf`,
through :func:`_run_chunked`, which owns the ``tol`` early stop and the
health check.  The engine never syncs with the host; ``_run_chunked`` reads
the health index (and, with ``tol``, the last residual) once per chunk, as
the reference does.  ``sequential`` runs paper Alg. 3
(:mod:`repro_torch.core.sequential`); ``streaming`` runs the online engine
over column chunks (:func:`solve_streaming`).  Checkpointing, rollback and
the mesh engines are not ported yet.

There is deliberately no counterpart of the reference's
``_with_kernel_fallback``: on the card a kernel failure raises instead of
quietly swapping the kernel path for a plain one.
"""
from __future__ import annotations

import torch

from repro_torch.core.nmf import Matrix, _relative_error, als_nmf, solve_gram
from repro_torch.core.sequential import sequential_als_nmf
from repro_torch.kernels.bsr import BSROperand
from repro_torch.nmf.config import NMFConfig
from repro_torch.nmf.registry import register_solver
from repro_torch.nmf.result import FitResult

__all__ = ["FitHealthError", "default_chunk_docs", "solve_als",
           "solve_enforced", "solve_sequential", "solve_streaming"]

#: iteration chunk used when an early-stop tolerance is active
_TOL_CHUNK = 10


def default_chunk_docs(m: int) -> int:
    """The streaming solver's default chunk width: 8 chunks over the
    corpus."""
    return max(-(-m // 8), 1)


def _reject_bsr_operand(a: Matrix, solver_name: str) -> None:
    """The sequential engine dispatches on dense / ``SpCSR`` only."""
    if isinstance(a, BSROperand):
        raise TypeError(
            f"the {solver_name!r} solver does not support BSR operands "
            "(backend 'cuda-bsr'); use the als/enforced solvers, or pass "
            "the matrix as dense / SpCSR / scipy sparse")


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


@register_solver("sequential", u0_cols=lambda cfg: cfg.block_size)
def solve_sequential(a: Matrix, config: NMFConfig,
                     u0: torch.Tensor) -> FitResult:
    """Sequential ALS (paper Alg. 3): topics converge one
    ``block_size``-wide block at a time; ``config.iters`` is the per-block
    budget, ``t_u`` / ``t_v`` budgets apply per block (by bisection,
    whatever ``sparsity.mode``), and ``tol`` is ignored."""
    _reject_bsr_operand(a, "sequential")
    k2 = config.block_size
    blocks = config.k // k2
    if u0.shape[1] == config.k and k2 != config.k:
        u0 = u0[:, :k2].contiguous()
    if u0.shape[1] != k2:
        raise ValueError(
            f"sequential solver needs u0 with {k2} (block_size) or "
            f"{config.k} (k) columns, got {u0.shape[1]}")
    n, m = a.shape
    res = sequential_als_nmf(
        a, u0, k2=k2, blocks=blocks, iters=config.iters,
        t_u=config.sparsity.resolve(n, k2, "u"),
        t_v=config.sparsity.resolve(m, k2, "v"),
        track_error=config.track_error, backend=config.backend)
    return FitResult.from_sequential_result(res)


def _make_packer(model, source):
    """The per-chunk pack of the stream (run by the
    :class:`~repro_torch.data.corpus.Prefetcher`'s worker, or inline):
    load chunk ``i`` (mmap page-in), ingest it for the configured backend
    on the host and, on the card, copy it from pinned memory on one side
    stream (:func:`~repro_torch.data.corpus.stage_chunk`)."""
    from repro_torch.backend import get_backend, select_backend
    from repro_torch.data.corpus import stage_chunk

    dev = model.device
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    name = model.config.backend
    be = None if name is None else get_backend(name)
    # on torch-csr / torch-dense the chunk is its operand as it is: it goes
    # out of the mapping straight into pinned memory, one copy; cuda-bsr
    # builds new tiles from it, and those are pinned on their way
    pin = dev.type == "cuda" and not (be is not None
                                      and be.name.startswith("cuda-bsr"))

    def pack(i):
        host = source.load(i, pin=pin)
        return stage_chunk(host, be if be is not None else select_backend(host),
                           dev, stream)

    return pack


def _fold_in_streamed(model, source, pack, config: NMFConfig):
    """Frozen-U fold-in of the whole corpus, one chunk at a time: each
    chunk adds its rows of ``A^T U`` (one ``bsr_spmm`` launch a chunk on
    ``cuda-bsr``), then one Gram solve, relu and enforcement, as
    :meth:`EnforcedNMF.transform` solves them.  Returns ``(v, the
    Prefetcher's stats)``."""
    from repro_torch.core.nmf import _matmul_t
    from repro_torch.data.corpus import Prefetcher

    u = model.u_
    gram = u.T @ u
    parts = []
    with Prefetcher(range(len(source.schedule)), pack,
                    depth=config.prefetch_depth,
                    enabled=config.prefetch) as stream:
        for staged in stream:
            parts.append(_matmul_t(staged.use(), u, config.backend))
    v = solve_gram(gram, torch.cat(parts, dim=0))
    return model._enforce_v(torch.clamp_min(v, 0.0)), stream.stats


@register_solver("streaming")
def solve_streaming(a, config: NMFConfig, u0: torch.Tensor) -> FitResult:
    """Online ALS (:mod:`repro_torch.core.online`) over column chunks of
    ``a``, through ``EnforcedNMF.partial_fit``, ``config.chunk_docs``
    documents a chunk (default: 8 chunks), ``min(config.iters, 10)`` inner
    passes each.

    ``a`` is resident (dense / ``SpCSR``) or out of core (a corpus
    directory, an ``MmapCorpus`` or any ``ChunkSource``).  Each chunk is
    packed ahead of its step (:func:`_make_packer`, on a worker thread with
    ``config.prefetch``); resident and from-disk fits carve identical chunk
    arrays, so their trajectories match bit for bit, and so do prefetch on
    and off.  ``t_v`` budgets resolve against the whole corpus and are
    rescaled per chunk.  ``tol`` stops the stream once the cross-chunk
    relative residual drops below it (one host read a chunk, only then).
    The health index is read once, at the end of the stream.

    The history is per chunk (``error_granularity="chunk"``): ``residual``
    is the cross-chunk U movement, ``error`` each chunk's relative
    reconstruction error, and ``v`` one frozen-U fold-in pass over the
    whole corpus."""
    from repro_torch.data.corpus import Prefetcher, as_chunk_source
    from repro_torch.nmf.estimator import EnforcedNMF

    if isinstance(a, BSROperand):
        raise TypeError(
            "the 'streaming' solver carves column chunks host-side, which "
            "BSR operands (backend 'cuda-bsr') cannot do; fit with dense / "
            "SpCSR / scipy input (the chunks still run on any backend, "
            "cuda-bsr included)")
    source = as_chunk_source(a, chunk_docs=config.chunk_docs)
    n, m = source.shape
    model = EnforcedNMF(config, device=u0.device)
    model.u_ = u0
    model.n_features_ = n
    model._m_ref = m  # t_v budgets are the whole corpus's; chunks rescale
    pack = _make_packer(model, source)

    # per-chunk metrics stay device scalars: with tol = 0 nothing reads
    # the host until the stream ends
    dev = u0.device
    residuals, errors, nnz_us, nnz_vs = [], [], [], []
    max_nnz = torch.sum(u0 != 0).to(torch.int32)
    health = torch.full((), -1, dtype=torch.int32, device=dev)
    converged = False
    with Prefetcher(range(len(source.schedule)), pack,
                    depth=config.prefetch_depth,
                    enabled=config.prefetch) as stream:
        for idx, staged in enumerate(stream):
            chunk = staged.use()
            u_prev = model.u_
            model.partial_fit(chunk)
            u, v = model.u_, model.v_
            r = (torch.linalg.norm(u - u_prev)
                 / torch.clamp_min(torch.linalg.norm(u), 1e-30))
            residuals.append(r)
            errors.append(_relative_error(chunk, u, v)
                          if config.track_error
                          else torch.zeros((), device=dev))
            nu = torch.sum(u != 0).to(torch.int32)
            nv = torch.sum(v != 0).to(torch.int32)
            nnz_us.append(nu)
            nnz_vs.append(nv)
            max_nnz = torch.maximum(max_nnz, nu + nv)
            health = torch.where((health < 0) & (model.health_ >= 0),
                                 idx, health)
            if config.tol > 0.0 and float(r) <= config.tol:
                converged = True
                break
    if config.on_unhealthy == "raise" and int(health) >= 0:
        raise FitHealthError(
            f"streaming fit went unhealthy by chunk {int(health)}")

    v_full, fold_stats = _fold_in_streamed(model, source, pack, config)
    return FitResult(
        u=model.u_, v=v_full,
        residual=torch.stack(residuals).float(),
        error=torch.stack(errors).float(),
        max_nnz=max_nnz, solver="streaming", n_iter=len(residuals),
        converged=converged, nnz_u=torch.stack(nnz_us),
        nnz_v=torch.stack(nnz_vs), health=health,
        error_granularity="chunk",
        stream_stats={"fit": stream.stats, "fold_in": fold_stats},
    )
