"""Registered solvers (port of ``repro.nmf.solvers``): ``als``,
``enforced``, ``sequential``, ``distributed`` and ``streaming``.

``als`` and ``enforced`` run one engine, :func:`repro_torch.core.nmf.als_nmf`,
through :func:`_run_chunked`, which owns the ``tol`` early stop, checkpoints,
resume and the health rollback.  The engine never syncs with the host;
``_run_chunked`` reads the health index (and, with ``tol``, the last
residual) once per chunk, as the reference does, and a snapshot copies the
factor to the host at its boundary.  ``sequential`` runs paper Alg. 3
(:mod:`repro_torch.core.sequential`) in checkpointed groups of blocks;
``streaming`` runs the online engine over column chunks
(:func:`solve_streaming`), reading the health index at snapshot boundaries
and at the end of the stream.  ``distributed`` is the ALS engine on a
``config.mesh_shape`` grid of ``torch.distributed`` ranks
(:func:`solve_distributed`, through the same ``_run_chunked``), and
``streaming`` on a grid runs each chunk's online step there
(``EnforcedNMF._partial_fit_sharded``).

There is deliberately no counterpart of the reference's
``_with_kernel_fallback``: on the card a kernel failure raises instead of
quietly swapping the kernel path for a plain one.
"""
from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from repro_torch.core.nmf import Matrix, _relative_error, als_nmf, solve_gram
from repro_torch.core.sequential import SequentialResult, sequential_als_nmf
from repro_torch.kernels.bsr import BSROperand
from repro_torch.nmf.config import NMFConfig
from repro_torch.nmf.registry import register_solver
from repro_torch.nmf.result import FitResult
from repro_torch.robustness import faults
from repro_torch.robustness.snapshot import FitCheckpointer, FitHealthError

__all__ = ["FitHealthError", "default_chunk_docs", "dist_budget",
           "mesh_inner_backend", "solve_als", "solve_distributed",
           "solve_enforced", "solve_sequential", "solve_streaming"]

#: iteration chunk used when an early-stop tolerance is active
_TOL_CHUNK = 10


def default_chunk_docs(m: int) -> int:
    """The streaming solver's default chunk width: 8 chunks over the
    corpus."""
    return max(-(-m // 8), 1)


def dist_budget(sparsity, rows: int, k: int, which: str):
    """The whole-factor nonzero budget of the mesh engines'
    :class:`~repro_torch.core.topk.DistTopK`, which thresholds the whole
    (rows, k) factor: a ``columnwise`` budget is per column, so it scales by
    ``k`` (the total matches the local path; the per-column distribution is
    not enforced)."""
    t = sparsity.resolve(rows, k, which)
    if t is not None and sparsity.mode == "columnwise":
        t = min(t * k, rows * k)
    return t


def mesh_inner_backend(config: NMFConfig, a) -> str:
    """The local per-block backend the mesh engines wrap: an explicit
    ``config.backend`` wins; a ``BSROperand`` or an already distributed
    ``DistBSR`` takes ``cuda-bsr``; everything else the padded-CSR blocks
    (``torch-csr``), as the reference defaults to ``jnp-csr``."""
    from repro_torch.core.distributed import DistBSR

    if config.backend is not None:
        return config.backend
    return "cuda-bsr" if isinstance(a, (BSROperand, DistBSR)) else \
        "torch-csr"


def _reject_bsr_operand(a: Matrix, solver_name: str) -> None:
    """The sequential engine dispatches on dense / ``SpCSR`` only."""
    if isinstance(a, BSROperand):
        raise TypeError(
            f"the {solver_name!r} solver does not support BSR operands "
            "(backend 'cuda-bsr'); use the als/enforced solvers, or pass "
            "the matrix as dense / SpCSR / scipy sparse")


def _on(x, device, dtype=None) -> torch.Tensor:
    """A restored host array as a new tensor on ``device``."""
    return torch.tensor(np.asarray(x), device=device, dtype=dtype)


def _history(residual, error, max_nnz, nnz_u=None, nnz_v=None) -> dict:
    """The JSON view of per-step histories (device tensors) that a snapshot's
    manifest carries, so a resumed fit's result covers the steps before the
    crash too.  One copy to the host: f32 and int32 values are exact in
    float64, and a float crosses JSON exactly."""
    named = {"residual": residual, "error": error,
             "max_nnz": max_nnz.reshape(1)}
    if nnz_u is not None:
        named.update(nnz_u=nnz_u, nnz_v=nnz_v)
    flat = torch.cat([t.reshape(-1).double() for t in named.values()]
                     ).tolist()
    out, lo = {}, 0
    for key, t in named.items():
        out[key], lo = flat[lo:lo + t.numel()], lo + t.numel()
    out["max_nnz"] = int(out["max_nnz"][0])
    for key in ("nnz_u", "nnz_v"):
        if key in out:
            out[key] = [int(x) for x in out[key]]
    return out


def _history_meta(parts) -> dict:
    """:func:`_history` of the ``FitResult`` parts accumulated so far."""
    cat = lambda field: torch.cat([getattr(p, field) for p in parts])
    return _history(cat("residual"), cat("error"),
                    torch.max(torch.stack([p.max_nnz for p in parts])),
                    cat("nnz_u"), cat("nnz_v"))


def _part_from_saved(hist: dict, solver_name: str,
                     device: torch.device) -> FitResult:
    """The history before the crash as a first ``FitResult`` part on
    ``device``.  Its factors are ``None``: only the last part's factors are
    read by :meth:`FitResult.concatenate`."""
    f32 = lambda key: torch.tensor(hist[key], dtype=torch.float32,
                                   device=device)
    i32 = lambda key: torch.tensor(hist[key], dtype=torch.int32,
                                   device=device)
    residual = f32("residual")
    return FitResult(
        u=None, v=None, residual=residual, error=f32("error"),
        max_nnz=i32("max_nnz"), solver=solver_name,
        n_iter=int(residual.shape[0]), nnz_u=i32("nnz_u"),
        nnz_v=i32("nnz_v"),
        health=torch.full((), -1, dtype=torch.int32, device=device))


def _reseed_perturb(u_src, seed: int, attempt: int,
                    device: torch.device) -> torch.Tensor:
    """A rollback's restart point: the restored (clean) factor times a
    multiplicative jitter in [0.9, 1.1).  Zeros stay zero (the sparsity
    structure survives) but the trajectory leaves the basin that went
    unstable.  The jitter is drawn from a CPU generator seeded from
    ``(seed, attempt)`` and moved to the factor's device, so a CPU run and a
    card run perturb alike; ``jax.random``'s stream, which the reference
    draws from, cannot be reproduced, so rollback trajectories agree with
    the reference's only in their properties."""
    u = (u_src.to(device) if isinstance(u_src, torch.Tensor)
         else _on(u_src, device))
    gen = torch.Generator().manual_seed(int(seed) * 1_000_003 + 1 + attempt)
    scale = 0.9 + 0.2 * torch.rand(tuple(u.shape), generator=gen,
                                   dtype=torch.float32)
    return u * scale.to(device=device, dtype=u.dtype)


def _with_checkpoint_stats(result: FitResult, ckpt) -> FitResult:
    if ckpt is None:
        return result
    return dataclasses.replace(result, checkpoint_stats=dict(ckpt.stats))


def _read_health(health: torch.Tensor, mesh=None) -> int:
    """The first unhealthy iteration (chunk), -1 when healthy, read on the
    host; on a mesh agreed over the grid first (the least non-negative
    index of any rank), so that every rank rolls back or none does.  A
    ``meta`` fit (the dry-run's, ``launch/dryrun.py``) holds no values to
    read: it counts as healthy, as the run it stands for must be."""
    if health.device.type == "meta":
        return -1
    if mesh is not None and mesh.size > 1:
        big = torch.iinfo(torch.int32).max
        h = torch.where(health < 0, big, health).reshape(1).to(torch.int32)
        h = mesh.all_reduce(h, ("data", "model"), op="min")[0]
        health = torch.where(h == big, -1, h)
    return int(health)


def _run_chunked(run, config: NMFConfig, u0: torch.Tensor, solver_name: str,
                 ckpt: FitCheckpointer = None, mesh=None) -> FitResult:
    """Drive ``run(u_init, iters) -> NMFResult`` with the early stop,
    checkpoints, resume and the health rollback.  The engine recomputes V
    from U at the top of every iteration, so restarting a chunk from a
    previous chunk's U (for ``tol``, a snapshot boundary or a resume) is
    exactly one long run.

    ``ckpt`` snapshots ``u`` and the histories every ``checkpoint_every``
    iterations and seeds the resume.  When a chunk's health index is set,
    ``"rollback"`` restarts from the last snapshot (or ``u0``) with a
    reseeded perturbation, at most ``max_rollbacks`` times; ``"raise"``
    raises at once.

    On a ``mesh`` (an ``NMFMesh``) ``u0`` is the whole initial factor and
    ``run`` takes and returns this rank's rows of U: snapshots hold the
    gathered U, a resume or rollback perturbs and restores the whole U and
    takes this rank's rows (so a snapshot resumes on any mesh shape), and
    the health index is agreed by an ``all_reduce`` before it is read."""
    total = config.iters
    dev = u0.device
    if mesh is not None:
        n = u0.shape[0]
        rows = mesh.row_block(n)
        place = lambda x: x[rows].contiguous()
        gather = lambda x: mesh.gather(x, n, "data")
    else:
        place = gather = lambda x: x
    u0_whole = u0
    parts, u, done, converged = [], place(u0), 0, False
    mark = (0, 0)  # (iterations done, len(parts)) at the last good snapshot
    if ckpt is not None and config.resume:
        saved = ckpt.resume()
        if saved is not None:
            done, arrays, meta = saved
            if done >= total:
                raise ValueError(
                    f"checkpoint at {ckpt.ckpt_dir} already holds {done} "
                    f"iterations but config.iters is {total}; raise iters "
                    "(the fingerprint ignores it) to continue the run")
            u = place(_on(arrays["u"], dev, u0.dtype))
            parts = [_part_from_saved(meta["history"], solver_name, dev)]
            mark = (done, 1)

    if config.tol > 0.0:
        step_base = (_TOL_CHUNK if ckpt is None
                     else min(_TOL_CHUNK, ckpt.every))
    else:
        step_base = total if ckpt is None else ckpt.every

    rollbacks = 0
    while done < total:
        step = min(step_base, total - done)
        res = run(faults.poison("poison-step", done, u), step)
        bad = (-1 if config.on_unhealthy == "ignore"
               else _read_health(res.health, mesh))
        if bad >= 0:
            bad_at = done + bad
            if (config.on_unhealthy == "raise"
                    or rollbacks >= config.max_rollbacks):
                raise FitHealthError(
                    f"{solver_name} fit went unhealthy (non-finite factors "
                    f"or exploding residual) at iteration {bad_at}"
                    + ("" if config.on_unhealthy == "raise" else
                       f"; gave up after {rollbacks} rollback(s)"))
            rollbacks += 1
            done, nparts = mark
            parts = parts[:nparts]
            src = (ckpt.last[1]["u"] if ckpt is not None
                   and ckpt.last is not None else u0_whole)
            u = place(_reseed_perturb(src, config.seed, rollbacks, dev))
            warnings.warn(
                f"{solver_name} fit went unhealthy at iteration {bad_at}; "
                f"rolling back to iteration {done} with reseeded RNG "
                f"(attempt {rollbacks}/{config.max_rollbacks})",
                RuntimeWarning)
            continue
        parts.append(FitResult.from_nmf_result(res, solver_name))
        u, done = res.u, done + step
        if ckpt is not None and ckpt.due(done, total):
            ckpt.save(done, {"u": gather(u)}, history=_history_meta(parts))
            mark = (done, len(parts))
        if config.tol > 0.0 and float(res.residual[-1]) <= config.tol:
            converged = True
            break
    return _with_checkpoint_stats(
        FitResult.concatenate(parts, converged=converged), ckpt)


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

    ckpt = FitCheckpointer.from_config(config, a)
    return _run_chunked(run, config, u0, solver_name, ckpt=ckpt)


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
    whatever ``sparsity.mode``), and ``tol`` is ignored.

    With ``checkpoint_dir`` the blocks converge in groups of
    ``checkpoint_every``, the zero-padded converged factors snapshotted
    between groups; each block update reads only ``(a, u0, U1, V1)``, so a
    resumed group is the computation one long run makes.  Like the
    reference's, this solver has no health monitor: ``on_unhealthy`` is not
    consulted."""
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
    common = dict(
        k2=k2, iters=config.iters,
        t_u=config.sparsity.resolve(n, k2, "u"),
        t_v=config.sparsity.resolve(m, k2, "v"),
        track_error=config.track_error, backend=config.backend)
    ckpt = FitCheckpointer.from_config(config, a)
    every = ckpt.every if ckpt is not None else blocks
    dev = u0.device
    done = 0
    u1 = v1 = None
    rs_parts, es_parts, mn_parts = [], [], []
    if ckpt is not None and config.resume:
        saved = ckpt.resume()
        if saved is not None:
            done, arrays, meta = saved
            if done >= blocks:
                raise ValueError(
                    f"checkpoint at {ckpt.ckpt_dir} already holds all "
                    f"{done} converged blocks; nothing to resume")
            u1 = _on(arrays["u"], dev, u0.dtype)
            v1 = _on(arrays["v"], dev, u0.dtype)
            hist = meta["history"]
            rs_parts = [torch.tensor(hist["residual"], dtype=torch.float32,
                                     device=dev).reshape(done, config.iters)]
            es_parts = [torch.tensor(hist["error"], dtype=torch.float32,
                                     device=dev)]
            mn_parts = [torch.tensor(int(hist["max_nnz"]), dtype=torch.int32,
                                     device=dev)]
    while done < blocks:
        nb = min(every, blocks - done)
        res = sequential_als_nmf(a, u0, blocks=nb, total_blocks=blocks,
                                 carry_u=u1, carry_v=v1, start_block=done,
                                 **common)
        u1, v1 = res.u, res.v
        rs_parts.append(res.residual)
        es_parts.append(res.error)
        mn_parts.append(res.max_nnz)
        done += nb
        if ckpt is not None and ckpt.due(done, blocks):
            ckpt.save(done, {"u": u1, "v": v1}, history=_history(
                torch.cat(rs_parts), torch.cat(es_parts),
                torch.max(torch.stack(mn_parts))))
    seq = SequentialResult(
        u=u1, v=v1, residual=torch.cat(rs_parts), error=torch.cat(es_parts),
        max_nnz=torch.max(torch.stack(mn_parts)))
    return _with_checkpoint_stats(FitResult.from_sequential_result(seq), ckpt)


@register_solver("distributed")
def solve_distributed(a, config: NMFConfig, u0: torch.Tensor) -> FitResult:
    """Enforced ALS on a ``config.mesh_shape`` grid of ``torch.distributed``
    ranks: the *same* engine as ``als`` / ``enforced``, run on this rank's
    block with a :class:`~repro_torch.backend.sharded.ShardedBackend` and
    :class:`~repro_torch.core.topk.DistTopK` sparsifiers, through
    :func:`_run_chunked` (``tol``, ``track_error``, the nnz traces, the
    running ``max_nnz``, checkpoints and rollback behave as on one device).

    Every rank calls it with the whole input (scipy sparse, ``SpCSR``,
    ``BSROperand``, dense) and the whole ``u0``, or with its own block
    (``DistCSR`` / ``DistBSR``); it carves its block from the input's
    stored entries (never densifying sparse input), and the shape must
    divide by the grid.  ``config.backend`` names the local backend of the
    blocks (``torch-csr`` or ``cuda-bsr`` / ``cuda-bsr-unfused``; ``None``
    selects by input, :func:`mesh_inner_backend`).  Sparsity is always the
    histogram threshold, so a ``"global"`` / ``"exact"`` spec maps onto it
    and a ``columnwise`` budget scales by k (:func:`dist_budget`).

    The returned ``u`` and ``v`` are whole on every rank (gathered by an
    ``all_reduce`` of zero-filled buffers), and so are the streaming
    statistics the estimator continues from, computed on the blocks (one
    more fused half-step).  A 1x1 mesh runs without a process group."""
    from repro_torch.backend.sharded import make_sharded_als
    from repro_torch.core.online import OnlineStats
    from repro_torch.core.topk import DistTopK
    from repro_torch.launch.mesh import make_nmf_mesh

    r, c = config.mesh_shape
    n, m = a.shape
    if n % r or m % c:
        raise ValueError(
            f"matrix shape {(n, m)} must be divisible by mesh_shape {(r, c)}")
    mesh = make_nmf_mesh(r, c, device=u0.device)
    t_u = dist_budget(config.sparsity, n, config.k, "u")
    t_v = dist_budget(config.sparsity, m, config.k, "v")
    engine = make_sharded_als(
        mesh,
        sparsify_u=None if t_u is None else DistTopK(t_u, mesh, ("data",)),
        sparsify_v=None if t_v is None else DistTopK(t_v, mesh, ("model",)),
        track_error=config.track_error,
        inner=mesh_inner_backend(config, a))
    dist = engine.distribute(a)
    ckpt = FitCheckpointer.from_config(config, a, mesh)
    res = _run_chunked(lambda u, iters: engine(dist, u, iters), config, u0,
                       "distributed", ckpt=ckpt, mesh=mesh)
    # the streaming statistics of the fitted V, on the blocks
    av, gv = engine.backend.matmul_with_gram(engine.local(dist), res.v)
    stats = OnlineStats(av=mesh.gather(av, n, "data"),
                        gv=engine.backend.reduce_v(gv))
    return dataclasses.replace(res, u=mesh.gather(res.u, n, "data"),
                               v=mesh.gather(res.v, m, "model"),
                               seed_stats=stats)


def _make_packer(model, source):
    """The per-chunk pack of the stream (run by the
    :class:`~repro_torch.data.corpus.Prefetcher`'s worker, or inline):
    load chunk ``i`` (mmap page-in), ingest it for the configured backend
    on the host and, on the card, copy it from pinned memory on one side
    stream (:func:`~repro_torch.data.corpus.stage_chunk`).  The staged chunk
    carries its schedule index ``i``.  On a mesh the packer is
    ``EnforcedNMF._pack_mesh_chunk``: this rank's block as a
    :class:`~repro_torch.data.corpus.PackedChunk`, on a grid made here (no
    collective runs off the calling thread); the skip hatch is refused
    there, since a chunk dropped on one rank only would desynchronize the
    grid."""
    from repro_torch.backend import get_backend, select_backend
    from repro_torch.data.corpus import stage_chunk

    from repro_torch.data.corpus import SKIP_BAD_CHUNKS_ENV

    dev = model.device
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    if model._mesh_streaming():
        if os.environ.get(SKIP_BAD_CHUNKS_ENV) == "1":
            raise ValueError(
                f"{SKIP_BAD_CHUNKS_ENV}=1 cannot stream on a mesh "
                f"(mesh_shape {model.config.mesh_shape}): a chunk dropped "
                "on one rank only would put the ranks' collectives out of "
                "step; unset it")
        # this rank's block of the chunk, ingested on the host and copied
        # on the side stream; the grid is made here, on the calling thread,
        # so the worker issues no collective
        mesh = model._mesh()
        return lambda i: model._pack_mesh_chunk(source.load(i), mesh,
                                                index=i, stream=stream)
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
                           dev, stream, index=i)

    return pack


def _merge_stats(stats: list) -> dict:
    """One ``Prefetcher.stats`` for the streams of a fit (a rollback
    replays the stream from its mark)."""
    out = dict(stats[0])
    for st in stats[1:]:
        for key, val in st.items():
            out[key] = max(out[key], val) if key == "max_queued" \
                else out[key] + val
    return out


def _fold_in_streamed(model, source, pack, config: NMFConfig):
    """Frozen-U fold-in of the whole corpus, one chunk at a time: each
    chunk adds its rows of ``A^T U`` (one ``bsr_spmm`` launch a chunk on
    ``cuda-bsr``), then one Gram solve and the fused relu + enforcement
    (one ``relu_topk`` launch), as :meth:`EnforcedNMF.transform` solves
    them.  A chunk the skip hatch dropped keeps zero rows, so ``v`` is
    (m, k) and row j is document j.  Returns ``(v, the Prefetcher's
    stats)``."""
    from repro_torch.core.nmf import _matmul_t
    from repro_torch.data.corpus import Prefetcher

    u = model.u_
    gram = u.T @ u
    rhs = torch.zeros((source.shape[1], u.shape[1]), dtype=u.dtype,
                      device=u.device)
    with Prefetcher(range(len(source.schedule)), pack,
                    depth=config.prefetch_depth,
                    enabled=config.prefetch) as stream:
        for staged in stream:
            lo, hi = source.schedule[staged.index]
            rhs[lo:hi] = model._chunk_matmul_t(staged, u)
    return model._enforce_v(solve_gram(gram, rhs)), stream.stats


def _restore_stream_state(model, ckpt, u0: torch.Tensor, config: NMFConfig,
                          attempt: int) -> torch.Tensor:
    """Roll the streaming estimator back to the last good snapshot (or the
    initial guess) with a reseed-perturbed factor; returns the restored
    running ``max_nnz``.  The accumulators restore exactly (they are stream
    statistics, not functions of ``u``), so replaying the chunks since the
    snapshot is the computation the uninterrupted stream makes."""
    dev = u0.device
    if ckpt is not None and ckpt.last is not None:
        _, arrays, meta = ckpt.last
        model.u_ = _reseed_perturb(arrays["u"], config.seed, attempt, dev)
        model._av_acc = _on(arrays["av"], dev)
        model._gv_acc = _on(arrays["gv"], dev)
        model.n_docs_seen_ = int(meta["n_docs_seen"])
        return torch.tensor(int(meta["history"]["max_nnz"]),
                            dtype=torch.int32, device=dev)
    model.u_ = _reseed_perturb(u0, config.seed, attempt, dev)
    model._av_acc = None
    model._gv_acc = None
    model.n_docs_seen_ = 0
    return torch.sum(model.u_ != 0).to(torch.int32)


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

    The health index stays on the device; it is read at snapshot
    boundaries (before the snapshot commits, so no snapshot is poisoned)
    and at the end of the stream.  A rollback restores the last snapshot's
    ``u`` (perturbed), ``av``, ``gv`` and document count, and replays the
    stream from it through a new prefetcher.  Every staged chunk carries
    its schedule index, which names the chunk in the poison hook, the
    snapshots and the fold-in, also after the skip hatch dropped one.

    The history is per chunk (``error_granularity="chunk"``): ``residual``
    is the cross-chunk U movement, ``error`` each chunk's relative
    reconstruction error, and ``v`` one frozen-U fold-in pass over the
    whole corpus.

    With a ``config.mesh_shape`` other than 1x1 every rank of the grid
    runs this with the same input: the prefetcher packs this rank's block
    of each chunk (:class:`~repro_torch.data.corpus.PackedChunk`), each
    step runs on the grid (``EnforcedNMF._partial_fit_sharded``), a
    chunk's error comes from the blocks, the fold-in and the statistics'
    seed run on the blocks too, and the health index is agreed by an
    ``all_reduce`` before it is read; snapshots hold the whole U and
    statistics, written by rank 0."""
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
    n_chunks = len(source.schedule)
    model = EnforcedNMF(config, device=u0.device)
    model.u_ = u0
    model.n_features_ = n
    model._m_ref = m  # t_v budgets are the whole corpus's; chunks rescale
    pack = _make_packer(model, source)
    mesh = model._mesh() if model._mesh_streaming() else None
    ckpt = FitCheckpointer.from_config(config, source, mesh)

    # per-chunk metrics stay device scalars: with tol = 0 and no snapshots
    # nothing reads the host until the stream ends
    dev = u0.device
    fresh = lambda: torch.full((), -1, dtype=torch.int32, device=dev)
    residuals, errors, nnz_us, nnz_vs = [], [], [], []
    max_nnz = torch.sum(u0 != 0).to(torch.int32)
    health = fresh()
    converged = False
    start = 0
    mark = (0, 0)  # (chunks done, metrics length) at the last good snapshot
    if ckpt is not None and config.resume:
        saved = ckpt.resume()
        if saved is not None:
            start, arrays, meta = saved
            if start >= n_chunks:
                raise ValueError(
                    f"checkpoint at {ckpt.ckpt_dir} already covers all "
                    f"{start} chunks; nothing to resume")
            hist = meta["history"]
            model.u_ = _on(arrays["u"], dev, u0.dtype)
            model._av_acc = _on(arrays["av"], dev)
            model._gv_acc = _on(arrays["gv"], dev)
            model.n_docs_seen_ = int(meta["n_docs_seen"])
            restored = lambda key, dt: list(torch.tensor(
                hist[key], dtype=dt, device=dev).unbind())
            residuals = restored("residual", torch.float32)
            errors = restored("error", torch.float32)
            nnz_us = restored("nnz_u", torch.int32)
            nnz_vs = restored("nnz_v", torch.int32)
            max_nnz = torch.tensor(int(hist["max_nnz"]), dtype=torch.int32,
                                   device=dev)
            mark = (start, len(residuals))

    rollbacks = 0
    fit_stats = []

    def healthy_or_rolled_back(idx: int) -> bool:
        """Read the health index at chunk ``idx``; when it is set, raise,
        or roll the stream's state back to the mark and return False."""
        nonlocal rollbacks, start, max_nnz, health
        first = (-1 if config.on_unhealthy == "ignore"
                 else _read_health(health, mesh))
        if first < 0:
            return True
        what = f"streaming fit went unhealthy at chunk {first} (read at " \
               f"chunk {idx})"
        if (config.on_unhealthy == "raise"
                or rollbacks >= config.max_rollbacks):
            raise FitHealthError(
                what + ("" if config.on_unhealthy == "raise" else
                        f"; gave up after {rollbacks} rollback(s)"))
        rollbacks += 1
        start, keep = mark
        del residuals[keep:], errors[keep:], nnz_us[keep:], nnz_vs[keep:]
        max_nnz = _restore_stream_state(model, ckpt, u0, config, rollbacks)
        health = fresh()
        warnings.warn(
            f"{what}; rolling back to chunk {start} with reseeded RNG "
            f"(attempt {rollbacks}/{config.max_rollbacks})", RuntimeWarning)
        return False

    replay = True
    while replay:
        replay = False
        expect = start
        with Prefetcher(range(start, n_chunks), pack,
                        depth=config.prefetch_depth,
                        enabled=config.prefetch) as stream:
            idx = start
            for staged in stream:
                idx = staged.index
                if idx < expect:
                    raise RuntimeError(
                        f"chunk {idx} staged for an abandoned stream reached "
                        f"the replay from chunk {start}")
                expect = idx + 1
                # a mesh step takes its packed block as it is
                chunk = staged if mesh is not None else staged.use()
                u_prev = model.u_
                model.u_ = faults.poison("poison-step", idx, model.u_)
                model.partial_fit(chunk)
                u, v = model.u_, model.v_
                r = (torch.linalg.norm(u - u_prev)
                     / torch.clamp_min(torch.linalg.norm(u), 1e-30))
                residuals.append(r)
                if not config.track_error:
                    errors.append(torch.zeros((), device=dev))
                elif mesh is not None:
                    errors.append(model._chunk_error)
                else:
                    errors.append(_relative_error(chunk, u, v))
                nu = torch.sum(u != 0).to(torch.int32)
                nv = torch.sum(v != 0).to(torch.int32)
                nnz_us.append(nu)
                nnz_vs.append(nv)
                max_nnz = torch.maximum(max_nnz, nu + nv)
                health = torch.where((health < 0) & (model.health_ >= 0),
                                     idx, health)
                done = idx + 1
                if ckpt is not None and ckpt.due(done, n_chunks):
                    if not healthy_or_rolled_back(idx):
                        replay = True
                        break
                    ckpt.save(
                        done,
                        {"u": model.u_, "av": model._av_acc,
                         "gv": model._gv_acc},
                        history=_history(
                            torch.stack(residuals), torch.stack(errors),
                            max_nnz, torch.stack(nnz_us),
                            torch.stack(nnz_vs)),
                        n_docs_seen=int(model.n_docs_seen_))
                    mark = (done, len(residuals))
                if config.tol > 0.0 and float(r) <= config.tol:
                    # a tolerance met on an unhealthy state is no
                    # convergence: read the health the stream's end reads
                    if not healthy_or_rolled_back(idx):
                        replay = True
                        break
                    converged = True
                    break
            else:
                # the end of the stream (its last chunk, or the skip hatch
                # dropped the chunks after idx)
                replay = not healthy_or_rolled_back(idx)
        fit_stats.append(stream.stats)

    v_full, fold_stats = _fold_in_streamed(model, source, pack, config)
    return _with_checkpoint_stats(FitResult(
        u=model.u_, v=v_full,
        residual=torch.stack(residuals).float(),
        error=torch.stack(errors).float(),
        max_nnz=max_nnz, solver="streaming", n_iter=len(residuals),
        converged=converged, nnz_u=torch.stack(nnz_us),
        nnz_v=torch.stack(nnz_vs), health=health,
        error_granularity="chunk",
        stream_stats={"fit": _merge_stats(fit_stats), "fold_in": fold_stats},
    ), ckpt)
