"""``EnforcedNMF`` — the estimator front door (port of
``repro.nmf.estimator``: ``fit``, ``fit_transform``, ``transform``,
``score`` and the streaming ``partial_fit``).

    A (n_terms x m_docs)  ~=  U (n_terms x k) @ V (m_docs x k)^T

``fit`` dispatches through the solver registry; ``transform`` folds unseen
documents into the fitted topic space with ``U`` frozen; ``partial_fit``
streams document chunks through the online engine
(:func:`repro_torch.core.online.online_als_step`) with accumulated
sufficient statistics.  The estimator runs on ``device`` — the card unless
the caller passes ``device="cpu"``; a missing card is an error, never a
silent CPU run.

Inputs may be dense tensors / numpy arrays, padded-CSR ``SpCSR``, a
``BSROperand`` or scipy sparse matrices (converted at ingest, never
densified on the kernel path); with ``solver="streaming"`` also an
out-of-core corpus (a :func:`repro_torch.data.corpus.write_corpus`
directory or any ``ChunkSource``).

With ``solver="distributed"`` the fit runs on a ``config.mesh_shape`` grid
of ``torch.distributed`` ranks; with ``solver="streaming"`` and a grid
other than 1x1 each ``partial_fit`` chunk's online step does
(:meth:`EnforcedNMF._partial_fit_sharded`).  Every rank of the grid makes
the same calls with the same inputs, each computes on its own block, and
``u_`` / ``v_`` (and the streaming statistics) come back whole on every
rank, as the reference's global arrays do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.backend import (
    BSROperand, default_backend_name, get_backend, resolve_backend,
)
from repro_torch.core.nmf import (
    Matrix, _epilogue, _matmul, _matmul_t, _relative_error, init_u0,
    solve_gram,
)
from repro_torch.core.online import (
    OnlineStats, init_online_stats, online_als_step, seed_online_stats,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nmf.config import NMFConfig, Sparsity
from repro_torch.nmf.registry import get_solver
from repro_torch.nmf.result import FitResult
from repro_torch.sparse.csr import SpCSR

__all__ = ["EnforcedNMF"]

ArrayLike = Union[torch.Tensor, np.ndarray, SpCSR, BSROperand]


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0]))


class EnforcedNMF:
    """Estimator over the enforced-sparse NMF solver family.

    >>> model = EnforcedNMF(NMFConfig(k=5, sparsity=Sparsity(t_u=55)))
    >>> model.fit(a)                          # a: (n_terms, m_docs)
    >>> v_new = model.transform(a_held_out)   # fold-in, U frozen

    Keyword overrides are applied on top of the given config.  Fitted
    attributes: ``u_`` (n, k), ``v_`` (m, k), ``result_``
    (:class:`FitResult`), ``n_iter_``, ``n_features_``, ``n_docs_seen_``,
    and ``health_`` (the latest online step's first unhealthy inner pass,
    a device int, -1 when healthy).
    """

    def __init__(self, config: Optional[NMFConfig] = None, *,
                 device: DeviceLike = None, **overrides):
        if config is None:
            config = NMFConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = resolve_device(device)
        self.u_: Optional[torch.Tensor] = None
        self.v_: Optional[torch.Tensor] = None
        self.result_: Optional[FitResult] = None
        self.n_iter_: int = 0
        self.n_features_: Optional[int] = None
        self.n_docs_seen_: int = 0
        self.health_: Optional[torch.Tensor] = None
        #: on a mesh: the grid (made once, on the main thread) and the online
        #: engines on it by inner backend (made once each)
        self._mesh_grid = None
        self._mesh_engines = {}
        #: the last mesh ``partial_fit``'s relative error on its own chunk
        #: (a device scalar; None unless ``config.track_error``)
        self._chunk_error: Optional[torch.Tensor] = None
        # reference document count for scaling absolute t_v budgets in
        # transform, and the streaming statistics fit seeds
        self._m_ref: Optional[int] = None
        self._av_acc: Optional[torch.Tensor] = None   # A V     (n, k)
        self._gv_acc: Optional[torch.Tensor] = None   # V^T V   (k, k)

    # -- input coercion ------------------------------------------------------

    def _coerce(self, a: ArrayLike, chunkable: bool = False,
                for_mesh: bool = False) -> Matrix:
        """Ingest ``a`` for ``config.backend`` on this estimator's device.

        With no explicit backend, tensors, ``SpCSR`` and ``BSROperand`` keep
        their format, scipy input goes to ``cuda-bsr`` (to ``torch-csr``
        for the sequential and streaming solvers, which carve or slice it),
        and numpy input becomes a dense tensor.  An explicit backend
        converts whatever comes in to its operand; numpy / scipy input is
        cast to ``config.dtype``.

        ``chunkable=True`` (the streaming ``fit``) keeps a ``cuda-bsr``
        target as column-sliceable ``SpCSR`` on the host instead: the
        corpus is carved into chunks there, and each chunk is ingested for
        the configured backend on its way to the card.  ``for_mesh`` (the
        distributed solver, mesh streaming chunks) likewise keeps the input
        on the host in a form whose stored entries the shard ingest reads
        (``SpCSR``, dense, or a ``BSROperand`` / block as it is): each rank
        packs its own block from it, so a whole-corpus operand on the
        device would be built for nothing."""
        from repro_torch.core.distributed import DistBSR, DistCSR

        name = self.config.backend
        if for_mesh and isinstance(a, (BSROperand, DistCSR, DistBSR)):
            return a
        device = (torch.device("cpu") if chunkable or for_mesh
                  else self.device)
        if ((chunkable or for_mesh) and name
                and get_backend(name).name.startswith("cuda-bsr")):
            name = "torch-csr"
        if name is None:
            if isinstance(a, (torch.Tensor, SpCSR, BSROperand)):
                return a.to(device)
            if isinstance(a, np.ndarray):
                return torch.as_tensor(a, dtype=self.config.torch_dtype,
                                       device=device)
            name = default_backend_name(a)
            if name == "cuda-bsr" and (for_mesh or self.config.solver in (
                    "sequential", "streaming", "distributed")):
                name = "torch-csr"
        native = isinstance(a, (SpCSR, BSROperand, torch.Tensor))
        return get_backend(name).prepare(
            a, dtype=None if native else self.config.torch_dtype,
            device=device)

    def _factor(self, x) -> torch.Tensor:
        """A caller's factor (numpy or tensor) on this device, contiguous,
        in the config dtype; numpy input is copied."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        return x.to(device=self.device,
                    dtype=self.config.torch_dtype).contiguous()

    def _check_fitted(self):
        if self.u_ is None:
            raise RuntimeError(
                "this EnforcedNMF instance is not fitted yet; call fit first")

    def _check_features(self, a: Matrix):
        if self.n_features_ is not None and a.shape[0] != self.n_features_:
            raise ValueError(
                f"input has {a.shape[0]} terms, the fitted model has "
                f"{self.n_features_}")

    # -- fitting -------------------------------------------------------------

    def fit(self, a: ArrayLike, u0=None,
            resume: Optional[bool] = None) -> "EnforcedNMF":
        """Factorize ``a`` with the configured solver.  ``u0`` (numpy or
        tensor, shape (n, k); the sequential solver also takes
        (n, block_size)) overrides the seeded default initial guess.

        With ``solver="streaming"``, ``a`` may be out of core: a
        :func:`~repro_torch.data.corpus.write_corpus` directory, an
        :class:`~repro_torch.data.corpus.MmapCorpus` or any ``ChunkSource``;
        chunks stream off disk, packed ahead of the step per
        ``config.prefetch``.

        ``resume`` overrides ``config.resume`` for this call: with a
        ``config.checkpoint_dir`` holding a snapshot of this same run, the
        fit continues from it (see :mod:`repro_torch.robustness`)."""
        from repro_torch.data.corpus import (
            ChunkSource, as_chunk_source, is_corpus_input,
        )

        cfg = self.config
        if resume is not None:
            cfg = cfg.replace(resume=bool(resume))
        streaming = cfg.solver == "streaming"
        if is_corpus_input(a):
            if not streaming:
                raise ValueError(
                    f"out-of-core corpora stream chunk-wise; the "
                    f"{cfg.solver!r} solver needs a resident matrix: use "
                    "solver='streaming' (or load the corpus yourself)")
            a = as_chunk_source(a, chunk_docs=cfg.chunk_docs)
        else:
            a = self._coerce(a, chunkable=streaming,
                             for_mesh=cfg.solver == "distributed")
            if streaming and not isinstance(a, BSROperand):
                a = as_chunk_source(a, chunk_docs=cfg.chunk_docs)
        n, m = a.shape
        entry = get_solver(cfg.solver)
        if u0 is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            u0 = init_u0(gen, n, entry.u0_cols(cfg), device=self.device)
        u0 = self._factor(u0)
        result = entry.fn(a, cfg, u0)
        self.u_, self.v_, self.result_ = result.u, result.v, result
        self.n_iter_ = result.n_iter
        self.n_features_ = n
        self.n_docs_seen_ = m
        self._m_ref = m
        # seed streaming statistics so a later partial_fit continues from
        # this fit: one more half-step product, instead of pinning the corpus
        if result.seed_stats is not None:
            stats = result.seed_stats
        elif isinstance(a, ChunkSource):
            stats, seed_pass = self._seed_stats_streamed(a)
            if result.stream_stats is not None:
                result.stream_stats["seed"] = seed_pass
        else:
            stats = seed_online_stats(a, self.v_, backend=cfg.backend)
        self._av_acc, self._gv_acc = stats.av, stats.gv
        return self

    def _seed_stats_streamed(self, source):
        """Full-corpus statistics ``(A V, V^T V)`` from a chunk source, one
        chunk resident at a time: each chunk adds ``A_c V_c`` with its rows
        of the fitted loadings.  The chunks come through the streaming
        solver's packer, prefetched per ``config.prefetch`` (on a mesh, this
        rank's blocks, whose products are summed over the grid).  Returns
        the statistics and the pass's ``Prefetcher.stats`` (``fit`` keeps
        them as ``result_.stream_stats["seed"]``)."""
        from repro_torch.data.corpus import Prefetcher
        from repro_torch.nmf.solvers import _make_packer

        cfg = self.config
        v = self.v_
        av = None
        with Prefetcher(range(len(source.schedule)),
                        _make_packer(self, source),
                        depth=cfg.prefetch_depth,
                        enabled=cfg.prefetch) as stream:
            for staged in stream:
                lo, hi = source.schedule[staged.index]
                part = self._chunk_matmul(staged, v[lo:hi])
                av = part if av is None else av + part
        if self._mesh_streaming():
            av = self._mesh().gather(av, self.n_features_, "data")
        return OnlineStats(av=av, gv=v.T @ v), stream.stats

    def _chunk_matmul(self, staged, v_chunk: torch.Tensor) -> torch.Tensor:
        """``A_c @ V_c`` of a staged chunk; on a mesh this rank's rows of
        it, summed over the chunk's column blocks."""
        from repro_torch.data.corpus import PackedChunk

        if not isinstance(staged, PackedChunk):
            return _matmul(staged.use(), v_chunk, self.config.backend)
        mesh = self._mesh()
        block = staged.use()
        engine = self._mesh_engine(mesh, block)
        view = engine.local(engine.distribute(block))
        v_pad = _pad_rows(v_chunk, view.shape[1] * mesh.cols)
        return engine.backend.matmul(view, v_pad[mesh.col_block(
            v_pad.shape[0])])

    def _chunk_matmul_t(self, staged, u: torch.Tensor) -> torch.Tensor:
        """``A_c^T @ U`` (m_c, k) of a staged chunk, whole; on a mesh
        summed over the row blocks and gathered over the column blocks."""
        from repro_torch.data.corpus import PackedChunk

        if not isinstance(staged, PackedChunk):
            return _matmul_t(staged.use(), u, self.config.backend)
        mesh = self._mesh()
        block = staged.use()
        engine = self._mesh_engine(mesh, block)
        view = engine.local(engine.distribute(block))
        part = engine.backend.matmul_t(view, u[mesh.row_block(u.shape[0])])
        whole = mesh.gather(part, view.shape[1] * mesh.cols, "model")
        return whole[:staged.m_docs]

    def fit_transform(self, a: ArrayLike, u0=None) -> torch.Tensor:
        """Fit and return the document-topic loadings ``V`` (m, k)."""
        return self.fit(a, u0=u0).v_

    def partial_fit(self, a_chunk, iters: Optional[int] = None,
                    forget: float = 1.0) -> "EnforcedNMF":
        """Online ALS over one document chunk (n_terms, m_chunk).

        Keeps running sufficient statistics ``sum A_c V_c`` and
        ``sum V_c^T V_c`` over every chunk seen, so the ``U`` update uses
        the whole stream; ``forget`` < 1 decays old chunks.  ``iters``
        defaults to ``min(config.iters, 10)`` inner passes.  Absolute
        whole-factor ``t_v`` budgets are rescaled by the chunk's share of
        the reference corpus (see :meth:`transform`); ``t_u`` applies to
        the whole factor.  A chunk staged by the streaming solver's packer
        (:class:`~repro_torch.data.corpus.StagedChunk`) is used as it is.
        On ``cuda-bsr`` each inner pass is two fused spmm + Gram launches
        and two ``relu_topk`` epilogues; nothing waits for the host.

        With ``solver="streaming"`` and a ``mesh_shape`` other than 1x1 the
        step runs on the grid (:meth:`_partial_fit_sharded`): every rank
        calls this with the same chunk, or with its
        :class:`~repro_torch.data.corpus.PackedChunk` (its own block, packed
        ahead by the streaming solver's prefetcher)."""
        from repro_torch.core.distributed import DistBSR, DistCSR
        from repro_torch.data.corpus import PackedChunk, StagedChunk

        if not 0.0 < forget <= 1.0:
            raise ValueError(f"forget must be in (0, 1], got {forget}")
        cfg = self.config
        mesh_stream = self._mesh_streaming()
        if isinstance(a_chunk, (PackedChunk, DistCSR, DistBSR)):
            if not mesh_stream:
                raise ValueError(
                    "a PackedChunk / distributed block carries a mesh "
                    "block; it needs solver='streaming' with a non-1x1 "
                    "mesh_shape")
        elif isinstance(a_chunk, StagedChunk):
            a_chunk = a_chunk.use()
        if mesh_stream and not isinstance(a_chunk, PackedChunk):
            a_chunk = self._pack_mesh_chunk(a_chunk, self._mesh())
        if not mesh_stream:
            a_chunk = self._coerce(a_chunk)
        self._check_features(a_chunk)
        n = a_chunk.shape[0]
        mc = a_chunk.m_docs if mesh_stream else a_chunk.shape[1]
        if self.u_ is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            self.u_ = init_u0(gen, n, cfg.k, device=self.device).to(
                cfg.torch_dtype)
            self.n_features_ = n
        if self._m_ref is None:
            self._m_ref = mc
        if self._gv_acc is None:
            stats = init_online_stats(n, cfg.k, self.u_.dtype, self.device)
        else:
            stats = OnlineStats(av=self._av_acc, gv=self._gv_acc)
        n_inner = max(iters if iters is not None else min(cfg.iters, 10), 1)
        if mesh_stream:
            res, self._chunk_error = self._partial_fit_sharded(
                a_chunk, stats, n_inner, forget)
        else:
            be = resolve_backend(a_chunk, cfg.backend)
            sp_u = cfg.sparsity.sparsifier(n, cfg.k, "u",
                                           fused=be.fuse_epilogue)
            sp_v = self._v_sparsity(mc).sparsifier(mc, cfg.k, "v",
                                                   fused=be.fuse_epilogue)
            res = online_als_step(a_chunk, self.u_, stats, forget,
                                  iters=n_inner, sparsify_u=sp_u,
                                  sparsify_v=sp_v, backend=be)
        self.u_, self.v_ = res.u, res.v
        self._av_acc, self._gv_acc = res.stats.av, res.stats.gv
        self.health_ = res.health
        self.n_docs_seen_ += mc
        return self

    # -- the mesh -------------------------------------------------------------

    def _mesh_streaming(self) -> bool:
        return (self.config.solver == "streaming"
                and self.config.mesh_shape != (1, 1))

    def _mesh(self):
        """This estimator's grid, made on the first call and kept.  Making
        it is collective (every rank calls ``dist.new_group``), so the
        first call comes from the main thread, before a prefetch worker
        packs for the grid (:func:`~repro_torch.nmf.solvers._make_packer`
        makes it and hands it to the worker)."""
        from repro_torch.launch.mesh import make_nmf_mesh

        if self._mesh_grid is None:
            self._mesh_grid = make_nmf_mesh(*self.config.mesh_shape,
                                            device=self.device)
        return self._mesh_grid

    def _mesh_engine(self, mesh, block):
        """The online engine on ``mesh`` for blocks like ``block``, without
        sparsifiers (its ``distribute``, ``local`` and ``backend``): one per
        inner backend, made on first use and kept.  It issues no
        collective, so the prefetch worker may call it."""
        from repro_torch.backend.sharded import make_sharded_online
        from repro_torch.nmf.solvers import mesh_inner_backend

        inner = mesh_inner_backend(self.config, block)
        engine = self._mesh_engines.get(inner)
        if engine is None:
            engine = make_sharded_online(mesh, inner=inner)
            self._mesh_engines[inner] = engine
        return engine

    def _pack_mesh_chunk(self, a_chunk, mesh, index: Optional[int] = None,
                         stream=None):
        """The host half of a mesh streaming step, runnable ahead of it (on
        the prefetcher's worker, which is why ``mesh`` is passed in, made
        on the main thread: nothing here is collective): this rank's block
        of the chunk, its columns padded to the grid with empty documents,
        ingested on the host and copied to the card on ``stream`` (a side
        stream; the consumer waits for it in :meth:`PackedChunk.use`).  The
        chunk's true document count rides along."""
        from repro_torch.data.corpus import PackedChunk

        cfg = self.config
        a_chunk = self._coerce(a_chunk, for_mesh=True)
        n, mc = a_chunk.shape
        r, c = cfg.mesh_shape
        if n % r:
            raise ValueError(
                f"term count {n} must be divisible by the mesh rows axis "
                f"{r} (mesh_shape {(r, c)})")
        engine = self._mesh_engine(mesh, a_chunk)
        dev = self.device
        block = engine.distribute(a_chunk, pad_cols_to=-(-mc // c) * c,
                                  device="cpu")
        if dev.type != "cuda":
            return PackedChunk(block, dev, index=index, m_docs=mc)
        with torch.cuda.stream(stream):
            block = block.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        return PackedChunk(block, dev, ready, index, m_docs=mc)

    def _partial_fit_sharded(self, packed, stats: OnlineStats, n_inner: int,
                             forget: float):
        """One online step on the ``config.mesh_shape`` grid: the chunk's
        columns sharded over ``"model"``, ``u`` / ``stats.av`` over
        ``"data"``, ``stats.gv`` whole; sparsity by the histogram
        :class:`~repro_torch.core.topk.DistTopK` (``t_v`` rescaled to the
        chunk's true width).  Returns the step's result, whose ``u``, ``v``
        (the padding documents' rows dropped) and ``stats`` are whole,
        gathered by ``all_reduce`` over their axes, and, with
        ``config.track_error``, the step's relative error on its own chunk,
        from the blocks (``ShardedBackend.relative_error``; else None)."""
        from repro_torch.core.online import OnlineStepResult
        from repro_torch.core.topk import DistTopK
        from repro_torch.nmf.solvers import dist_budget

        cfg = self.config
        mesh = self._mesh()
        block = packed.use()
        engine = self._mesh_engine(mesh, block)
        be = engine.backend
        n, mc_pad = block.shape
        mc = packed.m_docs
        t_u = dist_budget(cfg.sparsity, n, cfg.k, "u")
        t_v = dist_budget(self._v_sparsity(mc), mc, cfg.k, "v")
        view = engine.local(engine.distribute(block))
        rows = mesh.row_block(n)
        res = online_als_step(
            view, self.u_[rows].contiguous(),
            OnlineStats(av=stats.av[rows].contiguous(), gv=stats.gv),
            forget, iters=n_inner,
            sparsify_u=None if t_u is None else DistTopK(t_u, mesh,
                                                         ("data",)),
            sparsify_v=None if t_v is None else DistTopK(t_v, mesh,
                                                         ("model",)),
            backend=be)
        error = (be.relative_error(view, res.u, res.v, be.sqnorm(view))
                 if cfg.track_error else None)
        return OnlineStepResult(
            u=mesh.gather(res.u, n, "data"),
            v=mesh.gather(res.v, mc_pad, "model")[:mc],
            stats=OnlineStats(av=mesh.gather(res.stats.av, n, "data"),
                              gv=res.stats.gv),
            health=res.health), error

    # -- fold-in -------------------------------------------------------------

    def transform(self, a_new: ArrayLike) -> torch.Tensor:
        """Fold unseen documents into the fitted topic space, ``U`` frozen:

            V_new = top-t( relu( A_new^T U (U^T U)^{-1} ) )

        Absolute whole-factor ``t_v`` budgets are rescaled by
        ``m_new / m_train`` so per-document sparsity matches training.  The
        relu and a ``"global"`` top-t run as one fused epilogue (one
        ``relu_topk`` launch on the card, whose threshold is bitwise the
        plain bisection's, so V is the unfused epilogue's)."""
        self._check_fitted()
        a_new = self._coerce(a_new)
        self._check_features(a_new)
        u = self.u_
        return self._enforce_v(solve_gram(u.T @ u, _matmul_t(a_new, u)))

    def _v_sparsity(self, m_new: int) -> Sparsity:
        """The sparsity spec for an (m_new, k) loadings matrix."""
        sp = self.config.sparsity
        if (sp.t_v is not None and sp.mode != "columnwise"
                and self._m_ref):
            t = max(1, round(sp.t_v * m_new / self._m_ref))
            sp = dataclasses.replace(sp, t_v=t)
        return sp

    def _enforce_v(self, v: torch.Tensor) -> torch.Tensor:
        """The fold-in's epilogue on the raw loadings ``v``: relu and the
        sparsity spec, a ``"global"`` spec on f32 as one fused
        ``relu_topk``."""
        fn = self._v_sparsity(v.shape[0]).sparsifier(
            v.shape[0], v.shape[1], "v", fused=v.dtype == torch.float32)
        return _epilogue(v, fn)

    # -- evaluation ----------------------------------------------------------

    def score(self, a: ArrayLike, v: Optional[torch.Tensor] = None) -> float:
        """Relative reconstruction error ``||A - U V^T||_F / ||A||_F`` of the
        fitted factors on ``a``; ``v`` defaults to a fold-in of ``a``."""
        self._check_fitted()
        a = self._coerce(a)
        self._check_features(a)
        if v is None:
            if self.v_ is not None and self.v_.shape[0] == a.shape[1]:
                v = self.v_
            else:
                v = self.transform(a)
        return float(_relative_error(a, self.u_, v))
