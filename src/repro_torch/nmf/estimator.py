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
directory or any ``ChunkSource``).  The mesh engines are not ported yet.
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
    Matrix, _matmul, _matmul_t, _relative_error, init_u0, solve_gram,
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
        # reference document count for scaling absolute t_v budgets in
        # transform, and the streaming statistics fit seeds
        self._m_ref: Optional[int] = None
        self._av_acc: Optional[torch.Tensor] = None   # A V     (n, k)
        self._gv_acc: Optional[torch.Tensor] = None   # V^T V   (k, k)

    # -- input coercion ------------------------------------------------------

    def _coerce(self, a: ArrayLike, chunkable: bool = False) -> Matrix:
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
        the configured backend on its way to the card."""
        name = self.config.backend
        device = torch.device("cpu") if chunkable else self.device
        if chunkable and name and get_backend(name).name.startswith(
                "cuda-bsr"):
            name = "torch-csr"
        if name is None:
            if isinstance(a, (torch.Tensor, SpCSR, BSROperand)):
                return a.to(device)
            if isinstance(a, np.ndarray):
                return torch.as_tensor(a, dtype=self.config.torch_dtype,
                                       device=device)
            name = default_backend_name(a)
            if (name == "cuda-bsr"
                    and self.config.solver in ("sequential", "streaming")):
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

    def fit(self, a: ArrayLike, u0=None) -> "EnforcedNMF":
        """Factorize ``a`` with the configured solver.  ``u0`` (numpy or
        tensor, shape (n, k); the sequential solver also takes
        (n, block_size)) overrides the seeded default initial guess.

        With ``solver="streaming"``, ``a`` may be out of core: a
        :func:`~repro_torch.data.corpus.write_corpus` directory, an
        :class:`~repro_torch.data.corpus.MmapCorpus` or any ``ChunkSource``;
        chunks stream off disk, packed ahead of the step per
        ``config.prefetch``."""
        from repro_torch.data.corpus import (
            ChunkSource, as_chunk_source, is_corpus_input,
        )

        cfg = self.config
        streaming = cfg.solver == "streaming"
        if is_corpus_input(a):
            if not streaming:
                raise ValueError(
                    f"out-of-core corpora stream chunk-wise; the "
                    f"{cfg.solver!r} solver needs a resident matrix: use "
                    "solver='streaming' (or load the corpus yourself)")
            a = as_chunk_source(a, chunk_docs=cfg.chunk_docs)
        else:
            a = self._coerce(a, chunkable=streaming)
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
        if isinstance(a, ChunkSource):
            stats = self._seed_stats_streamed(a)
        else:
            stats = seed_online_stats(a, self.v_, backend=cfg.backend)
        self._av_acc, self._gv_acc = stats.av, stats.gv
        return self

    def _seed_stats_streamed(self, source) -> OnlineStats:
        """Full-corpus statistics ``(A V, V^T V)`` from a chunk source, one
        chunk resident at a time: each chunk adds ``A_c V_c`` with its rows
        of the fitted loadings.  The chunks come through the streaming
        solver's packer, prefetched per ``config.prefetch``."""
        from repro_torch.data.corpus import Prefetcher
        from repro_torch.nmf.solvers import _make_packer

        cfg = self.config
        v = self.v_
        av = None
        with Prefetcher(range(len(source.schedule)),
                        _make_packer(self, source),
                        depth=cfg.prefetch_depth,
                        enabled=cfg.prefetch) as stream:
            for (lo, hi), staged in zip(source.schedule, stream):
                part = _matmul(staged.use(), v[lo:hi], cfg.backend)
                av = part if av is None else av + part
        return OnlineStats(av=av, gv=v.T @ v)

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
        and two ``relu_topk`` epilogues; nothing waits for the host."""
        from repro_torch.data.corpus import StagedChunk

        if not 0.0 < forget <= 1.0:
            raise ValueError(f"forget must be in (0, 1], got {forget}")
        cfg = self.config
        if isinstance(a_chunk, StagedChunk):
            a_chunk = a_chunk.use()
        a_chunk = self._coerce(a_chunk)
        self._check_features(a_chunk)
        n, mc = a_chunk.shape
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
        be = resolve_backend(a_chunk, cfg.backend)
        sp_u = cfg.sparsity.sparsifier(n, cfg.k, "u", fused=be.fuse_epilogue)
        sp_v = self._v_sparsity(mc).sparsifier(mc, cfg.k, "v",
                                               fused=be.fuse_epilogue)
        res = online_als_step(a_chunk, self.u_, stats, forget, iters=n_inner,
                              sparsify_u=sp_u, sparsify_v=sp_v, backend=be)
        self.u_, self.v_ = res.u, res.v
        self._av_acc, self._gv_acc = res.stats.av, res.stats.gv
        self.health_ = res.health
        self.n_docs_seen_ += mc
        return self

    # -- fold-in -------------------------------------------------------------

    def transform(self, a_new: ArrayLike) -> torch.Tensor:
        """Fold unseen documents into the fitted topic space, ``U`` frozen:

            V_new = top-t( relu( A_new^T U (U^T U)^{-1} ) )

        Absolute whole-factor ``t_v`` budgets are rescaled by
        ``m_new / m_train`` so per-document sparsity matches training."""
        self._check_fitted()
        a_new = self._coerce(a_new)
        self._check_features(a_new)
        u = self.u_
        v = solve_gram(u.T @ u, _matmul_t(a_new, u))
        return self._enforce_v(torch.clamp_min(v, 0.0))

    def _v_sparsity(self, m_new: int) -> Sparsity:
        """The sparsity spec for an (m_new, k) loadings matrix."""
        sp = self.config.sparsity
        if (sp.t_v is not None and sp.mode != "columnwise"
                and self._m_ref):
            t = max(1, round(sp.t_v * m_new / self._m_ref))
            sp = dataclasses.replace(sp, t_v=t)
        return sp

    def _enforce_v(self, v: torch.Tensor) -> torch.Tensor:
        return self._v_sparsity(v.shape[0]).apply(v, "v")

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
