"""``EnforcedNMF`` — the estimator front door (port of
``repro.nmf.estimator``, first slice: ``fit``, ``fit_transform``,
``transform`` and ``score``).

    A (n_terms x m_docs)  ~=  U (n_terms x k) @ V (m_docs x k)^T

``fit`` dispatches through the solver registry; ``transform`` folds unseen
documents into the fitted topic space with ``U`` frozen.  The estimator
runs on ``device`` — the card unless the caller passes ``device="cpu"``; a
missing card is an error, never a silent CPU run.

Inputs may be dense tensors / numpy arrays, padded-CSR ``SpCSR``, a
``BSROperand`` or scipy sparse matrices (converted at ingest, never
densified on the kernel path).  ``partial_fit`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.backend import BSROperand, default_backend_name, get_backend
from repro_torch.core.nmf import (
    Matrix, _matmul_t, _relative_error, init_u0, solve_gram,
)
from repro_torch.core.online import seed_online_stats
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
    (:class:`FitResult`), ``n_iter_``, ``n_features_``, ``n_docs_seen_``.
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
        # reference document count for scaling absolute t_v budgets in
        # transform, and the streaming statistics fit seeds
        self._m_ref: Optional[int] = None
        self._av_acc: Optional[torch.Tensor] = None   # A V     (n, k)
        self._gv_acc: Optional[torch.Tensor] = None   # V^T V   (k, k)

    # -- input coercion ------------------------------------------------------

    def _coerce(self, a: ArrayLike) -> Matrix:
        """Ingest ``a`` for ``config.backend`` on this estimator's device.

        With no explicit backend, tensors and ``BSROperand`` keep their
        format, sparse input (scipy, ``SpCSR``) goes to ``cuda-bsr``, and
        numpy input becomes a dense tensor.  An explicit backend converts
        whatever comes in to its operand; numpy / scipy input is cast to
        ``config.dtype``."""
        name = self.config.backend
        if name is None:
            if isinstance(a, (torch.Tensor, BSROperand)):
                return a.to(self.device)
            if isinstance(a, np.ndarray):
                return torch.as_tensor(a, dtype=self.config.torch_dtype,
                                       device=self.device)
            name = default_backend_name(a)
        native = isinstance(a, (SpCSR, BSROperand, torch.Tensor))
        return get_backend(name).prepare(
            a, dtype=None if native else self.config.torch_dtype,
            device=self.device)

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
        tensor, shape (n, k)) overrides the seeded default initial guess."""
        cfg = self.config
        a = self._coerce(a)
        n, m = a.shape
        entry = get_solver(cfg.solver)
        if u0 is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            u0 = init_u0(gen, n, cfg.k, device=self.device)
        u0 = self._factor(u0)
        result = entry.fn(a, cfg, u0)
        self.u_, self.v_, self.result_ = result.u, result.v, result
        self.n_iter_ = result.n_iter
        self.n_features_ = n
        self.n_docs_seen_ = m
        self._m_ref = m
        # seed streaming statistics so a later partial_fit continues from
        # this fit: one more half-step product, instead of pinning the corpus
        stats = seed_online_stats(a, self.v_, backend=cfg.backend)
        self._av_acc, self._gv_acc = stats.av, stats.gv
        return self

    def fit_transform(self, a: ArrayLike, u0=None) -> torch.Tensor:
        """Fit and return the document-topic loadings ``V`` (m, k)."""
        return self.fit(a, u0=u0).v_

    def partial_fit(self, *args, **kwargs):
        raise NotImplementedError(
            "partial_fit (the online engine) is not ported yet")

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
