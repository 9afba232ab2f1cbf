"""Estimator configuration: ``Sparsity`` and ``NMFConfig`` (port of
``repro.nmf.config``, first slice).

A ``Sparsity`` describes what to enforce (budgets, absolute or as a
fraction of the dense factor, globally or per column, by bisection or exact
sort); an ``NMFConfig`` describes the run.  Fields of the reference that
select code the port has not ported yet (the distributed solver, mesh
shapes) are absent; rollback and checkpointing are present, and a config
that asks for them raises ``NotImplementedError`` rather than being
ignored.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.core import topk

__all__ = ["Sparsity", "NMFConfig"]

_MODES = ("global", "exact", "columnwise")


@dataclasses.dataclass(frozen=True)
class Sparsity:
    """Top-t enforcement spec for the two factors (paper Alg. 2 / §4).

    * ``t_u`` / ``t_v`` — absolute nonzero budgets (per column in
      ``columnwise`` mode, for the whole factor otherwise).
    * ``frac_u`` / ``frac_v`` — budget as a fraction of the dense factor.
    * ``mode`` — ``"global"`` (bisection threshold), ``"exact"`` (sort) or
      ``"columnwise"``.
    * ``num_steps`` — bisection steps for ``"global"`` mode.
    """

    t_u: Optional[int] = None
    t_v: Optional[int] = None
    frac_u: Optional[float] = None
    frac_v: Optional[float] = None
    mode: str = "global"
    num_steps: int = 40

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.t_u is not None and self.frac_u is not None:
            raise ValueError("give at most one of t_u / frac_u")
        if self.t_v is not None and self.frac_v is not None:
            raise ValueError("give at most one of t_v / frac_v")
        for name in ("frac_u", "frac_v"):
            f = getattr(self, name)
            if f is not None and not (0.0 < f <= 1.0):
                raise ValueError(f"{name} must be in (0, 1], got {f}")

    def resolve(self, rows: int, k: int, which: str) -> Optional[int]:
        """Absolute budget for one factor of shape ``(rows, k)``; ``None``
        leaves it dense."""
        t = self.t_u if which == "u" else self.t_v
        frac = self.frac_u if which == "u" else self.frac_v
        if t is None and frac is None:
            return None
        if t is None:
            dense = rows if self.mode == "columnwise" else rows * k
            t = max(int(dense * frac), 1)
        cap = rows if self.mode == "columnwise" else rows * k
        return min(int(t), cap)

    def sparsifier(self, rows: int, k: int, which: str, fused: bool = False
                   ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
        """Callable enforcing this spec on a ``(rows, k)`` factor, ``None``
        for no enforcement.  ``fused=True`` (``"global"`` mode only) gives
        the whole relu + top-t epilogue, one ``relu_topk`` launch on the
        card (bisection and mask together)."""
        t = self.resolve(rows, k, which)
        if t is None:
            return None
        if self.mode == "columnwise":
            return functools.partial(topk.topk_project_columns, t_per_col=t)
        if self.mode == "exact":
            return functools.partial(topk.topk_project_exact, t=t)
        if fused:
            return topk.FusedReluTopK(t=t, num_steps=self.num_steps)
        return functools.partial(topk.topk_project_bisect, t=t,
                                 num_steps=self.num_steps)

    def apply(self, x: torch.Tensor, which: str) -> torch.Tensor:
        """Enforce this spec on a concrete factor (``transform``)."""
        fn = self.sparsifier(x.shape[0], x.shape[1], which)
        return x if fn is None else fn(x)


@dataclasses.dataclass(frozen=True)
class NMFConfig:
    """One factorization run: ``A (n x m) ~= U (n x k) @ V (m x k)^T``.

    * ``k``, ``iters`` (per block for ``"sequential"``), ``sparsity``,
      ``solver`` (``"als"``, ``"enforced"``, ``"sequential"`` or
      ``"streaming"``), ``dtype``, ``tol`` (early stop on the relative
      residual; 0 disables), ``seed`` (default initial guess),
      ``track_error`` — as in the reference.
    * ``backend`` — ``"cuda-bsr"``, ``"cuda-bsr-unfused"``, ``"torch-csr"``,
      ``"torch-dense"`` or a reference alias; ``None`` selects from the
      input (scipy sparse -> ``cuda-bsr``, ``SpCSR`` -> ``torch-csr``).  The
      sequential solver takes no BSR backend.
    * ``block_size`` — topic-block width of the ``"sequential"`` solver
      (must divide ``k``).
    * ``chunk_docs`` — documents per column chunk of the ``"streaming"``
      solver (``None``: 8 chunks); ``prefetch`` / ``prefetch_depth`` —
      pack the next chunks on a worker thread (ingest, and on the card the
      copy on a side stream), at most ``prefetch_depth`` ahead; the fit is
      bitwise the same with prefetch off.
    * ``on_unhealthy`` — ``"raise"`` (the default here) fails with
      ``FitHealthError`` when the health monitor flags the fit; ``"ignore"``
      keeps the non-finite factors.  ``"rollback"`` (the reference's
      default) and ``checkpoint_dir`` / ``resume`` are not ported yet and
      raise ``NotImplementedError``.
    """

    k: int = 5
    iters: int = 75
    sparsity: Sparsity = dataclasses.field(default_factory=Sparsity)
    solver: str = "enforced"
    dtype: str = "float32"
    backend: Optional[str] = None
    tol: float = 0.0
    seed: int = 0
    track_error: bool = True
    block_size: int = 1
    chunk_docs: Optional[int] = None
    prefetch: bool = True
    prefetch_depth: int = 2
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    on_unhealthy: str = "raise"

    def __post_init__(self):
        if self.k <= 0:
            raise ValueError(f"k must be positive, got {self.k}")
        if self.iters <= 0:
            raise ValueError(f"iters must be positive, got {self.iters}")
        if self.solver == "sequential" and self.k % self.block_size:
            raise ValueError(
                f"block_size ({self.block_size}) must divide k ({self.k})")
        if self.backend is not None:
            from repro_torch.backend import available_backends, get_backend

            if self.backend not in available_backends():
                raise ValueError(
                    f"unknown backend {self.backend!r}; "
                    f"available: {available_backends()}")
            if (get_backend(self.backend).name.startswith("cuda-bsr")
                    and self.solver == "sequential"):
                raise ValueError(
                    f"backend {self.backend!r} is not supported by the "
                    "sequential solver; use als/enforced/streaming")
        if self.chunk_docs is not None and self.chunk_docs <= 0:
            raise ValueError(
                f"chunk_docs must be positive, got {self.chunk_docs}")
        if self.prefetch_depth <= 0:
            raise ValueError(
                f"prefetch_depth must be positive, got {self.prefetch_depth}")
        if self.on_unhealthy not in ("rollback", "raise", "ignore"):
            raise ValueError(
                f"on_unhealthy must be 'rollback', 'raise', or 'ignore', "
                f"got {self.on_unhealthy!r}")
        if self.on_unhealthy == "rollback":
            raise NotImplementedError(
                "on_unhealthy='rollback' is not ported yet; use 'raise' or "
                "'ignore'")
        if self.checkpoint_dir is not None or self.resume:
            raise NotImplementedError(
                "checkpointing and resume are not ported yet")
        if not isinstance(getattr(torch, self.dtype, None), torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **changes) -> "NMFConfig":
        return dataclasses.replace(self, **changes)
