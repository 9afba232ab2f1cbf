"""Fit history (port of ``repro.nmf.result``): one result type for every
solver.

``residual`` is a flat trace: per iteration for the ALS family, the
per-block traces concatenated in block order for ``"sequential"``, one
entry per document chunk for ``"streaming"``.  ``error`` is per iteration,
per converged block or per chunk; ``error_granularity`` says which.  Traces
stay device tensors; reading a ``final_*`` property copies one value to the
host.  The port also keeps the engine's health index, which the reference
folds into its rollback loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.nmf import NMFResult
from repro_torch.core.sequential import SequentialResult

__all__ = ["FitResult"]


@dataclasses.dataclass(frozen=True)
class FitResult:
    """Factors plus per-iteration convergence history."""

    u: torch.Tensor                   # (n, k)
    v: torch.Tensor                   # (m, k)
    residual: torch.Tensor            # (n_iter,)
    error: torch.Tensor               # (n_iter,)
    max_nnz: torch.Tensor             # scalar
    solver: str
    n_iter: int
    converged: bool = False           # early-stop tolerance was reached
    nnz_u: Optional[torch.Tensor] = None
    nnz_v: Optional[torch.Tensor] = None
    #: first unhealthy iteration (0-d int32 tensor), -1 when healthy
    health: Optional[torch.Tensor] = None
    error_granularity: str = "iteration"   # "iteration" | "block" | "chunk"
    #: a streamed fit's host-side packing: the ``Prefetcher.stats`` of its
    #: factor pass (``"fit"``) and of its fold-in pass (``"fold_in"``)
    stream_stats: Optional[dict] = None

    @property
    def final_error(self) -> float:
        return float(self.error[-1])

    @property
    def final_residual(self) -> float:
        return float(self.residual[-1])

    @property
    def final_nnz_u(self) -> int:
        if self.nnz_u is not None:
            return int(self.nnz_u[-1])
        return int(torch.sum(self.u != 0))

    @property
    def final_nnz_v(self) -> int:
        if self.nnz_v is not None:
            return int(self.nnz_v[-1])
        return int(torch.sum(self.v != 0))

    @classmethod
    def from_nmf_result(cls, res: NMFResult, solver: str,
                        converged: bool = False) -> "FitResult":
        return cls(
            u=res.u, v=res.v, residual=res.residual, error=res.error,
            max_nnz=res.max_nnz, solver=solver,
            n_iter=int(res.residual.shape[0]), converged=converged,
            nnz_u=res.nnz_u, nnz_v=res.nnz_v, health=res.health,
        )

    @classmethod
    def from_sequential_result(cls, res: SequentialResult,
                               solver: str = "sequential") -> "FitResult":
        residual = res.residual.reshape(-1)
        return cls(
            u=res.u, v=res.v, residual=residual, error=res.error,
            max_nnz=res.max_nnz, solver=solver,
            n_iter=int(residual.shape[0]), error_granularity="block",
        )

    @classmethod
    def concatenate(cls, parts: list["FitResult"],
                    converged: bool = False) -> "FitResult":
        """Stitch chunked runs (early stop) into one history; factors come
        from the last chunk, the health index counts from the first."""
        if len(parts) == 1:
            return dataclasses.replace(parts[0], converged=converged)
        last = parts[-1]
        cat = lambda field: torch.cat([getattr(p, field) for p in parts])
        health, offset = parts[0].health, 0
        for p in parts:
            if p is not parts[0]:
                health = torch.where((health < 0) & (p.health >= 0),
                                     p.health + offset, health)
            offset += p.n_iter
        return cls(
            u=last.u, v=last.v,
            residual=cat("residual"), error=cat("error"),
            max_nnz=torch.max(torch.stack([p.max_nnz for p in parts])),
            solver=last.solver, n_iter=sum(p.n_iter for p in parts),
            converged=converged, nnz_u=cat("nnz_u"), nnz_v=cat("nnz_v"),
            health=health, error_granularity=last.error_granularity,
        )
