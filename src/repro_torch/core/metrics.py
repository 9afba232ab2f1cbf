"""Paper metrics (port of ``repro.core.metrics``): relative residual,
relative error, clustering accuracy (Eq. 3.3) and NNZ tracking (Fig. 6)."""
from __future__ import annotations

import torch

__all__ = [
    "relative_residual",
    "relative_error",
    "relative_error_sparse",
    "clustering_accuracy",
    "mean_clustering_accuracy",
    "max_nnz_tracker",
]


def relative_residual(u_new: torch.Tensor, u_old: torch.Tensor
                      ) -> torch.Tensor:
    """R = ||U_i - U_{i-1}||_F / ||U_i||_F  (paper §3.1)."""
    denom = torch.linalg.norm(u_new)
    return torch.linalg.norm(u_new - u_old) / torch.clamp_min(denom, 1e-30)


def relative_error(a: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """E = ||A - U V^T||_F / ||A||_F  (paper §3.1), dense A."""
    return (torch.linalg.norm(a - u @ v.T)
            / torch.clamp_min(torch.linalg.norm(a), 1e-30))


def relative_error_sparse(a_vals, a_rows, a_cols, a_sqnorm, u, v
                          ) -> torch.Tensor:
    """E for sparse COO A without densifying A - UV^T:
    ||A - UV^T||^2 = ||A||^2 - 2<A, UV^T> + <U^T U, V^T V>."""
    dots = torch.sum(u[a_rows] * v[a_cols], dim=-1)
    cross = torch.sum(a_vals * dots)
    approx_sq = torch.sum((u.T @ u) * (v.T @ v))
    err_sq = torch.clamp_min(a_sqnorm - 2.0 * cross + approx_sq, 0.0)
    return torch.sqrt(err_sq) / torch.sqrt(torch.clamp_min(a_sqnorm, 1e-30))


def clustering_accuracy(doc_journal: torch.Tensor, belongs: torch.Tensor,
                        n_journals: int) -> torch.Tensor:
    """Pair-counting accuracy of one topic (paper Eq. 3.3); topics with
    nD <= 1 score 1."""
    n_d = torch.sum(belongs).to(torch.int32)
    counts = torch.zeros(n_journals, dtype=torch.int32,
                         device=belongs.device)
    counts.index_add_(0, doc_journal.long(), belongs.to(torch.int32))
    same = torch.sum(counts * (counts - 1) // 2).float()
    q, r = n_d // n_journals, n_d % n_journals
    alpha = (q * (n_journals * (q - 1) / 2.0 + r)).float()
    beta = (n_d * (n_d - 1) / 2.0).float()
    acc = (same - alpha) / torch.clamp_min(beta - alpha, 1e-30)
    return torch.where(n_d <= 1, torch.ones_like(acc), acc)


def mean_clustering_accuracy(doc_journal: torch.Tensor, v: torch.Tensor,
                             n_journals: int) -> torch.Tensor:
    """Average Eq. 3.3 accuracy over the k topics (columns of V)."""
    belongs = (v != 0).T
    return torch.stack([clustering_accuracy(doc_journal, b, n_journals)
                        for b in belongs]).mean()


def max_nnz_tracker(running_max: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Track max combined NNZ(U)+NNZ(V) seen so far (paper Fig. 6)."""
    return torch.maximum(running_max, torch.sum(u != 0) + torch.sum(v != 0))
