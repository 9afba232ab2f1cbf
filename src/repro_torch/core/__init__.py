"""Core of the port: projected ALS NMF with enforced sparsity (port of
``repro.core``, first slice)."""
from repro_torch.core import metrics, topk
from repro_torch.core.nmf import NMFResult, als_nmf, init_u0, solve_gram
from repro_torch.core.online import OnlineStats, seed_online_stats

__all__ = ["NMFResult", "OnlineStats", "als_nmf", "init_u0", "metrics",
           "seed_online_stats", "solve_gram", "topk"]
