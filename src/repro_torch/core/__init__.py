"""Core of the port: projected ALS NMF with enforced sparsity, its online
and sequential engines (port of ``repro.core``)."""
from repro_torch.core import metrics, topk
from repro_torch.core.enforced import (
    columnwise_topt, enforced_sparsity_nmf, global_topt, global_topt_exact,
)
from repro_torch.core.nmf import NMFResult, als_nmf, init_u0, solve_gram
from repro_torch.core.online import (
    OnlineStats, OnlineStepResult, init_online_stats, online_als_step,
    seed_online_stats,
)
from repro_torch.core.sequential import SequentialResult, sequential_als_nmf

__all__ = ["NMFResult", "OnlineStats", "OnlineStepResult",
           "SequentialResult", "als_nmf", "columnwise_topt",
           "enforced_sparsity_nmf", "global_topt", "global_topt_exact",
           "init_online_stats", "init_u0", "metrics", "online_als_step",
           "seed_online_stats", "sequential_als_nmf", "solve_gram", "topk"]
