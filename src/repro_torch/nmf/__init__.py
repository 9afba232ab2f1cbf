"""Estimator front door of the port (port of ``repro.nmf``)::

    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity

    model = EnforcedNMF(NMFConfig(k=5, sparsity=Sparsity(t_u=55)))
    model.fit(a)                  # on the card; device="cpu" to ask for CPU
    v_new = model.transform(a2)   # fold-in: topic inference, U frozen
    model.partial_fit(a3)         # online update with new documents

``solver="streaming"`` fits a corpus chunk by chunk (also from a
``write_corpus`` directory), ``solver="sequential"`` one topic block at a
time (paper Alg. 3).
"""
from repro_torch.nmf.config import NMFConfig, Sparsity
from repro_torch.nmf.estimator import EnforcedNMF
from repro_torch.nmf.registry import available_solvers, get_solver, register_solver
from repro_torch.nmf.result import FitResult
from repro_torch.nmf import solvers as _solvers  # noqa: F401 — registers solvers
from repro_torch.nmf.solvers import FitHealthError, default_chunk_docs

__all__ = [
    "EnforcedNMF", "NMFConfig", "Sparsity", "FitResult", "FitHealthError",
    "default_chunk_docs", "register_solver", "get_solver",
    "available_solvers",
]
