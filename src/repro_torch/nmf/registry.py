"""Solver registry (port of ``repro.nmf.registry``): a solver is a callable
``(a, config, u0) -> FitResult`` registered under its ``NMFConfig.solver``
name, with the width of its default initial guess (``u0_cols``).
Registered: ``als``, ``enforced``, ``sequential`` and ``streaming``."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.nmf.result import FitResult

SolverFn = Callable[..., "FitResult"]

__all__ = ["register_solver", "get_solver", "available_solvers", "SolverEntry"]


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    name: str
    fn: SolverFn
    #: columns of the default initial guess for a config (``k``, or the
    #: sequential solver's ``block_size``)
    u0_cols: Callable[..., int] = lambda cfg: cfg.k


_REGISTRY: Dict[str, SolverEntry] = {}


def register_solver(name: str, u0_cols: Optional[Callable[..., int]] = None):
    """Decorator: ``@register_solver("als")``."""

    def deco(fn: SolverFn) -> SolverFn:
        entry = SolverEntry(name=name, fn=fn)
        if u0_cols is not None:
            entry = dataclasses.replace(entry, u0_cols=u0_cols)
        _REGISTRY[name] = entry
        return fn

    return deco


def get_solver(name: str) -> SolverEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; available: {available_solvers()}"
        ) from None


def available_solvers() -> List[str]:
    return sorted(_REGISTRY)
