"""Solver registry (port of ``repro.nmf.registry``): a solver is a callable
``(a, config, u0) -> FitResult`` registered under its ``NMFConfig.solver``
name.  Registered in this slice: ``als`` and ``enforced``."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.nmf.result import FitResult

SolverFn = Callable[..., "FitResult"]

__all__ = ["register_solver", "get_solver", "available_solvers", "SolverEntry"]


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    name: str
    fn: SolverFn


_REGISTRY: Dict[str, SolverEntry] = {}


def register_solver(name: str):
    """Decorator: ``@register_solver("als")``."""

    def deco(fn: SolverFn) -> SolverFn:
        _REGISTRY[name] = SolverEntry(name=name, fn=fn)
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
