"""The port's ``lax.scan`` (:func:`scan`) and the hooks through which a
counting dispatch mode sees the port's loops and hand-written kernels.

Nothing here counts anything by itself: the models' loops call
:func:`scan` and the kernels' meta branches call :func:`record_kernel`,
and both only talk to the innermost :class:`CountingMode` in force, if
any.  The dry-run's counter (``launch.cost_analysis.CostMode``) is one.

**Loops.**  :func:`scan` runs every step, except under a
:class:`CountingMode` with ``scale_loops``, where one step stands for the
steps like it (:meth:`CountingMode.repeat` counts what runs inside as that
many times).  Without autograd that is the first step for all; with it the
first step runs apart (its carry may need no gradient where the later ones
do), and so does the last when the carry links the steps through autograd
(no next step reads its carry).  Only a loop whose every step has the same
shapes may use it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

__all__ = ["CountingMode", "active", "record_kernel", "scan", "tensors"]


def tensors(tree) -> List[torch.Tensor]:
    """The tensors in ``tree`` (dicts, lists, tuples, dataclasses such as
    an operand, modules' parameters), depth first.  Iterative: a recursive
    closure would hold the list in a reference cycle and keep its tensors
    alive until the next garbage collection."""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, torch.nn.Module):
            stack.extend(reversed(list(x.parameters())))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(reversed([getattr(x, f.name)
                                   for f in dataclasses.fields(x)]))
    return out


class CountingMode(TorchDispatchMode):
    """A dispatch mode that counts what runs under it: what :func:`scan`
    and :func:`record_kernel` need of it.  ``scale_loops`` lets
    :func:`scan` run a loop's body once and count it for every step."""

    scale_loops: bool = False

    def repeat(self, n: int) -> contextlib.AbstractContextManager:
        """A context in which what runs counts as ``n`` times; it yields a
        list to which the caller adds the tensors that stand for one copy
        only (a loop's carry, which each step replaces)."""
        raise NotImplementedError

    def record_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One launch of hand-written kernel ``name``, its useful FLOPs and
        the bytes it must move."""
        raise NotImplementedError


def active() -> Optional[CountingMode]:
    """The innermost :class:`CountingMode` in force, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CountingMode):
            return mode
    return None


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """Count one launch of hand-written kernel ``name`` doing ``flops``
    useful FLOPs and moving ``nbytes`` (its meta branch calls this); a
    no-op outside a :class:`CountingMode`."""
    mode = active()
    if mode is not None:
        mode.record_kernel(name, flops, nbytes)


class _Tile(torch.autograd.Function):
    """The steps that ran stood in for all of a scaled loop's: forward the
    same ``stack`` the full loop makes (each part repeated ``counts``
    times, in order), backward each part's first slice (the repeated
    part's backward is counted by the mode)."""

    @staticmethod
    def forward(ctx, dim, counts, *parts):
        ctx.dim = dim
        ctx.starts = [sum(counts[:i]) for i in range(len(counts))]
        return torch.stack([p for p, c in zip(parts, counts)
                            for _ in range(c)], dim)

    @staticmethod
    def backward(ctx, g):
        return (None, None) + tuple(g.select(ctx.dim, i)
                                    for i in ctx.starts)


def _shapes(tree) -> list:
    return [(tuple(t.shape), t.dtype) for t in tensors(tree)]


def scan(body: Callable, carry: Any, xs: Sequence, dim: int = 0
         ) -> Tuple[Any, Optional[torch.Tensor]]:
    """The counterpart of ``lax.scan``: ``carry, y = body(carry, x)`` for
    each ``x`` of ``xs`` in order; returns the last carry and the steps'
    ``y`` stacked along ``dim`` (None when the body returns None).

    Every step runs, except under a :class:`CountingMode` with
    ``scale_loops``, where one step stands for the ones like it and the
    stacked output has the full loop's shape:

    * without autograd every step costs the same: the first stands for
      all;
    * with it, the first runs as it is (its carry may need no gradient
      where the later ones do); if its carry then needs none, the steps
      are not linked through autograd and the second stands for the rest;
      else the second stands for the middle ones and the last runs as it
      is (no next step reads its carry).

    Every step must take and give the same shapes."""
    xs = list(xs)
    n = len(xs)
    mode = active()
    if mode is None or not mode.scale_loops or n <= 3:
        ys = []
        for x in xs:
            carry, y = body(carry, x)
            if y is not None:
                ys.append(y)
        return carry, (torch.stack(ys, dim) if ys else None)
    before = _shapes(carry)
    parts = []
    if not torch.is_grad_enabled():
        with mode.repeat(n) as once:
            carry, y = body(carry, xs[0])
            once.append(carry)
        parts.append((y, n))
    else:
        carry, y = body(carry, xs[0])
        parts.append((y, 1))
        if not any(t.requires_grad for t in tensors(carry)):
            with mode.repeat(n - 1) as once:
                carry, y = body(carry, xs[1])
                once.append(carry)
            parts.append((y, n - 1))
        else:
            # under autograd the next step saves each carry: no `once`
            with mode.repeat(n - 2):
                carry, y = body(carry, xs[1])
            parts.append((y, n - 2))
            carry, y = body(carry, xs[-1])
            parts.append((y, 1))
    if _shapes(carry) != before:
        raise ValueError(f"scan: the carry changed shape in a step "
                         f"({before} -> {_shapes(carry)}); a scaled loop "
                         "needs steps of one shape")
    if parts[0][0] is None:
        return carry, None
    return carry, _Tile.apply(dim, [c for _, c in parts],
                              *[y for y, _ in parts])
