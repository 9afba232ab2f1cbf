"""Runtime guards: the allocator's ground truth and the port's compile
counter (port of ``repro.analysis.runtime``).

``memory_guard(fn, *args)`` runs ``fn(*args)`` once and returns a
:class:`MemoryReport` with the reference's fields:

* on the card, the CUDA caching allocator's own accounting:
  ``reset_peak_memory_stats``, the call, then ``max_memory_allocated``
  less what was resident before it (the call's own peak), beside the
  bytes of the arguments and of the outputs;
* on ``meta``, ``launch.cost_analysis.CostMode``'s (``ir.liveness``:
  the arguments tracked, every storage's life seen), the number the IR
  peak-memory pass gates.

``peak_bytes`` is comparable between the two (the arguments plus the
largest sum of what the call made), which is how ``chip_smoke.py``
phase 27 holds the ``meta`` planner against the card.  A ``max_temp_bytes``
budget on the call's own scratch raises :class:`MemoryBudgetError`.  On
the CPU there is no allocator to read: the report says so
(``supported=False``), or the guard raises unless ``allow_unsupported``.

``recompile_guard(max_compiles=0)``: the port's only compilations are the
``nvcc`` builds of its CUDA sources, started at first use by
``kernels/_build.py::_start_build`` (eager PyTorch has no executable
cache).  The guard counts every build started inside the block, in this
process only, and raises :class:`RecompilationError` above the limit::

    with recompile_guard():              # a second identical fit
        model.fit(a)                     # builds nothing
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional

__all__ = ["recompile_guard", "CompilationCounter", "RecompilationError",
           "memory_guard", "MemoryReport", "MemoryBudgetError"]


class RecompilationError(AssertionError):
    """More kernel builds happened inside a guard than allowed."""


@dataclasses.dataclass
class CompilationCounter:
    """Live tally of the ``nvcc`` builds started inside a guard (the
    sources built)."""

    count: int = 0
    events: List[str] = dataclasses.field(default_factory=list)

    def _observe(self, event: str) -> None:
        self.count += 1
        self.events.append(event)


@contextlib.contextmanager
def recompile_guard(max_compiles: int = 0) -> Iterator[CompilationCounter]:
    """Fail if the block starts more than ``max_compiles`` kernel builds.

    Yields the :class:`CompilationCounter` so callers can also assert
    exact counts or see which sources were built.  The builds are counted
    by wrapping ``kernels._build._start_build`` for the block (a build is
    a call that returns its started ``nvcc``; an already-built library
    returns None),
    so only this process's builds count.  The check runs at block exit; an
    exception already propagating wins over the guard's own error.
    """
    from repro_torch.kernels import _build

    counter = CompilationCounter()
    inner = _build._start_build

    def counting(source):
        proc = inner(source)
        if proc is not None:
            counter._observe(getattr(source, "name", str(source)))
        return proc

    _build._start_build = counting
    try:
        yield counter
    finally:
        _build._start_build = inner
    if counter.count > max_compiles:
        raise RecompilationError(
            f"{counter.count} kernel build(s) ({', '.join(counter.events)}) "
            f"inside a recompile_guard(max_compiles={max_compiles}) block — "
            "an edited or unbuilt CUDA source was compiled where none was "
            "expected")


# ---------------------------------------------------------------------------
# memory_guard: the allocator's (or the meta planner's) byte accounting
# ---------------------------------------------------------------------------

class MemoryBudgetError(AssertionError):
    """A call's own scratch exceeds the stated budget."""


@dataclasses.dataclass(frozen=True)
class MemoryReport:
    """What one call held, in bytes."""

    supported: bool
    temp_bytes: int = 0        # scratch the call allocated beyond outputs
    argument_bytes: int = 0    # inputs held live across the call
    output_bytes: int = 0
    alias_bytes: int = 0       # outputs that are arguments' storage
    generated_code_bytes: int = 0
    reason: Optional[str] = None  # why unsupported, when it is
    device: Optional[str] = None  # "cuda" or "meta"

    @property
    def peak_bytes(self) -> int:
        """Everything the call holds at once: the IR planner's peak on
        meta, the arguments plus the allocator's added peak on the card."""
        return (self.temp_bytes + self.argument_bytes + self.output_bytes
                - self.alias_bytes)


def _device_of(args, kwargs):
    from repro_torch.scan import tensors

    devs = {t.device.type for t in tensors((args, kwargs))}
    return devs.pop() if len(devs) == 1 else None


def memory_guard(fn, *args, max_temp_bytes: Optional[int] = None,
                 allow_unsupported: bool = False, **kwargs) -> MemoryReport:
    """Run ``fn(*args, **kwargs)`` once and return its
    :class:`MemoryReport` (see the module's docstring); raise
    :class:`MemoryBudgetError` if its scratch exceeds ``max_temp_bytes``.
    The arguments must all lie on one device: the card or ``meta``."""
    from repro_torch.launch.cost_analysis import tree_bytes

    dev = _device_of(args, kwargs)
    if dev == "meta":
        from repro_torch.analysis.ir.liveness import counted_run

        traced = counted_run(fn, args, kwargs)
        args_b, out_b = traced.input_bytes, traced.output_bytes
        temp = max(int(traced.mode.peak_bytes) - args_b - out_b, 0)
        report = MemoryReport(True, temp_bytes=temp, argument_bytes=args_b,
                              output_bytes=out_b, device="meta")
    elif dev == "cuda":
        import torch

        from repro_torch.scan import tensors

        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        added = torch.cuda.max_memory_allocated() - resident
        args_b, out_b = tree_bytes((args, kwargs)), tree_bytes(out)
        held = {t.untyped_storage()._cdata for t in tensors((args, kwargs))}
        alias = tree_bytes([t for t in tensors(out)
                            if t.untyped_storage()._cdata in held])
        del out
        report = MemoryReport(True, temp_bytes=max(added - out_b + alias, 0),
                              argument_bytes=args_b, output_bytes=out_b,
                              alias_bytes=alias, device="cuda")
    else:
        why = (f"arguments on {dev}: no allocator to read" if dev else
               "arguments on several devices")
        if allow_unsupported:
            return MemoryReport(False, reason=why)
        raise RuntimeError(f"memory_guard reads the card's allocator or the "
                           f"meta planner; {why} (pass allow_unsupported="
                           "True to degrade, and skip the assertion "
                           "yourself)")
    if max_temp_bytes is not None and report.temp_bytes > max_temp_bytes:
        raise MemoryBudgetError(
            f"the call allocates {report.temp_bytes} bytes of scratch, over "
            f"the {max_temp_bytes}-byte budget — a densified intermediate, "
            "most likely")
    return report

