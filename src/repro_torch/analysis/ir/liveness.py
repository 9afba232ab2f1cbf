"""Peak live bytes of a call on the ``meta`` device (port of
``repro.analysis.ir.liveness``).

The reference walks a jaxpr with last-use freeing.  The port has no
jaxpr, and needs none: a call run on ``meta`` under
``launch.cost_analysis.CostMode`` dispatches every op, and the mode sees
every storage the call makes and, by a weak reference, the moment it dies.
So the peak is not an estimate of an allocator's plan but the sum of the
live storages at their largest, in the order the eager port really frees
them (:func:`counted_run`):

* the arguments are tracked first (``CostMode.track``), live throughout
  (the caller holds them);
* the mode keeps the op and the port's source line at the peak
  (``peak_op`` / ``peak_source``, the reference's ``peak_eqn`` /
  ``peak_source``) and the largest single op result (the dense-blowup
  detector's candidate);
* a hand-written kernel's meta branch allocates its outputs only: its
  working set lives in the card's shared memory, not in its memory.

It is deterministic — the same call gives the same bytes on any machine:
meta storages have no allocator rounding, no address enters the count, and
the garbage collector is held off during the run so that storages die by
reference count alone.  The CUDA caching allocator rounds each block up to
512 bytes, so a call of many tiny tensors measures above this count on the
card; at data sizes the two agree (``chip_smoke.py`` phases 26 and 27 hold
them within 10%).
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any, Optional

__all__ = ["Traced", "PeakReport", "counted_run", "peak_report",
           "peak_live_bytes"]


@dataclasses.dataclass
class Traced:
    """What one run of a call on meta left: the counting mode (costs,
    peak, peak op and source, largest op result, collectives by group),
    and the bytes of the arguments it tracked and of its outputs."""

    mode: Any
    input_bytes: int
    output_bytes: int


@dataclasses.dataclass(frozen=True)
class PeakReport:
    """The peak of one call."""

    peak_bytes: int          # the most bytes live at once
    input_bytes: int         # the arguments (live throughout)
    output_bytes: int        # the outputs
    peak_op: Optional[str]   # the op at the peak (None: the arguments)
    peak_source: Optional[str]  # repro_torch/<module>.py:<line> of it


def counted_run(fn, args=(), kwargs=None) -> Traced:
    """Run ``fn(*args, **kwargs)`` under a fresh ``CostMode`` with the
    arguments tracked, the garbage collector held off (storages made
    before the run are not counted unless tracked, so what the collector
    would free of them does not matter); raises what ``fn`` raises."""
    from repro_torch.launch.cost_analysis import CostMode, tree_bytes

    mode = CostMode(scale_loops=False)
    enabled = gc.isenabled()
    gc.disable()
    try:
        with mode:
            inputs = mode.track(args, kwargs)
            out = fn(*args, **(kwargs or {}))
            outputs = tree_bytes(out)
            del out
    finally:
        if enabled:
            gc.enable()
    return Traced(mode, inputs, outputs)


def peak_report(traced: Traced) -> PeakReport:
    m = traced.mode
    return PeakReport(peak_bytes=int(m.peak_bytes),
                      input_bytes=int(traced.input_bytes),
                      output_bytes=int(traced.output_bytes),
                      peak_op=m.peak_op, peak_source=m.peak_source)


def peak_live_bytes(fn, *args, **kwargs) -> PeakReport:
    """The :class:`PeakReport` of ``fn(*args, **kwargs)`` on meta."""
    return peak_report(counted_run(fn, args, kwargs))
