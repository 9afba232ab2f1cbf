"""FLOPs, HBM bytes, collective bytes and peak live bytes of a step, counted
at PyTorch's dispatch on the ``meta`` device (the counterpart of
``repro.launch.hlo_analysis``; the port has no HLO to parse).

:class:`CostMode` is a ``TorchDispatchMode``: every operator a step
dispatches passes through it, so it counts what the eager port does, op
by op, without a card.

* ``flops`` — 2·M·N·K for every matrix product (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, and the ``bmm`` an ``einsum`` lowers to) and the
  convolutions, from ``torch.utils.flop_counter``'s table; elementwise ops
  count none, as in the reference (``hlo_analysis.py:10-13``).
* ``hbm_bytes`` — the operand and result bytes of each dispatched op: in
  eager PyTorch every op is its own boundary, so this is the eager port's
  own traffic.  A view, an alias and an ``empty`` (nothing written) count
  nothing.
* Each hand-written kernel counts its own cost, not its ops
  (``repro_torch.scan.record_kernel``, called by the wrapper's meta
  branch): the function's work, FLOPs of the useful arithmetic and each
  input byte read once, each output byte written once, with its launch
  under ``launches``.
* ``coll_bytes`` / ``coll_by_kind`` / ``coll_calls`` — the process-group
  collectives the step issues (``NMFMesh.all_reduce`` and ``all_to_all``,
  the calls and bytes ``launch.mesh.collective_counts`` counts), seen at
  dispatch so that a scaled loop (below) scales them too.
* Peak live bytes (the counterpart of ``memory_analysis()``): every new
  storage adds its bytes and a weak reference to it takes them off when it
  is freed; :meth:`CostMode.track` adds the storages the step is handed
  (parameters, optimizer state, batch), which stay live throughout.  With
  the peak it keeps the op that reached it and the port's source line of
  that op (``peak_op`` / ``peak_source``, the reference planner's
  ``peak_eqn`` / ``peak_source``), and the largest single op result
  (``largest_result``: bytes, op, source line).
* ``coll_groups`` — the calls of each collective kind by the name of the
  process group it was issued on, so that a caller holding the grid's
  groups can name their axes (``repro_torch.analysis``'s collectives
  pass).

**Loops.**  An eager Python loop dispatches every iteration, so the
reference's trip-count scaling is automatic, at the cost of dispatch time.
The models' long loops run through ``repro_torch.scan.scan``, the port's
``lax.scan``; under a :class:`CostMode` with ``scale_loops`` (the
dry-run's) one step stands for the steps like it: its forward ops, its
backward ops (autograd nodes made inside it, found by their sequence
numbers) and, for the peak, every storage it leaves alive (its outputs and
what it saved for backward) count as many times as the steps it stands
for.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import sys
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.autotune import (
    BF16_FLOPS,
    F32_FLOPS,
    HBM_BYTES_PER_S,
)
from repro_torch.scan import CountingMode, tensors

__all__ = ["Costs", "CostMode", "bound_ms", "tree_bytes"]

#: c10d operator -> the collective's kind (``collective_counts``' names)
_COLLECTIVES = {"allreduce_": "all_reduce", "alltoall_base_": "all_to_all"}

#: factory ops that allocate without writing
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}


@dataclasses.dataclass
class Costs:
    """The reference's ``hlo_analysis.Costs`` fields, plus the collectives'
    calls and each hand-written kernel's launches, FLOPs and bytes (a
    scaled loop's counts are already multiplied in)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_calls: Dict[str, float] = dataclasses.field(default_factory=dict)
    launches: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    #: process group name -> {kind: calls} of the collectives issued
    coll_groups: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def _add(self, field: str, key: str, v: float) -> None:
        d = getattr(self, field)
        d[key] = d.get(key, 0.0) + v

    def collectives(self) -> Dict[str, Dict[str, float]]:
        """``{kind: {"calls": n, "bytes": b}}``, a dry-run record's
        ``collectives``."""
        return {k: {"calls": self.coll_calls.get(k, 0.0), "bytes": v}
                for k, v in self.coll_by_kind.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_PKG = "repro_torch" + os.sep
#: the counters' and the analyzer's own frames, never a source line of
#: the step
_SKIP = ("launch/cost_analysis.py", "scan.py", "analysis/")


def port_source(depth: int = 1) -> Optional[str]:
    """``repro_torch/<module>.py:<line>`` of the innermost frame of the
    port below the caller (the counters' and the analyzer's own frames
    skipped), or None: a path from the package down, the same on any
    machine."""
    frame = sys._getframe(depth)
    while frame is not None:
        name = frame.f_code.co_filename
        at = name.rfind(_PKG)
        if at >= 0:
            rel = name[at + len(_PKG):].replace(os.sep, "/")
            if not rel.startswith(_SKIP):
                return f"repro_torch/{rel}:{frame.f_lineno}"
        frame = frame.f_back
    return None


def _group_name(pg) -> str:
    """The name of the process group a c10d op was dispatched with (a
    boxed ``ProcessGroup``), or ``"?"`` where this torch cannot unbox it."""
    unbox = getattr(getattr(torch.distributed, "ProcessGroup", None),
                    "unbox", None)
    try:
        return str(unbox(pg).group_name)
    except Exception:  # an unboxing this torch lacks: the group unnamed
        return "?"


def tree_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (as ``repro_torch.scan.tensors`` walks it),
    each view of a storage counted once."""
    seen, total = set(), 0
    for t in tensors(tree):
        key = (t.untyped_storage()._cdata, t.storage_offset(), t.shape)
        if key not in seen:
            seen.add(key)
            total += _nbytes(t)
    return total


class _Live:
    """One tracked storage: its bytes and how many copies it stands for
    (more than one when a scaled loop's body left it alive)."""

    __slots__ = ("nbytes", "mult", "ref")

    def __init__(self, nbytes: int):
        self.nbytes, self.mult, self.ref = nbytes, 1, None


class CostMode(CountingMode):
    """Counts :class:`Costs` and live bytes of what runs under it (see the
    module's docstring).  ``scale_loops`` lets ``scan`` run a loop's
    body once and count it for every step (the dry-run's setting); without
    it every step runs.  Use it on the ``meta`` device: it counts, it does
    not time."""

    def __init__(self, scale_loops: bool = True):
        super().__init__()
        self.scale_loops = scale_loops
        self.costs = Costs()
        self.live_bytes = 0
        self.peak_bytes = 0
        #: the op (schema name) and port source line at the peak
        self.peak_op: Optional[str] = None
        self.peak_source: Optional[str] = None
        #: (bytes, op, port source line) of the largest single op result
        self.largest_result: Tuple[int, Optional[str], Optional[str]] = (
            0, None, None)
        self._op: Optional[str] = None
        self._live: Dict[int, _Live] = {}
        # the forward scale of each active scaled body, its fresh storages
        self._frames: List[Tuple[int, List[_Live]]] = []
        # (first, end, factor) autograd sequence numbers of finished bodies,
        # and each looked-up node's product of them
        self._ranges: List[Tuple[int, int, int]] = []
        self._node_scale: Dict[int, int] = {}

    # -- live bytes --------------------------------------------------------

    def _free(self, rec: _Live, cdata: int, _ref) -> None:
        self.live_bytes -= rec.nbytes * rec.mult
        if self._live.get(cdata) is rec:
            del self._live[cdata]

    def _see(self, t: torch.Tensor, nbytes: Optional[int] = None) -> None:
        st = t.untyped_storage()
        cdata = st._cdata
        if cdata in self._live:
            return
        rec = _Live(st.nbytes() if nbytes is None else nbytes)
        rec.ref = weakref.ref(st, functools.partial(self._free, rec, cdata))
        self._live[cdata] = rec
        self.live_bytes += rec.nbytes
        for _, fresh in self._frames:
            fresh.append(rec)
        self._peak()

    def _peak(self) -> None:
        """Raise the peak to the live bytes, noting the op and the port's
        source line that reached it."""
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_op = self._op
            self.peak_source = port_source(2)

    def track(self, *trees) -> int:
        """Count the storages of ``trees`` (a step's arguments) as live;
        returns their bytes (each storage once)."""
        before = self.live_bytes
        self._op = None
        for t in tensors(trees):
            self._see(t)
        return self.live_bytes - before

    def track_as(self, tree, nbytes: int) -> int:
        """Count the storages of ``tree`` as live, as ``nbytes`` in all: a
        rank handed a whole batch holds only its block of it.  Returns
        ``nbytes``."""
        self._op = None
        for t in tensors(tree):
            self._see(t, 0)
        self.live_bytes += nbytes
        self._peak()
        return nbytes

    # -- scale -------------------------------------------------------------

    def _scale(self) -> int:
        f = 1
        for factor, _ in self._frames:
            f *= factor
        node = torch._C._current_autograd_node()
        if node is not None:
            seq = node._sequence_nr()
            g = self._node_scale.get(seq)
            if g is None:
                g = 1
                for lo, hi, factor in self._ranges:
                    if lo <= seq < hi:
                        g *= factor
                self._node_scale[seq] = g
            f *= g
        return f

    @staticmethod
    def _next_sequence_nr() -> int:
        """The sequence number the next autograd node will take."""
        with torch.enable_grad():
            probe = torch.empty(0, device="meta", requires_grad=True).view(0)
        return probe.grad_fn._sequence_nr() + 1

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside as ``n`` times: its ops now, the backward
        of the autograd nodes it makes later, and the storages it leaves
        alive as ``n`` copies each, but for the tensors added to the list
        it yields (a loop's carry, which each step replaces)."""
        lo = self._next_sequence_nr()
        fresh: List[_Live] = []
        once: List[torch.Tensor] = []
        self._frames.append((n, fresh))
        try:
            yield once
        finally:
            self._frames.pop()
            self._ranges.append((lo, self._next_sequence_nr(), n))
            self._node_scale.clear()
            skip = {t.untyped_storage()._cdata for t in tensors(once)}
            for rec in fresh:
                st = rec.ref()
                if st is not None and st._cdata not in skip:
                    self.live_bytes += rec.nbytes * rec.mult * (n - 1)
                    rec.mult *= n
            self._peak()

    # -- recording ---------------------------------------------------------

    def record_kernel(self, name: str, flops: float, nbytes: float) -> None:
        f = self._scale()
        c = self.costs
        c.flops += flops * f
        c.hbm_bytes += nbytes * f
        c._add("launches", name, f)
        c._add("kernel_flops", name, flops * f)
        c._add("kernel_bytes", name, nbytes * f)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        f = self._scale()
        c = self.costs
        outs = tensors(out)
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            kind = _COLLECTIVES.get(name, name)
            src, pg = (args[1], args[2]) if kind == "all_to_all" else \
                (args[0], args[1])
            nbytes = sum(_nbytes(t) for t in tensors(src))
            c.coll_bytes += nbytes * f
            c._add("coll_by_kind", kind, nbytes * f)
            c._add("coll_calls", kind, f)
            by_kind = c.coll_groups.setdefault(_group_name(pg), {})
            by_kind[kind] = by_kind.get(kind, 0.0) + f
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            c.flops += f * flop_registry[packet](*args, **kwargs,
                                                 out_val=out)
        ins = tensors((args, kwargs))
        op = func._schema.name.split("::")[-1]
        if not _is_alias(func, ins, outs):
            c.hbm_bytes += f * (sum(_nbytes(t) for t in ins)
                                + sum(_nbytes(t) for t in outs))
            biggest = max(_nbytes(t) for t in outs)
            if biggest > self.largest_result[0]:
                self.largest_result = (biggest, op, port_source(2))
        self._op = op
        for t in outs:
            self._see(t)
        return out


def _is_alias(func, ins, outs) -> bool:
    """True when the op moves no bytes: a view or alias of an input, an
    allocation that writes nothing, or an empty result."""
    if func.is_view or func.overloadpacket.__name__ in _EMPTY:
        return True
    if not outs or all(t.numel() == 0 for t in outs):
        return True
    if func._schema.is_mutable:
        return False
    stores = {t.untyped_storage()._cdata for t in ins}
    return all(t.untyped_storage()._cdata in stores for t in outs)


def bound_ms(flops: float, nbytes: float, dtype=torch.float32
             ) -> Tuple[float, str]:
    """The least time one H100 SXM could take for ``flops`` and
    ``nbytes``: the larger of the bytes at 3.35 TB/s and the FLOPs at the
    peak of ``dtype`` (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
    f32 outside them), in ms, and which of the two it is."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")
