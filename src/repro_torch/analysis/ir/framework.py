"""IR-pass framework: check invariants on what the port's entry points run
(port of ``repro.analysis.ir.framework``).

The AST rules prove what the *source* says; these passes check what the
entry points *do*.  The port has no jaxpr: each registered entry point
(:class:`IRTarget`) runs on the ``meta`` device under a
``launch.cost_analysis.CostMode`` (:meth:`IRTarget.traced`) — shapes
without data, every op dispatched, every storage's life seen, every
collective and kernel launch counted — and the registered
:class:`IRPass`\\ es read what the mode recorded: the dense-blowup
detector and the peak-memory gate read its live-byte accounting
(:mod:`repro_torch.analysis.ir.liveness`), the collective check its
process groups, and the tile auditor runs the kernel wrappers' own
legality checks.

The machinery mirrors the AST side (same :class:`Finding` records, same
reporters, same CLI): passes register with ``@register_ir_pass``;
intentional violations are waived through a *pass-level waiver file*
(``analysis/torch_ir_waivers.json``) whose entries carry a mandatory reason
— a reasonless, unknown-pass or unreadable waiver is reported as
``suppression-hygiene`` exactly like a bad ``# repro: allow[...]`` comment.
Findings carry the pseudo-path ``ir://<target-name>`` so the text/JSON
reporters and the 0/1/2 exit contract apply unchanged.

Budgets keep the reference's lifecycle: a target without a committed
budget is a finding; ``--update-budgets`` measures and rewrites the ledger
without gating; a peak above the budget times :data:`HEADROOM` is a
regression; a budget that matches no target is stale, unless its target
was skipped for want of ranks, which keeps its budget.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

from repro_torch.analysis.framework import SUPPRESSION_HYGIENE, Finding
from repro_torch.analysis.ir.liveness import Traced, counted_run

__all__ = [
    "IRTarget", "IRPass", "IRContext", "IRRunResult", "Traced",
    "register_ir_pass", "all_ir_passes", "run_ir", "load_waivers",
    "TRACE_PASS", "HEADROOM", "DEFAULT_BUDGETS_PATH",
    "DEFAULT_WAIVERS_PATH",
]

#: pseudo-pass name for targets that fail to run on meta at all.  The
#: failure is itself a verdict (an axis that is not the grid's raises
#: there, for instance), so it is reported as a finding — waivable like any
#: pass, not a crash.
TRACE_PASS = "ir-trace"

DEFAULT_BUDGETS_PATH = "analysis/torch_ir_budgets.json"
DEFAULT_WAIVERS_PATH = "analysis/torch_ir_waivers.json"

#: measured peak may exceed the committed budget by this factor before the
#: gate fails (the reference's); a densified temporary is a many-x
#: regression
HEADROOM = 1.10


class TargetTraceError(RuntimeError):
    """An IRTarget's run on meta raised."""


@dataclasses.dataclass
class IRTarget:
    """One entry point of the port, run on the ``meta`` device.

    ``fn(*args())`` is the call; ``args`` makes its arguments on meta
    (the operand, the initial factor...), which are tracked as live
    throughout.  ``operand_bytes`` is the sparse operand's footprint the
    blowup detector scales its threshold from.  ``requires_devices`` is
    the ranks of the process group it needs (the grid targets' 4).
    ``grid`` returns the ``NMFMesh`` the target's collectives must run on
    (None: the target issues none).  ``checks`` are the kernel wrappers'
    legality checks on the target's operands (``(label, thunk)``, a thunk
    raising ``ValueError`` / ``TypeError`` on an operand the kernel
    refuses), and ``smem_bytes`` the shared memory a block of its kernel
    needs (``kernels/autotune.py``'s working sets), held against the card's
    per-block limit.
    """

    name: str
    kind: str                      # "engine" | "mesh" | "kernel"
    fn: Callable[..., Any]
    args: Callable[[], tuple] = tuple
    operand_bytes: int = 0
    requires_devices: int = 0
    budget_key: Optional[str] = None   # ledger key; None = not budgeted
    grid: Optional[Callable[[], Any]] = None
    checks: Tuple[Tuple[str, Callable[[], None]], ...] = ()
    smem_bytes: Optional[Callable[[], int]] = None

    _traced: Optional[Traced] = dataclasses.field(default=None, repr=False)

    def traced(self) -> Traced:
        """``fn(*args())`` run once on meta (``liveness.counted_run``: the
        arguments tracked, loops run in full), what it counted kept."""
        if self._traced is None:
            try:
                self._traced = counted_run(self.fn, self.args())
            except Exception as e:  # the failure IS the analysis result
                raise TargetTraceError(f"{type(e).__name__}: {e}") from e
        return self._traced


@dataclasses.dataclass
class IRContext:
    """Shared state :func:`run_ir` hands every pass invocation."""

    budgets: Dict[str, Any]          # committed ledger (budgets file content)
    measured: Dict[str, Dict]        # budget_key -> measured entry
    update_budgets: bool = False
    skipped_checks: List[str] = dataclasses.field(default_factory=list)

    def note_skip(self, what: str) -> None:
        self.skipped_checks.append(what)

    def record(self, target: "IRTarget", **fields) -> None:
        """Add ``fields`` to the target's measured ledger entry."""
        if target.budget_key is not None:
            self.measured.setdefault(target.budget_key, {}).update(fields)


class IRPass:
    """One named check over what a target's run on meta counted.

    Subclasses set ``name`` / ``description`` and implement
    ``check(target, ctx) -> Iterable[str]`` (messages; location is the
    target).  ``applies_to(target)`` scopes the pass by target kind.
    """

    name: str = ""
    description: str = ""

    def applies_to(self, target: IRTarget) -> bool:
        return True

    def check(self, target: IRTarget, ctx: IRContext) -> Iterable[str]:
        raise NotImplementedError


_IR_PASSES: Dict[str, IRPass] = {}


def register_ir_pass(cls):
    """Class decorator adding a pass (by instance) to the registry."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"IR pass {cls.__name__} has no name")
    if inst.name in _IR_PASSES:
        raise ValueError(f"duplicate IR pass name {inst.name!r}")
    _IR_PASSES[inst.name] = inst
    return cls


def all_ir_passes() -> Dict[str, IRPass]:
    from repro_torch.analysis.ir import passes as _passes  # noqa: F401

    return dict(_IR_PASSES)


# ---------------------------------------------------------------------------
# Waivers: the pass-level ledger, same semantics as ``# repro: allow[...]``
# ---------------------------------------------------------------------------

def load_waivers(path) -> Tuple[List[Dict], List[Finding]]:
    """Read the waiver file.  Returns (waivers, hygiene findings) — a
    waiver without a reason, naming an unknown pass, or a file that is not
    a ledger, is reported as ``suppression-hygiene`` (unsuppressable),
    mirroring the AST ledger."""
    p = Path(path)
    if not p.exists():
        return [], []

    def unreadable(why):
        return [], [Finding(
            SUPPRESSION_HYGIENE, str(path), 1, 0,
            f"unreadable IR waiver ledger ({why}) — every waiver entry "
            "needs {pass, target, reason}")]

    try:
        data = json.loads(p.read_text())
    except ValueError as e:
        return unreadable(e)
    entries = data.get("waivers", data) if isinstance(data, dict) else data
    if not isinstance(entries, list) or not all(
            isinstance(w, dict) for w in entries):
        return unreadable("its waivers are not a list of objects")
    known = set(all_ir_passes()) | {TRACE_PASS}
    waivers, hygiene = [], []
    for i, w in enumerate(entries):
        pass_name = w.get("pass", "")
        reason = str(w.get("reason") or "").strip()
        if not reason:
            hygiene.append(Finding(
                SUPPRESSION_HYGIENE, str(path), i + 1, 0,
                f"IR waiver of [{pass_name}] for {w.get('target', '*')!r} "
                "carries no reason — every waiver must explain itself"))
            continue
        if pass_name not in known:
            hygiene.append(Finding(
                SUPPRESSION_HYGIENE, str(path), i + 1, 0,
                f"IR waiver names unknown pass [{pass_name}]"))
            continue
        waivers.append(w)
    return waivers, hygiene


def _waive(finding: Finding, waivers: Sequence[Dict]) -> Finding:
    target = finding.path[len("ir://"):] if finding.path.startswith("ir://") \
        else finding.path
    for w in waivers:
        if w["pass"] != finding.rule:
            continue
        if fnmatch.fnmatchcase(target, w.get("target", "*")):
            return dataclasses.replace(
                finding, suppressed=True, reason=w["reason"])
    return finding


# ---------------------------------------------------------------------------
# Running the targets and the passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IRRunResult:
    findings: List[Finding]
    errors: List[str]
    skipped_targets: List[Dict]      # [{target, reason}]
    skipped_checks: List[str]
    measured: Dict[str, Dict]        # budget_key -> measured ledger entry
    budgets_path: str
    budgets_written: bool = False


def _finding(pass_name: str, target: IRTarget, message: str) -> Finding:
    return Finding(pass_name, f"ir://{target.name}", 0, 0, message)


def _available_ranks() -> int:
    """The ranks of this process's group (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def run_ir(targets: Optional[Sequence[IRTarget]] = None,
           passes: Optional[Sequence[IRPass]] = None,
           budgets_path: str = DEFAULT_BUDGETS_PATH,
           waivers_path: str = DEFAULT_WAIVERS_PATH,
           update_budgets: bool = False,
           timings: Optional[Dict[str, float]] = None) -> IRRunResult:
    """Run every target on meta and every registered IR pass over it.

    Mirrors :func:`repro_torch.analysis.framework.analyze_paths`: returns
    findings (waived ones marked suppressed-with-reason) and internal
    errors.  Targets needing more ranks than this process's group has are
    *skipped* (recorded, never silently dropped); with ``update_budgets``
    the measured peak-memory ledger is written to ``budgets_path`` after
    the run.
    """
    if targets is None:
        from repro_torch.analysis.ir.targets import default_targets

        targets = default_targets()
    if passes is None:
        passes = list(all_ir_passes().values())
    waivers, findings = load_waivers(waivers_path)
    errors: List[str] = []
    skipped: List[Dict] = []

    budgets: Dict[str, Any] = {}
    bp = Path(budgets_path)
    if bp.exists():
        try:
            budgets = json.loads(bp.read_text())
        except ValueError as e:
            errors.append(f"{budgets_path}: unreadable budget ledger: {e}")

    n_ranks = _available_ranks()
    traced: List[IRTarget] = []
    for t in targets:
        if t.requires_devices > n_ranks:
            skipped.append({"target": t.name,
                            "reason": f"needs {t.requires_devices} ranks, "
                                      f"have {n_ranks}"})
            continue
        t0 = time.perf_counter()
        try:
            t.traced()
            traced.append(t)
        except TargetTraceError as e:
            findings.append(_finding(
                TRACE_PASS, t,
                f"entry point failed to run on meta: {e} — the IR passes "
                "cannot check what does not run"))
        if timings is not None:
            timings["trace"] = timings.get("trace", 0.0) + \
                (time.perf_counter() - t0)

    ctx = IRContext(budgets=budgets, measured={},
                    update_budgets=update_budgets)
    for ir_pass in passes:
        t0 = time.perf_counter()
        for target in traced:
            if not ir_pass.applies_to(target):
                continue
            try:
                for message in ir_pass.check(target, ctx):
                    findings.append(_finding(ir_pass.name, target, message))
            except Exception as e:  # an internal failure: exit 2, reported
                errors.append(
                    f"ir://{target.name}: pass {ir_pass.name} crashed: "
                    f"{type(e).__name__}: {e}")
        if timings is not None:
            timings[f"ir:{ir_pass.name}"] = time.perf_counter() - t0

    # stale-ledger guard: a committed budget whose target vanished (and was
    # not merely skipped for want of ranks) would silently stop gating
    skipped_names = {s["target"] for s in skipped}
    budgeted = {t.budget_key for t in traced if t.budget_key}
    skipped_keys = {t.budget_key for t in targets
                    if t.budget_key and t.name in skipped_names}
    for key in budgets.get("budgets", {}):
        if key not in budgeted and key not in skipped_keys:
            findings.append(Finding(
                "peak-memory", f"ir://{key}", 0, 0,
                f"budget ledger entry {key!r} matches no traced target — "
                "delete it or restore the entry point "
                "(re-baseline with --ir --update-budgets)"))

    findings = [_waive(f, waivers) for f in findings]
    findings.sort(key=lambda f: (f.path, f.rule, f.message))

    result = IRRunResult(findings=findings, errors=errors,
                         skipped_targets=skipped,
                         skipped_checks=ctx.skipped_checks,
                         measured=ctx.measured, budgets_path=str(budgets_path))
    if update_budgets:
        _write_budgets(result, targets, budgets)
    return result


def _write_budgets(result: IRRunResult, targets: Sequence[IRTarget],
                   old: Dict) -> None:
    from repro_torch.analysis.ir.targets import CANON, UNSUPPORTED_PAIRS

    skipped_names = {s["target"] for s in result.skipped_targets}
    budgets = dict(old.get("budgets", {}))
    budgets.update(result.measured)
    # keep old entries for targets skipped on this machine; drop the rest
    live_keys = set(result.measured) | {
        t.budget_key for t in targets
        if t.budget_key and t.name in skipped_names}
    budgets = {k: v for k, v in sorted(budgets.items()) if k in live_keys}
    ledger = {
        "_comment": "Committed per-(solver, backend, grid) peak-memory "
                    "budgets of the port's entry points, CostMode's peak of "
                    "live bytes on the meta device at the canonical shapes. "
                    " Re-baseline intentionally with: python -m "
                    "repro_torch.analysis src/repro_torch --ir "
                    "--update-budgets",
        "config": dict(CANON, headroom=HEADROOM),
        "unsupported": UNSUPPORTED_PAIRS,
        "budgets": budgets,
    }
    Path(result.budgets_path).parent.mkdir(parents=True, exist_ok=True)
    Path(result.budgets_path).write_text(json.dumps(ledger, indent=1) + "\n")
    result.budgets_written = True
