"""Rule framework of the port's analyzer (port of
``repro.analysis.framework``).

The port's hygiene invariants (sparse operands never silently densify,
a failure is never swallowed on the numeric and data paths, collectives
name the grid's axes) become a gate through this machinery, the
reference's unchanged:

* :class:`Rule` — one named check over a parsed file.  Rules visit the AST
  of a :class:`FileContext` and yield :class:`Finding`\\ s.  A rule may also
  implement ``begin_run(contexts)`` to collect cross-file facts first (the
  psum-axis rule harvests the grid's declared axis names this way).
* registry — ``@register_rule`` + :func:`all_rules`; the CLI and the tests
  draw from the same registry, so a rule cannot exist without being run.
* suppressions — ``# repro: allow[<rule>] <reason>`` on the flagged
  line waives that rule there.  A reason string is *mandatory*: a reasonless
  suppression is itself reported (rule ``suppression-hygiene``) and cannot
  be suppressed, so the waiver ledger stays explainable.
* reporters — text (``path:line:col: rule: message``) and JSON (one record
  per finding plus a summary block).

Exit-code contract (see ``__main__``): 0 = no unsuppressed findings,
1 = findings (or reasonless suppressions), 2 = usage/parse errors.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Finding", "FileContext", "Rule", "register_rule", "all_rules",
    "analyze_source", "analyze_paths", "render_text", "render_json",
    "SUPPRESSION_RE", "qualname", "iter_py_files",
]

#: ``# repro: allow[<rule>, <rule>] reason text`` — the reason is everything
#: after the closing bracket; rules are kebab-case names from the registry.
SUPPRESSION_RE = re.compile(
    r"#\s*repro:\s*allow\[([a-z0-9_, -]+)\]\s*(.*?)\s*$")

#: meta-rule name for suppression-comment defects (reasonless waivers,
#: unknown rule names).  Not suppressible — it guards the waiver ledger.
SUPPRESSION_HYGIENE = "suppression-hygiene"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: Optional[str] = None

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> Dict:
        d = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "suppressed": self.suppressed,
        }
        if self.reason is not None:
            d["reason"] = self.reason
        return d


class FileContext:
    """A parsed source file plus the derived facts every rule needs:
    the AST with parent links, per-line suppression directives, and the
    line table."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        _attach_parents(self.tree)
        #: line number -> (frozenset of rule names, reason or None)
        self.suppressions: Dict[int, Tuple[frozenset, Optional[str]]] = {}
        for lineno, text in enumerate(self.lines, start=1):
            m = SUPPRESSION_RE.search(text)
            if m:
                names = frozenset(
                    n.strip() for n in m.group(1).split(",") if n.strip())
                reason = m.group(2) or None
                self.suppressions[lineno] = (names, reason)

    def suppression_for(self, rule: str, line: int):
        """(suppressed?, reason) for ``rule`` at ``line``."""
        entry = self.suppressions.get(line)
        if entry is None:
            return False, None
        names, reason = entry
        return (rule in names), reason

    # -- scope helpers -------------------------------------------------------

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        """Nearest enclosing FunctionDef/AsyncFunctionDef/Lambda, or None
        for module-level code."""
        cur = getattr(node, "_repro_parent", None)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = getattr(cur, "_repro_parent", None)
        return None

    def parents(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = getattr(node, "_repro_parent", None)
        while cur is not None:
            yield cur
            cur = getattr(cur, "_repro_parent", None)


def _attach_parents(tree: ast.AST) -> None:
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._repro_parent = parent  # type: ignore[attr-defined]


def qualname(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute expression (``jax.lax.psum``), or
    None when any link is not a plain name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class Rule:
    """One named invariant check.

    Subclasses set ``name`` / ``description`` and implement
    ``check(ctx) -> Iterable[(node, message)]``.  ``applies_to(path)``
    scopes the rule (e.g. no-densify only polices the hot-path packages);
    ``begin_run(contexts)`` sees every file before per-file checks (for
    cross-file facts like the declared mesh axis names).
    """

    name: str = ""
    description: str = ""

    def applies_to(self, path: str) -> bool:
        return True

    def begin_run(self, contexts: Sequence[FileContext]) -> None:
        pass

    def check(self, ctx: FileContext) -> Iterable[Tuple[ast.AST, str]]:
        raise NotImplementedError


_RULES: Dict[str, Rule] = {}


def register_rule(cls):
    """Class decorator adding a rule (by instance) to the registry."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if inst.name in _RULES:
        raise ValueError(f"duplicate rule name {inst.name!r}")
    _RULES[inst.name] = inst
    return cls


def all_rules() -> Dict[str, Rule]:
    # import triggers registration of the built-in rule modules
    from repro_torch.analysis import rules as _rules  # noqa: F401

    return dict(_RULES)


# ---------------------------------------------------------------------------
# Driving the rules
# ---------------------------------------------------------------------------

def _norm(path: str) -> str:
    return str(path).replace("\\", "/")


def _run_rules_on(ctx: FileContext, rules: Sequence[Rule],
                  timings: Optional[Dict[str, float]] = None) -> List[Finding]:
    findings: List[Finding] = []
    known = {r.name for r in rules} | {SUPPRESSION_HYGIENE}
    for rule in rules:
        if not rule.applies_to(ctx.path):
            continue
        t0 = time.perf_counter()
        checked = list(rule.check(ctx))
        if timings is not None:
            timings[rule.name] = timings.get(rule.name, 0.0) + \
                (time.perf_counter() - t0)
        for node, message in checked:
            line = getattr(node, "lineno", 1)
            col = getattr(node, "col_offset", 0)
            suppressed, reason = ctx.suppression_for(rule.name, line)
            if suppressed and not reason:
                findings.append(Finding(
                    SUPPRESSION_HYGIENE, ctx.path, line, col,
                    f"suppression of [{rule.name}] carries no reason — "
                    "every waiver must explain itself"))
                suppressed = False
            findings.append(Finding(
                rule.name, ctx.path, line, col, message,
                suppressed=suppressed, reason=reason if suppressed else None))
    # suppression comments naming unknown rules are dead waivers — flag them
    # so a renamed rule cannot silently stop being enforced
    for lineno, (names, _reason) in ctx.suppressions.items():
        for n in names:
            if n not in known:
                findings.append(Finding(
                    SUPPRESSION_HYGIENE, ctx.path, lineno, 0,
                    f"suppression names unknown rule [{n}]"))
    return findings


def analyze_source(source: str, path: str = "<snippet>",
                   rules: Optional[Sequence[Rule]] = None,
                   rule_names: Optional[Sequence[str]] = None,
                   ) -> List[Finding]:
    """Analyze one in-memory snippet (the per-rule fixture tests' entry
    point).  ``rule_names`` filters the registry; cross-file facts are
    collected from this single file."""
    registry = all_rules()
    if rules is None:
        if rule_names is not None:
            rules = [registry[n] for n in rule_names]
        else:
            rules = list(registry.values())
    ctx = FileContext(_norm(path), source)
    for rule in rules:
        rule.begin_run([ctx])
    return _run_rules_on(ctx, rules)


def iter_py_files(paths: Sequence[str]) -> Iterator[Path]:
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        elif path.suffix == ".py":
            yield path


def analyze_paths(paths: Sequence[str],
                  rules: Optional[Sequence[Rule]] = None,
                  timings: Optional[Dict[str, float]] = None,
                  ) -> Tuple[List[Finding], List[str]]:
    """Analyze every ``*.py`` under ``paths``.  Returns (findings, errors);
    errors are unreadable/unparseable files (reported, exit code 2).
    ``timings``, when given, accumulates per-rule wall seconds (including
    each rule's ``begin_run``) so slow rules are visible in the reports."""
    if rules is None:
        rules = list(all_rules().values())
    contexts: List[FileContext] = []
    errors: List[str] = []
    for fp in iter_py_files(paths):
        try:
            contexts.append(FileContext(_norm(fp), fp.read_text()))
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(f"{fp}: {type(e).__name__}: {e}")
    for rule in rules:
        t0 = time.perf_counter()
        rule.begin_run(contexts)
        if timings is not None:
            timings[rule.name] = timings.get(rule.name, 0.0) + \
                (time.perf_counter() - t0)
    findings: List[Finding] = []
    for ctx in contexts:
        findings.extend(_run_rules_on(ctx, rules, timings=timings))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, errors


# ---------------------------------------------------------------------------
# Reporters
# ---------------------------------------------------------------------------

def render_text(findings: Sequence[Finding], errors: Sequence[str] = (),
                verbose_suppressed: bool = False,
                timings: Optional[Dict[str, float]] = None) -> str:
    out: List[str] = []
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    for f in active:
        out.append(f"{f.location()}: {f.rule}: {f.message}")
    if verbose_suppressed:
        for f in suppressed:
            out.append(f"{f.location()}: {f.rule}: suppressed "
                       f"({f.reason}): {f.message}")
    for e in errors:
        out.append(f"error: {e}")
    if timings:
        total = sum(timings.values())
        parts = ", ".join(f"{name} {secs * 1000:.0f}ms" for name, secs in
                          sorted(timings.items(), key=lambda kv: -kv[1]))
        out.append(f"timing: {total:.2f}s total ({parts})")
    out.append(
        f"{len(active)} finding(s), {len(suppressed)} suppressed, "
        f"{len(errors)} error(s)")
    return "\n".join(out)


def render_json(findings: Sequence[Finding], errors: Sequence[str] = (),
                timings: Optional[Dict[str, float]] = None,
                extra: Optional[Dict] = None) -> str:
    active = [f for f in findings if not f.suppressed]
    report = {
        "findings": [f.to_dict() for f in findings],
        "errors": list(errors),
        "summary": {
            "active": len(active),
            "suppressed": len(findings) - len(active),
            "errors": len(errors),
            "ok": not active and not errors,
        },
    }
    if timings is not None:
        report["timings_seconds"] = {
            k: round(v, 4) for k, v in sorted(timings.items())}
    if extra:
        report.update(extra)
    return json.dumps(report, indent=1)
