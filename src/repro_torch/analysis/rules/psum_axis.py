"""psum-axis: a collective's axis names must be the grid's axes (port of
``repro.analysis.rules.psum_axis``).

The port's collectives are the methods of ``launch.mesh.NMFMesh``:
``all_reduce(x, axes)``, ``all_to_all(x, axis)`` and ``gather(x, total,
axis, dim)``.  An axis-name typo there (``mesh.all_reduce(x, "modle")``)
is a pure string bug that raises only when that line runs on a grid, so a
repo-wide pass can kill it first.

``begin_run`` harvests the declared axis vocabulary from every analyzed
file: the string constants assigned to a name ``AXES`` (the grid's axes,
``launch/mesh.py``).  ``check`` then flags any *string literal* axis
argument of those collectives outside the vocabulary.  Axis names passed
as variables are out of scope (the engines thread ``rows_axes`` values,
which this rule cannot resolve).

When no ``AXES`` declaration is visible the rule cannot tell a typo from a
fine name, so instead of passing silently it reports each string-literal
axis as *unverifiable* (suppressible like any finding), unless the IR
collective check is also running (``defer_to_ir``, set by the CLI's
``--ir``), which checks every collective the traced entry points issue
against the process groups of their grid.
"""
from __future__ import annotations

import ast
from typing import Iterable, Sequence, Set, Tuple

from repro_torch.analysis.framework import FileContext, Rule, register_rule
from repro_torch.analysis.rules._common import (
    call_target, string_constants, tail_name,
)

#: the name the grid's axes are declared under (``launch/mesh.py``)
_DECLARATION = "AXES"
#: collective -> (keyword, positional index) of its axis argument
_COLLECTIVES = {"all_reduce": ("axes", 1), "all_to_all": ("axis", 1),
                "gather": ("axis", 2)}


def _harvest(ctx: FileContext) -> Set[str]:
    declared: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if node.value is not None and any(
                    isinstance(t, ast.Name) and t.id == _DECLARATION
                    for t in targets):
                declared.update(string_constants(node.value))
    return declared


@register_rule
class PsumAxis(Rule):
    name = "psum-axis"
    description = ("string axis names in NMFMesh collectives (all_reduce, "
                   "all_to_all, gather) must be the grid's declared AXES — "
                   "a typo surfaces only when the line runs on a grid")

    def __init__(self):
        self._declared: Set[str] = set()
        #: set by the CLI when the IR collective check runs in the same
        #: invocation: it checks every traced collective against the grid,
        #: so the no-vocabulary "unverifiable" guess would be noise
        self.defer_to_ir: bool = False

    def begin_run(self, contexts: Sequence[FileContext]) -> None:
        self._declared = set()
        for ctx in contexts:
            self._declared |= _harvest(ctx)

    def check(self, ctx: FileContext) -> Iterable[Tuple[ast.AST, str]]:
        unverifiable = not self._declared
        if unverifiable and self.defer_to_ir:
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            tail = tail_name(call_target(node)) or node.func.attr
            if tail not in _COLLECTIVES:
                continue
            keyword, pos = _COLLECTIVES[tail]
            axis_expr = None
            for kw in node.keywords:
                if kw.arg == keyword:
                    axis_expr = kw.value
            if axis_expr is None and pos < len(node.args):
                axis_expr = node.args[pos]
            if axis_expr is None:
                continue
            for name in string_constants(axis_expr):
                if unverifiable:
                    yield node, (
                        f"unverifiable: {tail} over axis {name!r}, but the "
                        "analyzed tree declares no AXES to check it against "
                        "— include launch/mesh.py in the analyzed paths, "
                        "run with --ir (the IR collective check verifies the "
                        "traced collectives), or suppress with a reason")
                elif name not in self._declared:
                    yield node, (
                        f"{tail} over axis {name!r}, which is not one of "
                        f"the grid's axes ({', '.join(sorted(self._declared))})")
