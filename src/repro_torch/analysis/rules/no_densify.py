"""no-densify: sparse operands must not silently materialize dense (port
of ``repro.analysis.rules.no_densify``).

The paper's premise is that A is (n, m) sparse and only k-wide factors are
ever dense; one stray ``.toarray()`` or ``torch.zeros(a.shape)`` in a hot
path turns the memory model back into the dense baseline.  This rule
polices the port's hot-path packages (``core``, ``backend``, ``kernels``,
``sparse``, and ``data/corpus``) for:

* ``x.toarray()`` / ``x.todense()`` / ``x.to_dense()`` calls — scipy's and
  torch's densifiers;
* ``to_dense(x)`` (``sparse/csr.py``) and ``bsr_to_dense(x)``
  (``kernels/bsr.py``) calls — the port's explicit densifiers;
* ``np.asarray(x)`` / ``np.array(x)`` / ``torch.as_tensor(x)`` /
  ``torch.tensor(x)`` where ``x`` is a sparse operand (annotated with a
  sparse type or built by a sparse constructor in the same function);
* full-matrix allocations: ``zeros`` / ``ones`` / ``empty`` / ``full`` of
  ``torch`` or numpy whose shape is ``x.shape`` of a sparse operand, or a
  2-tuple of names unpacked from one (``n, m = a.shape;
  torch.zeros((n, m))``).

Intentional densification (the dense backend, whose contract it is)
carries a reasoned suppression.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Set, Tuple

from repro_torch.analysis.framework import FileContext, Rule, register_rule
from repro_torch.analysis.rules._common import (
    ARRAY_MODULES, call_target, sparse_names_in, tail_name,
)

_SCOPE_RE = re.compile(
    r"repro_torch/(core|backend|kernels|sparse)/|repro_torch/data/corpus")
_DENSIFY_METHODS = {"todense", "toarray", "to_dense"}
_DENSIFIERS = {"to_dense", "bsr_to_dense"}
_ALLOCATORS = {"zeros", "ones", "empty", "full"}
_CASTERS = {"asarray", "array", "asanyarray", "as_tensor", "tensor"}


def _shape_pairs(fn: ast.AST, suspects: Set[str]) -> List[Set[str]]:
    """Name pairs unpacked from a suspect's ``.shape``:
    ``n, m = a.shape`` -> {{"n", "m"}}."""
    pairs: List[Set[str]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        val = node.value
        if not (isinstance(val, ast.Attribute) and val.attr == "shape"
                and isinstance(val.value, ast.Name)
                and val.value.id in suspects):
            continue
        for t in node.targets:
            if isinstance(t, (ast.Tuple, ast.List)) and len(t.elts) == 2:
                names = {e.id for e in t.elts if isinstance(e, ast.Name)}
                if len(names) == 2:
                    pairs.append(names)
    return pairs


def _is_suspect_shape(arg: ast.AST, suspects: Set[str],
                      pairs: List[Set[str]]) -> bool:
    if (isinstance(arg, ast.Attribute) and arg.attr == "shape"
            and isinstance(arg.value, ast.Name) and arg.value.id in suspects):
        return True
    if isinstance(arg, (ast.Tuple, ast.List)) and len(arg.elts) == 2:
        names = {e.id for e in arg.elts if isinstance(e, ast.Name)}
        return any(names == p for p in pairs)
    return False


@register_rule
class NoDensify(Rule):
    name = "no-densify"
    description = ("hot-path packages must not densify sparse operands "
                   "(.toarray/.to_dense/to_dense/bsr_to_dense/asarray) or "
                   "allocate (n, m)-dense scratch from a sparse operand's "
                   "shape")

    def applies_to(self, path: str) -> bool:
        return bool(_SCOPE_RE.search(path))

    def check(self, ctx: FileContext) -> Iterable[Tuple[ast.AST, str]]:
        # suspects per function scope; module-level code gets the empty set
        by_fn: Dict[ast.AST, Tuple[Set[str], List[Set[str]]]] = {}

        def facts(node: ast.AST) -> Tuple[Set[str], List[Set[str]]]:
            fn = ctx.enclosing_function(node)
            if fn is None or isinstance(fn, ast.Lambda):
                return set(), []
            if fn not in by_fn:
                suspects = sparse_names_in(fn)
                by_fn[fn] = (suspects, _shape_pairs(fn, suspects))
            return by_fn[fn]

        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = call_target(node)
            tail = tail_name(target)

            # x.toarray() / x.to_dense() — only sparse objects have these
            if (isinstance(node.func, ast.Attribute) and not node.args
                    and node.func.attr in _DENSIFY_METHODS):
                yield node, (f".{node.func.attr}() materializes a dense "
                             "matrix in a hot-path package")
                continue

            # to_dense(x) / bsr_to_dense(x) — the port's densifiers
            if tail in _DENSIFIERS and node.args:
                yield node, (f"{tail}() call in a hot-path package — keep "
                             "the operand sparse or waive with a reason")
                continue

            if target is None or "." not in target:
                continue
            root = target.rsplit(".", 1)[0]
            if root not in ARRAY_MODULES:
                continue
            suspects, pairs = facts(node)

            # np.asarray(sparse) / torch.as_tensor(sparse)
            if tail in _CASTERS and node.args:
                first = node.args[0]
                if isinstance(first, ast.Name) and first.id in suspects:
                    yield node, (f"{target}({first.id}) densifies a sparse "
                                 "operand")
                continue

            # zeros/ones/empty/full over a sparse operand's (n, m) shape
            if tail in _ALLOCATORS and node.args:
                if _is_suspect_shape(node.args[0], suspects, pairs):
                    yield node, (f"{target} allocates a dense matrix with a "
                                 "sparse operand's full (n, m) shape")
