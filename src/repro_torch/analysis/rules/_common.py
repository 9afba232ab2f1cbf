"""Shared AST helpers for the rule modules (port of
``repro.analysis.rules._common``, with the port's sparse types)."""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from repro_torch.analysis.framework import qualname

#: aliases under which the array modules are imported in the port
ARRAY_MODULES = {"np", "numpy", "torch"}

#: the port's sparse operand types: a parameter annotated with one of these
#: (or a value built by one of the SPARSE_CONSTRUCTORS) is a sparse operand
#: for the no-densify rule (``kernels/bsr.py``, ``sparse/csr.py``,
#: ``core/distributed.py``, ``backend/sharded.py``, ``backend/base.py``)
SPARSE_TYPES = {
    "SpCSR", "BSR", "BSROperand", "DistCSR", "DistBSR", "Matrix",
    "ShardView",
}

#: call targets whose result is a sparse operand (trailing name of the
#: dotted call target)
SPARSE_CONSTRUCTORS = {
    "SpCSR", "BSR", "BSROperand", "DistCSR", "DistBSR",
    "from_coo", "from_scipy", "from_dense", "column_block",
    "bsr_from_dense", "bsr_from_scipy", "bsr_operand", "bsr_transpose",
    "bsr_from_reference", "distribute_csr", "distribute_csr_from_padded",
    "distribute_bsr",
}


def call_target(node: ast.Call) -> Optional[str]:
    """Dotted name of the called expression, or None."""
    return qualname(node.func)


def tail_name(dotted: Optional[str]) -> Optional[str]:
    if dotted is None:
        return None
    return dotted.rsplit(".", 1)[-1]


def annotation_name(node: Optional[ast.AST]) -> Optional[str]:
    """Trailing identifier of an annotation (``SpCSR``, ``csr.SpCSR``,
    ``Optional[SpCSR]`` -> ``SpCSR``)."""
    if node is None:
        return None
    if isinstance(node, ast.Subscript):
        for inner in ast.walk(node):
            if isinstance(inner, (ast.Name, ast.Attribute)):
                name = tail_name(qualname(inner))
                if name in SPARSE_TYPES:
                    return name
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.rsplit(".", 1)[-1].strip("'\"[]")
    return tail_name(qualname(node))


def sparse_names_in(fn: ast.AST) -> Set[str]:
    """Names that are sparse operands inside a function scope: parameters
    annotated with a sparse type, and names assigned from a sparse
    constructor call."""
    suspects: Set[str] = set()
    args = fn.args
    for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
        if annotation_name(a.annotation) in SPARSE_TYPES:
            suspects.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if tail_name(call_target(node.value)) in SPARSE_CONSTRUCTORS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        suspects.add(t.id)
    return suspects


def string_constants(node: ast.AST) -> Iterator[str]:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n.value
