"""``repro_torch.analysis`` — the port's analyzer (port of
``repro.analysis``): static and runtime checks of its invariants.

Static side (stdlib ``ast`` only)::

    python -m repro_torch.analysis src/repro_torch [--format json]

AST rules over the codebase: **no-densify** (sparse operands never
silently materialize dense), **exception-hygiene** (no bare or swallowing
broad ``except`` on the numeric and data paths) and **psum-axis** (the
axis names of ``NMFMesh`` collectives are the grid's ``AXES``).  Per-line
waivers need a reason: ``# repro: allow[<rule>] why``.

The reference's ``jit-cache``, ``donation-safety`` and ``pallas-purity``
rules are not ported: eager PyTorch has no ``jax.jit`` executable cache
to thrash, no buffer donation to refuse, and the port has no Pallas
kernel body (its kernels are CUDA C++ sources), so there is nothing for
them to check and no stand-in is invented.

IR side (behind ``--ir``)::

    python -m repro_torch.analysis src/repro_torch --ir [--update-budgets]

Every (solver, backend) pair of the port's registries, the grid engines
on 2x2 and 4x1 and each kernel wrapper run on the ``meta`` device under
``launch.cost_analysis.CostMode`` (the mesh targets in a ``fake`` process
group of 4 ranks), and the passes read what it counted:
**dense-blowup** (no op result above a multiple of the sparse operand's
bytes), **peak-memory** (the peak of live bytes gated against the
committed ``analysis/torch_ir_budgets.json``), **collectives** (every
collective issued names axes of the target's grid; its calls and bytes
recorded) and **pallas-tiles** (the wrappers' own legality checks and
the fused kernel's shared-memory working set against the H100's).
Waivers live in ``analysis/torch_ir_waivers.json`` with mandatory
reasons.

Runtime side::

    from repro_torch.analysis import recompile_guard, memory_guard
    with recompile_guard():          # raises if an nvcc build starts
        model.fit(a)
    report = memory_guard(fn, *args) # the allocator's (or meta's) peak

:func:`recompile_guard` counts the port's only compilations, the ``nvcc``
builds of its kernels at first use; :func:`memory_guard` reads the CUDA
allocator's peak on the card and ``CostMode``'s on ``meta``.
"""
from repro_torch.analysis.framework import (
    Finding, Rule, all_rules, analyze_paths, analyze_source, register_rule,
    render_json, render_text,
)

__all__ = [
    "Finding", "Rule", "all_rules", "analyze_paths", "analyze_source",
    "register_rule", "render_json", "render_text",
    "recompile_guard", "CompilationCounter", "RecompilationError",
    "memory_guard", "MemoryReport", "MemoryBudgetError",
    "run_ir", "IRTarget", "IRPass", "register_ir_pass", "all_ir_passes",
]

_RUNTIME_NAMES = ("recompile_guard", "CompilationCounter",
                  "RecompilationError", "memory_guard", "MemoryReport",
                  "MemoryBudgetError")
_IR_NAMES = ("run_ir", "IRTarget", "IRPass", "register_ir_pass",
             "all_ir_passes")


def __getattr__(name):
    # the runtime and IR layers import the port's engines and
    # torch.distributed; keep them lazy so the static CLI does not
    if name in _RUNTIME_NAMES:
        from repro_torch.analysis import runtime

        return getattr(runtime, name)
    if name in _IR_NAMES:
        from repro_torch.analysis import ir

        return getattr(ir, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
