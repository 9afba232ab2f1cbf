"""CLI: ``python -m repro_torch.analysis <paths...>`` — the port's gate
(port of ``repro.analysis.__main__``).

Exit codes: 0 = clean (suppressed-with-reason findings allowed), 1 = any
unsuppressed finding or reasonless suppression, 2 = unreadable or
unparseable input, or an internal failure.  ``--format json`` emits the
machine-readable report; ``--out PATH`` writes it to a file.

``--ir`` also runs the IR passes (dense-blowup, peak-memory, collectives,
pallas-tiles) over the port's entry points on the ``meta`` device.  Its
mesh targets need a grid of 4 ranks: the CLI makes this process rank 0 of
a ``fake`` group of 4 (``launch.dryrun.fake_world``), where the reference
forced 4 XLA host devices.  ``--update-budgets`` re-baselines the committed peak-memory
ledger (``analysis/torch_ir_budgets.json``) from this run.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.framework import (
    all_rules, analyze_paths, render_json, render_text,
)

#: ranks of the fake grid the mesh targets run on
IR_WORLD = 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's analyzer: AST rules (no-densify, "
                    "exception-hygiene, psum-axis) plus, with --ir, passes "
                    "over the entry points run on the meta device "
                    "(dense-blowup, peak-memory, collectives, pallas-tiles)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", "--output", dest="out", default=None,
                    help="write the report here instead of stdout")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule and IR-pass catalogs and exit")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include suppressed findings in the text report")
    ap.add_argument("--ir", action="store_true",
                    help="also run the entry points on the meta device and "
                         "the IR passes (the mesh targets on a fake group "
                         f"of {IR_WORLD} ranks)")
    ap.add_argument("--update-budgets", action="store_true",
                    help="with --ir: rewrite analysis/torch_ir_budgets.json "
                         "from this run's measurements (re-baseline)")
    args = ap.parse_args(argv)

    registry = all_rules()
    if args.list_rules:
        for name, rule in sorted(registry.items()):
            print(f"{name}: {rule.description}")
        from repro_torch.analysis.ir.framework import all_ir_passes

        for name, ir_pass in sorted(all_ir_passes().items()):
            print(f"{name} (--ir): {ir_pass.description}")
        return 0

    rules = None
    if args.rules:
        names = [n.strip() for n in args.rules.split(",") if n.strip()]
        unknown = [n for n in names if n not in registry]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}; "
                  f"known: {', '.join(sorted(registry))}", file=sys.stderr)
            return 2
        rules = [registry[n] for n in names]

    if args.ir and "psum-axis" in registry:
        # the IR collective check verifies the traced collectives; the AST
        # rule's no-vocabulary "unverifiable" fallback would be noise
        registry["psum-axis"].defer_to_ir = True

    timings = {}
    findings, errors = analyze_paths(args.paths, rules=rules,
                                     timings=timings)
    extra = None
    if args.ir:
        try:
            from repro_torch.analysis.ir import run_ir
            from repro_torch.launch.dryrun import fake_world

            with fake_world(IR_WORLD):
                ir_result = run_ir(update_budgets=args.update_budgets,
                                   timings=timings)
        except Exception as e:  # an internal failure is exit 2, reported
            errors.append(f"--ir: {type(e).__name__}: {e}")
        else:
            findings = findings + ir_result.findings
            errors = errors + ir_result.errors
            extra = {"ir": {
                "skipped_targets": ir_result.skipped_targets,
                "skipped_checks": ir_result.skipped_checks,
                "budgets_path": ir_result.budgets_path,
                "budgets_written": ir_result.budgets_written,
                "measured": ir_result.measured,
            }}

    if args.format == "json":
        report = render_json(findings, errors, timings=timings, extra=extra)
    else:
        report = render_text(findings, errors,
                             verbose_suppressed=args.show_suppressed,
                             timings=timings)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    else:
        print(report)
    if errors:
        return 2
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
