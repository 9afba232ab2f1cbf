"""IR pass: per-target peak live bytes against the committed budget ledger
(port of ``repro.analysis.ir.passes.peak_memory``).

The peak (``liveness.counted_run``: ``CostMode.peak_bytes`` over the
target's run on meta, its arguments tracked) is deterministic — the same
call, the same bytes, on any machine — so it can be *committed*:
``analysis/torch_ir_budgets.json`` holds one entry per target, and a
change that densifies a hot path fails this pass even when every test
still passes (the ledger's ``headroom`` absorbs small changes only).

Re-baseline intentionally with ``python -m repro_torch.analysis
src/repro_torch --ir --update-budgets`` and commit the diff.  The card's
own number for the same call is ``repro_torch.analysis.runtime.
memory_guard``'s, which ``chip_smoke.py`` phase 27 holds against this one.
"""
from __future__ import annotations

from repro_torch.analysis.ir.framework import HEADROOM, IRContext, IRPass, \
    IRTarget, register_ir_pass
from repro_torch.analysis.ir.liveness import peak_report


@register_ir_pass
class PeakMemoryPass(IRPass):
    name = "peak-memory"
    description = ("CostMode's peak of live bytes per target on meta, gated "
                   "against the committed analysis/torch_ir_budgets.json")

    def check(self, target: IRTarget, ctx: IRContext):
        if target.budget_key is None:
            return
        report = peak_report(target.traced())
        ctx.record(target, peak_bytes=report.peak_bytes,
                   input_bytes=report.input_bytes,
                   output_bytes=report.output_bytes,
                   peak_op=report.peak_op, peak_source=report.peak_source)

        if ctx.update_budgets:  # re-baselining: measure, don't gate
            return
        committed = ctx.budgets.get("budgets", {}).get(target.budget_key)
        if committed is None:
            yield ("no committed peak-memory budget for this target in the "
                   "ledger — run `python -m repro_torch.analysis "
                   "src/repro_torch --ir --update-budgets` and commit "
                   "analysis/torch_ir_budgets.json")
            return
        headroom = float(ctx.budgets.get("config", {}).get(
            "headroom", HEADROOM))
        limit = int(committed["peak_bytes"] * headroom)
        if report.peak_bytes > limit:
            src = f" at {report.peak_source}" if report.peak_source else ""
            yield (f"peak-memory regression: peak {report.peak_bytes} bytes "
                   f"exceeds committed budget {committed['peak_bytes']} "
                   f"(x{headroom:g} headroom = {limit}); peak op "
                   f"`{report.peak_op}`{src} — fix the densification or "
                   "re-baseline deliberately with --ir --update-budgets")
