"""IR pass: no op result may blow up dense (port of
``repro.analysis.ir.passes.dense_blowup``).

The AST ``no-densify`` rule bans the *spellings* of densification; this
pass bans the *fact* of it, through any API: of every op the target runs
on meta (its rank's block for a grid target), the largest single result
(``CostMode.largest_result``) must stay under ``blowup_multiplier`` times
the sparse operand's bytes.  A gather that materializes (n, m), a mask
built at the operand's full shape, an outer product of the values — all
land here though no banned name appears in the source.

At the canonical shapes (``targets.CANON``) every legitimate result of the
sparse backends stays under the threshold while a dense (n, m) temporary
sits far above it.
"""
from __future__ import annotations

from repro_torch.analysis.ir.framework import IRContext, IRPass, IRTarget, \
    register_ir_pass

#: results below this many bytes are never interesting, whatever the ratio
_MIN_BYTES = 1 << 16


@register_ir_pass
class DenseBlowupPass(IRPass):
    name = "dense-blowup"
    description = ("flag op results larger than blowup_multiplier x the "
                   "sparse-operand footprint (densification through any API)")

    def applies_to(self, target: IRTarget) -> bool:
        # kernels take dense factor slabs; densification is a property of
        # solver steps over sparse operands
        return target.kind != "kernel"

    def check(self, target: IRTarget, ctx: IRContext):
        from repro_torch.analysis.ir.targets import CANON

        multiplier = CANON["blowup_multiplier"]
        traced = target.traced()
        footprint = target.operand_bytes or traced.input_bytes
        if footprint <= 0:
            ctx.note_skip(f"{target.name}: no operand footprint to scale "
                          "the dense-blowup threshold from")
            return
        nbytes, op, where = traced.mode.largest_result
        if nbytes < _MIN_BYTES or nbytes <= multiplier * footprint:
            return
        yield (f"dense blowup: `{op}` materializes {nbytes} bytes, "
               f"{nbytes / footprint:.1f}x the {footprint}-byte sparse "
               f"operand footprint (threshold {multiplier:g}x)"
               + (f" [{where}]" if where else ""))
