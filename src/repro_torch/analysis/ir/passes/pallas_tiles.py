"""IR pass: the kernels' tile legality and shared-memory working set (port
of ``repro.analysis.ir.passes.pallas_tiles``; the pass keeps the
reference's name so that the two waiver ledgers line up).

The reference reads Pallas BlockSpecs and holds them to the TPU's tiling
and VMEM.  The port's kernels are CUDA C++ whose wrappers state what they
take, so this pass runs those statements on each kernel target's operands
and holds the kernel's documented working set to the card's:

* **Legality** — the wrapper's own checks (``IRTarget.checks``:
  ``kernels/bsr_spmm.py::check_operands`` — tile dims up to 128, a tile
  row of whole 16-byte vectors, one dtype — and
  ``kernels/flash_attention.py::check_operands`` — head sizes, GQA
  groups, strides); an operand a check refuses is a finding.
* **Shared memory** — the working set ``kernels/autotune.py`` documents
  (``fused_working_set``: the ring of two (tile, full-rank slab) stages
  and the k x k Gram; ``spmm_working_set``: the ring at the column chunk)
  must fit :data:`~repro_torch.kernels.autotune.SMEM_BUDGET`, the H100's
  232,448 bytes of opt-in shared memory a block.  It is recorded in the
  target's ``measured`` entry.
"""
from __future__ import annotations

from repro_torch.analysis.ir.framework import IRContext, IRPass, IRTarget, \
    register_ir_pass


@register_ir_pass
class PallasTilesPass(IRPass):
    name = "pallas-tiles"
    description = ("kernel operands must pass the wrappers' legality checks "
                   "and the documented shared-memory working set must fit "
                   "the H100's 232,448 bytes a block")

    def applies_to(self, target: IRTarget) -> bool:
        return bool(target.checks) or target.smem_bytes is not None

    def check(self, target: IRTarget, ctx: IRContext):
        from repro_torch.kernels.autotune import SMEM_BUDGET

        for label, legal in target.checks:
            try:
                legal()
            except (TypeError, ValueError) as e:
                yield f"kernel `{label}` refuses its operands: {e}"
        if target.smem_bytes is None:
            return
        ws = int(target.smem_bytes())
        ctx.record(target, smem_bytes=ws)
        if ws > SMEM_BUDGET:
            yield (f"kernel working set {ws} bytes of shared memory exceeds "
                   f"the {SMEM_BUDGET}-byte budget a block "
                   "(kernels/autotune.py SMEM_BUDGET) — shrink the tiles or "
                   "the rank")
