"""IR pass: every collective names axes of the target's grid (port of
``repro.analysis.ir.passes.collectives``).

The port's collectives are ``torch.distributed`` calls on the process
groups of an ``NMFMesh`` (one group per axis set).  ``CostMode`` sees each
one at dispatch with the group it was issued on (``Costs.coll_groups``);
this pass names the group's axes from the target's grid
(``IRTarget.grid``) and flags a collective on a group that is no axis set
of that grid (the reference's "reduces over an axis that is not the
enclosing mesh's"), or issued by a target with no grid at all (its
"outside any shard_map").  An axis name that is not the grid's never gets
this far: ``NMFMesh`` refuses it at the call, which surfaces as an
``ir-trace`` finding.  The calls and bytes of each kind go into the
target's ``measured`` entry.

The reference's other half, that donated buffers really alias in the
compiled executable, has no eager meaning: PyTorch donates nothing and
compiles nothing, so the port checks no donation.
"""
from __future__ import annotations

from repro_torch.analysis.ir.framework import IRContext, IRPass, IRTarget, \
    register_ir_pass


def group_axes(grid) -> dict:
    """Process group name -> the axes its ranks differ along, for every
    group of ``grid`` (an ``NMFMesh``); the default group spans the axes
    of more than one rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import AXES

    out = {}
    if dist.is_available() and dist.is_initialized():
        out[dist.group.WORLD.group_name] = tuple(
            ax for ax in AXES if grid.axis_size(ax) > 1)
    for axes, group in grid.groups.items():
        if group is not None:
            out[group.group_name] = axes
    return out


@register_ir_pass
class CollectivesPass(IRPass):
    name = "collectives"
    description = ("every collective a target issues runs on an axis group "
                   "of its grid; calls and bytes by kind are recorded")

    def applies_to(self, target: IRTarget) -> bool:
        return target.kind != "kernel"

    def check(self, target: IRTarget, ctx: IRContext):
        costs = target.traced().mode.costs
        ctx.record(target, collectives=costs.collectives())
        if not costs.coll_groups:
            return
        if target.grid is None:
            for group, kinds in sorted(costs.coll_groups.items()):
                for kind in sorted(kinds):
                    yield (f"collective `{kind}` on process group {group!r} "
                           "from a target with no grid — there are no axes "
                           "to reduce over")
            return
        grid = target.grid()
        named = group_axes(grid)
        for group, kinds in sorted(costs.coll_groups.items()):
            if group in named:
                continue
            for kind in sorted(kinds):
                yield (f"collective `{kind}` on process group {group!r}, "
                       f"which is no axis group of the {grid.shape} grid "
                       f"(its groups: {sorted(named.items())}) — it "
                       "reduces over ranks the grid does not name")
