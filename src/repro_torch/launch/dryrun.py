"""The dry-run on the ``meta`` device: every (architecture x input shape)
cell, and the paper's pod-scale NMF fit, on the reference's production
grid of 16 x 16 (``--multi-pod``: 2 x 16 x 16) ranks, without a card (the
counterpart of ``repro.launch.dryrun``, which lowers and compiles against
512 placeholder host devices).

Usage (no card, no XLA; each cell's wall time is printed):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out out.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --nmf [--multi-pod]

A process of its own plays rank 0 of the grid: :func:`fake_world` starts
a ``fake`` process group of 256 or 512 ranks, whose collectives return at
once and are counted as on a real grid (``launch.mesh.
make_production_mesh`` builds the grid only there).  The model is built on
``meta`` (``convert._model``), its parameters and the batch or decode
state sharded by the reference's ``param_pspecs`` / ``batch_pspecs`` /
``cache_pspecs`` under :data:`RULES`, and the step runs under a
``launch.cost_analysis.CostMode``: FLOPs, bytes, collectives, kernel
launches and the peak of live bytes, loops scaled by their trip counts.
This is not the CPU path and not a fallback: it never touches a card (and
refuses ``--device cuda``).

A record has the reference's keys (``status``, ``flops``,
``bytes_accessed``, ``argument_bytes``, ``output_bytes``, ``temp_bytes``,
``alias_bytes``, ``bytes_per_device``), plus ``collectives`` (calls and
bytes by kind), ``launches`` (by kernel) and ``wall_s``.
``argument_bytes`` is a rank's exactly, for every cell: each dim of each
argument divided by the product of the sizes of its spec's axes
(parameters, AdamW's μ / ν / count, the batch; or the decode state, the
token and the position).

* ``ok`` — rank 0's sharded step ran under the counter: ``train_4k``
  (``training/sharding.py``, AdamW, remat, 4 microbatches, as the
  reference; ``init_bytes`` is the peak of the launcher's init,
  ``training/sharding.py::init_sharded``: the rank's blocks and one whole
  leaf), ``prefill_32k`` and the decode cells (``serving/sharding.py``:
  the rank's parameter blocks, batch block and decode-state blocks; a
  decode step donates its state, as the reference's ``donate_argnums=(1,)``,
  so the state counts among the outputs that alias arguments).
  ``bytes_per_device`` is the step's peak of live bytes.
* ``skipped`` — the reference's undefined cells (``cell_supported``).
* ``error`` — an exception, as in the reference.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Mapping

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, cell_supported
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.cost_analysis import CostMode, tree_bytes
from repro_torch.models import api
from repro_torch.models.common import ArchConfig

__all__ = ["RULES", "fake_world", "spec_bytes", "argument_bytes",
           "lower_cell", "run_cell", "main"]

#: the reference dry-run's rules
RULES = {"fsdp": "data", "tp": "model", "ep": "model"}
#: microbatches of a train step, as the reference's dry-run
MICROBATCHES = 4


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (``torch.testing``'s ``FakeStore``): a grid made on it issues
    its collectives to no one, at once.  The group is destroyed on exit.
    Refuses to start while another group is initialized."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry-run's fake world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    world_id = id(dist.group.WORLD)
    try:
        yield
    finally:
        dist.destroy_process_group()
        for key in [k for k in mesh_mod._MESHES if k[3] == world_id]:
            del mesh_mod._MESHES[key]


def spec_bytes(shape, dtype, spec, mesh) -> int:
    """Bytes of a rank's block of a ``shape`` / ``dtype`` array sharded by
    ``spec`` (a tuple over its dims of None, an axis name or a tuple of
    names) on ``mesh``: each dim divided by the product of its axes'
    sizes."""
    sizes = api._axis_sizes(mesh)
    n = 1
    for i, d in enumerate(shape):
        axes = spec[i] if spec is not None and i < len(spec) else None
        if axes is None:
            div = 1
        elif isinstance(axes, str):
            div = sizes.get(axes, 1)
        else:
            div = math.prod(sizes.get(a, 1) for a in axes)
        if d % div:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {axes} ({div})")
        n *= d // div
    return n * torch.empty((), dtype=dtype).element_size()


def _tree_spec_bytes(tree, specs, mesh) -> int:
    if tree is None:
        return 0
    if isinstance(tree, Mapping):
        return sum(_tree_spec_bytes(v, specs[k], mesh)
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_spec_bytes(v, s, mesh) for v, s in zip(tree, specs))
    return spec_bytes(tree.shape, tree.dtype, specs, mesh)


def _batch_axes(shape: ShapeSpec, mesh):
    dp = api.batch_axes_for(shape.global_batch, mesh, ("pod", "data"))
    return dp if dp else None


def argument_bytes(cfg: ArchConfig, shape: ShapeSpec, mesh,
                   model=None, cache=None) -> int:
    """A rank's bytes of the step's arguments on ``mesh``, by the specs:
    f32 parameters; for ``train`` AdamW's f32 μ and ν and its int32 count,
    and the batch; for ``prefill`` the batch; for ``decode`` the decode
    state (``api.init_decode_cache``), the token and the int32 position.
    ``model`` / ``cache`` are the meta ones when the caller has them."""
    from repro_torch.convert import _model

    model = _model(cfg, "meta") if model is None else model
    pspecs = api.param_pspecs(cfg, model, RULES, mesh=mesh)
    params = sum(spec_bytes(p.shape, p.dtype, pspecs[n], mesh)
                 for n, p in model.named_parameters())
    if shape.kind == "train":
        state = 2 * sum(spec_bytes(p.shape, torch.float32, pspecs[n], mesh)
                        for n, p in model.named_parameters()) + 4
        return params + state + _batch_bytes(cfg, shape, mesh)
    if shape.kind == "prefill":
        return params + _batch_bytes(cfg, shape, mesh)
    if cache is None:
        cache = api.init_decode_cache(cfg, shape, device="meta")
    cspecs = api.cache_pspecs(cfg, shape, mesh, cache)
    token = spec_bytes((shape.global_batch,), torch.int32,
                       (_batch_axes(shape, mesh),), mesh)
    return params + _tree_spec_bytes(cache, cspecs, mesh) + token + 4


def _batch_bytes(cfg, shape, mesh) -> int:
    specs = api.batch_pspecs(cfg, shape, mesh)
    return sum(spec_bytes(s.shape, s.dtype, specs[n], mesh)
               for n, s in api.input_specs(cfg, shape).items())


def _meta_batch(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for n, s in api.input_specs(cfg, shape).items()}


def _counted(mode: CostMode, rec: Dict[str, Any]) -> None:
    c = mode.costs
    rec["collectives"] = c.collectives()
    rec["launches"] = dict(c.launches)
    rec["kernel_flops"] = dict(c.kernel_flops)
    rec["kernel_bytes"] = dict(c.kernel_bytes)


def lower_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
               microbatches: int = MICROBATCHES) -> Dict[str, Any]:
    """Run one cell's step on ``meta`` under a :class:`CostMode` and return
    its counts (the record's fields but ``status`` and ``wall_s``).
    ``mesh`` is rank 0's ``NMFMesh`` of a fake world."""
    from repro_torch.convert import _model
    from repro_torch.training import sharding
    from repro_torch.training.optimizer import AdamW

    model = _model(cfg, "meta")
    cache = (api.init_decode_cache(cfg, shape, device="meta")
             if shape.kind == "decode" else None)
    rec: Dict[str, Any] = {
        "argument_bytes": argument_bytes(cfg, shape, mesh, model, cache)}
    if shape.kind == "train":
        # the launcher's init (leaf by leaf into the blocks), its peak
        # counted on a whole meta model made outside the counter
        whole, init = _model(cfg, "meta"), CostMode()
        with init:
            sharding.init_sharded(cfg, mesh, 0, "meta", model=whole)
        rec["init_bytes"] = init.peak_bytes
        del whole
        opt = AdamW()
        shards = sharding.shard_model(model, mesh)
        state = opt.init(model)
        step = sharding.make_train_step(cfg, opt, shards,
                                        microbatches=microbatches)
        batch = _meta_batch(cfg, shape)
        specs = api.batch_pspecs(cfg, shape, mesh)
        block = sum(spec_bytes(t.shape, t.dtype, specs[n], mesh)
                    for n, t in batch.items())
        mode = CostMode()
        with mode:
            args = mode.track(model, state) + mode.track_as(batch, block)
            _, _, loss = step(model, state, batch)
            out = tree_bytes(loss)
        # parameters and moments are updated in place (the reference
        # donates them): the outputs that alias arguments
        alias = tree_bytes((model, state))
        rec.update(
            flops=mode.costs.flops, bytes_accessed=mode.costs.hbm_bytes,
            output_bytes=out + alias, alias_bytes=alias,
            temp_bytes=max(mode.peak_bytes - args - out, 0),
            bytes_per_device=mode.peak_bytes,
            state_bytes=tree_bytes((model, state.mu, state.nu)))
        _counted(mode, rec)
        return rec
    from repro_torch.serving import sharding as serving

    shards = sharding.shard_model(model, mesh)
    if shape.kind == "prefill":
        batch = _meta_batch(cfg, shape)
        block = _batch_bytes(cfg, shape, mesh)
        step = serving.make_prefill_step(cfg, shards)
        mode = CostMode()
        with mode:
            args = mode.track(model) + mode.track_as(batch, block)
            out = tree_bytes(step(model, batch))
        alias = 0
    else:
        state = serving.init_sharded_cache(cfg, shape, mesh, "meta")
        token = torch.empty((shape.global_batch,), dtype=torch.int32,
                            device="meta")
        tok_block = spec_bytes(token.shape, token.dtype,
                               (_batch_axes(shape, mesh),), mesh)
        step = serving.make_decode_step(cfg, shards)
        mode = CostMode()
        with mode:
            args = (mode.track(model, state.blocks)
                    + mode.track_as(token, tok_block))
            logits, _ = step(model, state, token, shape.seq_len - 1)
            out = tree_bytes(logits)
        # the state is updated in place (the reference donates it)
        alias = serving.cache_bytes(state)
        rec["state_bytes"] = alias
    rec.update(
        flops=mode.costs.flops, bytes_accessed=mode.costs.hbm_bytes,
        output_bytes=out + alias, alias_bytes=alias,
        temp_bytes=max(mode.peak_bytes - args - out, 0),
        bytes_per_device=mode.peak_bytes)
    _counted(mode, rec)
    return rec


def run_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, verbose: bool = True
             ) -> Dict[str, Any]:
    """One cell's record (see the module's docstring)."""
    t0 = time.perf_counter()
    rec: Dict[str, Any] = {"arch": cfg.name, "shape": shape.name,
                           "mesh": "x".join(map(str, mesh.shape))}
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        rec.update(lower_cell(cfg, shape, mesh))
        rec["status"] = "ok"
    except Exception as e:  # a cell's failure is its record (the reference's)
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        if verbose:
            traceback.print_exc()
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    if verbose and rec["status"] != "error":
        gib = rec["argument_bytes"] / 2 ** 30
        line = f"  argument {gib:.2f} GiB/device"
        if rec["status"] == "ok":
            line += (f", peak {rec['bytes_per_device'] / 2 ** 30:.2f} "
                     "GiB/device"
                     + (f" (init {rec['init_bytes'] / 2 ** 30:.2f})"
                        if "init_bytes" in rec else "")
                     + f", flops={rec['flops']:.3e} "
                     f"bytes={rec['bytes_accessed']:.3e}")
        print(f"{line} ({rec['wall_s']:.1f} s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--nmf", action="store_true",
                    help="dry-run the paper's large NMF workload instead")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--device", default="meta",
                    help="the dry-run runs on the meta device only")
    args = ap.parse_args(argv)
    if args.device != "meta":
        ap.error(f"--device {args.device}: the dry-run runs on the meta "
                 "device only; it never touches a card")
    if not (args.all or args.arch or args.nmf):
        ap.error("give --arch, --all or --nmf")

    records = []
    with fake_world(512 if args.multi_pod else 256):
        mesh = mesh_mod.make_production_mesh(multi_pod=args.multi_pod)
        if args.nmf:
            from repro_torch.launch.nmf_run import nmf_dryrun_cell

            rec = nmf_dryrun_cell(mesh)
            print(json.dumps(rec, indent=1))
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            return 0 if rec["status"] == "ok" else 1
        if args.all:
            cells = [(c, s) for c in ARCHS.values() for s in SHAPES.values()]
        else:
            cfg = ARCHS[args.arch]
            shapes = ([SHAPES[args.shape]] if args.shape
                      else list(SHAPES.values()))
            cells = [(cfg, s) for s in shapes]
        for cfg, shape in cells:
            print(f"== {cfg.name} x {shape.name} x mesh{mesh.shape} ==",
                  flush=True)
            rec = run_cell(cfg, shape, mesh)
            records.append(rec)
            print(f"  -> {rec['status']}"
                  + (f" ({rec.get('reason', '')})"
                     if rec["status"] == "skipped" else ""), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\n{len(records)} cells: "
          f"{sum(r['status'] == 'ok' for r in records)} ok, "
          f"{sum(r['status'] == 'skipped' for r in records)} skipped, "
          f"{n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
