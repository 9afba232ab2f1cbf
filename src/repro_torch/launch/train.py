"""Train driver (port of ``repro.launch.train``): config -> parameters ->
a fault-tolerant training loop (checkpoint and restart, asynchronous
saves, a data pipeline whose state is the step).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke [--steps 20] [--ckpt-dir DIR --ckpt-every 10] [--device cpu]

Runs on the card unless ``--device cpu`` is given.  Fault tolerance:

* startup resumes from the newest complete checkpoint (atomic renames: a
  crash mid-save cannot corrupt it) and prints ``resuming from checkpoint
  step N``;
* the step is part of the checkpoint and the batch a pure function of
  (config, step) (:func:`synthetic_batch`), so a resumed run takes the
  uninterrupted run's batches;
* ``--deterministic`` turns on ``torch.use_deterministic_algorithms`` (the
  embedding's backward otherwise adds with atomics on the card), so a
  resumed run ends bitwise where an uninterrupted one does.

With ``--data D --model M`` above 1x1 the parameters of any family are
sharded over a ``D x M`` grid (``training/sharding.py``: the reference's
``param_pspecs`` as FSDP over ``"data"``, tensor parallelism over
``"model"`` and a moe's experts over ``"model"``), one
process a rank under ``torch.distributed.run``, the transport named by
``--dist-backend`` (``nccl``, one card a rank; ``gloo``, which also lets
several ranks share one card, or runs on the CPU):

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch llama3.2-1b --smoke \
        --data 2 --model 2 --dist-backend gloo [--device cpu]

Each rank draws the model leaf by leaf and keeps its blocks
(``sharding.init_sharded``: bitwise the blocks of the whole model's draw),
and every rank draws the same batch and takes its block; only rank 0
prints.
A world size other than ``D x M`` is refused.  Checkpoints hold whole
leaves under a 1x1 run's names in the family's layout (gathered one leaf
at a time, kept and written by rank 0), and a resume reads one leaf at a
time and keeps each rank's block: any grid shape, 1x1 included, resumes
any other (the reference's elastic restart).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import api
from repro_torch.training import AdamW, sharding


def synthetic_batch(cfg, shape: ShapeSpec, step: int,
                    device: DeviceLike = None):
    """The batch of ``step``: a pure function of (config, step), drawn on
    the host from a ``torch.Generator`` seeded from (1234, step) and moved
    to ``device``, so the CPU and the card see the same batches.  It is
    not the reference's (``jax.random`` cannot be reproduced), so parity
    tests hand both packages their batches."""
    seed = int(np.random.SeedSequence([1234, int(step)]).generate_state(
        1, np.uint64)[0])
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return api.make_batch(cfg, shape, gen, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--deterministic", action="store_true",
                    help="deterministic kernels (bitwise resumes on the "
                         "card)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="collective transport of a grid run: nccl (one "
                         "card a rank) or gloo (ranks may share a card, or "
                         "run on the CPU)")
    args = ap.parse_args(argv)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)
    grid = args.data * args.model
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.data < 1 or args.model < 1:
        ap.error(f"--data {args.data} --model {args.model}: both must be "
                 "at least 1")
    if world != grid:
        ap.error(f"--data {args.data} --model {args.model} needs {grid} "
                 f"ranks, have {world}: start them with python -m "
                 f"torch.distributed.run --nproc-per-node {grid}")

    if args.deterministic:
        # cuBLAS is deterministic only with a fixed workspace; read when
        # the first handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    device = resolve_device(args.device)
    rank = 0
    if grid > 1:
        if args.dist_backend == "nccl" and device.type != "cuda":
            ap.error("--dist-backend nccl needs the card; use gloo with "
                     "--device cpu")
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            device = resolve_device(
                f"cuda:{local % torch.cuda.device_count()}")
            torch.cuda.set_device(device)
        dist.init_process_group(args.dist_backend, init_method="env://")
        rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt = AdamW(total_steps=max(args.steps, 2))
    shards = None
    if grid > 1:
        # drawn leaf by leaf into the rank's blocks: no rank holds the
        # whole model
        params, shards = sharding.init_sharded(
            cfg, make_local_mesh(args.data, args.model, device), 0, device)
    else:
        params = api.init_params(cfg, 0, device=device)
    opt_state = opt.init(params)

    def state():
        """The tree a checkpoint holds: whole leaves (on rank 0 only; None
        on the other ranks of a grid)."""
        if shards is None:
            return params, opt_state
        return sharding.gather_state(params, opt_state, shards)

    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir) if rank == 0 else None
        last = latest_step(args.ckpt_dir)
        if last is not None:
            say(f"resuming from checkpoint step {last}", flush=True)
            if shards is None:
                restore_checkpoint(args.ckpt_dir, last, (params, opt_state))
            else:
                sharding.restore_state(args.ckpt_dir, last, params,
                                       opt_state, shards)
            start = last

    step_fn = (api.make_train_step(cfg, opt) if shards is None
               else sharding.make_train_step(cfg, opt, shards))
    t0 = time.time()
    for step in range(start, args.steps):
        batch = synthetic_batch(cfg, shape, step, device)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            say(f"step {step:5d}  loss {float(loss):.4f}  "
                f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            tree = state()
            if ckpt:
                ckpt.save(step + 1, tree, family=cfg.family)
    if args.ckpt_dir:
        tree = state()
        if ckpt:
            ckpt.save(args.steps, tree, family=cfg.family)
            ckpt.wait()
            st = ckpt.stats
            print(f"checkpoints: {st['saves']} saves, "
                  f"{st['copy_s'] / st['saves']:.4f} s each on the caller "
                  f"(device to host), {st['write_s'] / st['saves']:.4f} s "
                  "each on the writer thread", flush=True)
    if grid > 1:
        dist.destroy_process_group()
    say("done")


if __name__ == "__main__":
    main()
