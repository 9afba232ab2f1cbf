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

One process trains on one device.  The parameter sharding of ``--data`` /
``--model`` above 1 (the reference's ``param_pspecs``: FSDP and tensor
parallelism) is not ported and is refused.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.training import AdamW


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
    args = ap.parse_args(argv)
    if args.data != 1 or args.model != 1:
        ap.error(f"--data {args.data} --model {args.model}: sharding the "
                 "parameters over a mesh (param_pspecs, FSDP / TP) is not "
                 "ported (ROADMAP queue 1, the item \"parameter "
                 "sharding\"); run with --data 1 "
                 "--model 1")

    if args.deterministic:
        # cuBLAS is deterministic only with a fixed workspace; read when
        # the first handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    device = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt = AdamW(total_steps=max(args.steps, 2))
    params = api.init_params(cfg, 0, device=device)
    opt_state = opt.init(params)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            print(f"resuming from checkpoint step {last}", flush=True)
            params, opt_state = restore_checkpoint(args.ckpt_dir, last,
                                                   (params, opt_state))
            start = last

    step_fn = api.make_train_step(cfg, opt)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = synthetic_batch(cfg, shape, step, device)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {float(loss):.4f}  "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state))
    if ckpt:
        ckpt.save(args.steps, (params, opt_state))
        ckpt.wait()
        st = ckpt.stats
        print(f"checkpoints: {st['saves']} saves, "
              f"{st['copy_s'] / st['saves']:.4f} s each on the caller "
              f"(device to host), {st['write_s'] / st['saves']:.4f} s each "
              "on the writer thread", flush=True)
    print("done")


if __name__ == "__main__":
    main()
