#!/usr/bin/env python3
"""Time three ways of counting the MoE dispatch's expert slots on one card,
in turns, at olmoe-1b-7b's full width:

    python3 tools/moe_slots_ab.py

* ``outer``: the reference's running sum over a (T * k, E) one-hot along
  T * k (``src/repro/models/moe.py:67-69``);
* ``sort``: the port's ``models/moe.py::expert_slots`` (a stable sort by
  expert, each pair's place less its expert's start);
* ``inner``: the one-hot transposed to (E, T * k) and summed along its
  last dim.

All three give the same slots and kept pairs (checked).  Prints the card's
name and power limit, then each variant's time alone (host clock, ending
in a synchronize, median of 20) at 16,384, 4,096 and 8 tokens, and, with
each variant in place, the 4 x 4096 prefill (median of 3) and a decode
tick at batch 8 (median of 10) of the full model, and a train step of the
model cut to 4 layers (2 x 4096 tokens, 2 microbatches, median of 3), in
two rounds of opposite order.  Exits 2 without a CUDA device.
"""
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("moe_slots_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import api, moe
    from repro_torch.training import AdamW

    def outer(sel, e, cap):
        e_flat = sel.reshape(sel.shape[0], -1)
        onehot = F.one_hot(e_flat, e)
        pos = torch.cumsum(onehot, 1) - onehot
        my = torch.gather(pos, 2, e_flat[..., None])[..., 0]
        keep = my < cap
        return e_flat * cap + torch.where(keep, my, torch.zeros_like(my)), keep

    def inner(sel, e, cap):
        e_flat = sel.reshape(sel.shape[0], -1)
        onehot = F.one_hot(e_flat, e).transpose(1, 2).contiguous()
        pos = torch.cumsum(onehot, 2) - onehot
        my = torch.gather(pos, 1, e_flat[:, None, :])[:, 0]
        keep = my < cap
        return e_flat * cap + torch.where(keep, my, torch.zeros_like(my)), keep

    variants = {"outer": outer, "sort": moe.expert_slots, "inner": inner}

    def host_ms(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = ARCHS["olmoe-1b-7b"]
    e, k = cfg.n_experts, cfg.moe_top_k
    gen = torch.Generator(device=dev).manual_seed(0)
    for tokens in (16384, 4096, 8):
        logits = torch.randn((1, tokens, e), device=dev, generator=gen)
        sel = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[..., :k]
        cap = max(int(np.ceil(tokens * k / e * 1.25)), k)
        want = outer(sel, e, cap)
        for name, fn in variants.items():
            got = fn(sel, e, cap)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} counts other slots")
            ms = host_ms(lambda: fn(sel, e, cap), 20)
            print(f"slots {name}, {tokens} tokens: {np.median(ms):.4f} ms",
                  flush=True)
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    batch = api.make_batch(cfg, ShapeSpec("p", 4096, 4, "prefill"), seed=1,
                           device=dev)
    step, decode = api.make_prefill_step(cfg), api.make_decode_step(cfg)
    cache = moe.init_cache(cfg, 8, 512, device=dev)
    tok = torch.randint(0, cfg.vocab, (8,), device=dev, dtype=torch.int32)
    step(model, batch)
    orders = (("outer", "sort", "inner"), ("inner", "sort", "outer"))
    for rnd, order in enumerate(orders):
        for name in order:
            moe.expert_slots = variants[name]
            pre = host_ms(lambda: step(model, batch), 3)
            dec = host_ms(lambda: decode(model, cache, tok, 64), 10)
            print(f"round {rnd} {name}: prefill {np.median(pre):.2f} ms "
                  f"{[round(x, 2) for x in pre]}; decode tick "
                  f"{np.median(dec):.3f} ms", flush=True)
    del model, cache
    torch.cuda.empty_cache()
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    model = api.init_params(cfg4, 0, device=dev)
    opt = AdamW()
    state = opt.init(model)
    train = api.make_train_step(cfg4, opt, microbatches=2)
    b = synthetic_batch(cfg4, ShapeSpec("t", 4096, 2, "train"), 0, dev)
    train(model, state, b)
    for rnd, order in enumerate(orders):
        for name in order:
            moe.expert_slots = variants[name]
            ms = host_ms(lambda: train(model, state, b), 3)
            print(f"round {rnd} {name}: train step {np.median(ms):.1f} ms "
                  f"{[round(x, 1) for x in ms]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
