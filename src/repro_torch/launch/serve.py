"""Serving launcher: bring up a ServingEngine for an architecture and run a
synthetic request load (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        [--requests 16] [--max-batch 4] [--max-seq 128] [--device cpu]

Runs on the card unless ``--device cpu`` is given.  As in the reference,
``--smoke`` is on by default and cannot be switched off (ROADMAP queue 3),
so the launcher always serves the reduced config.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (always on, as in the reference)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(ARCHS[args.arch]) if args.smoke else ARCHS[args.arch]
    if cfg.family == "encdec":
        raise SystemExit("enc-dec serving uses repro_torch.models.encdec."
                         "prefill / decode_step directly (see "
                         "tests/test_torch_encdec.py)")
    params = api.init_params(cfg, 0, device=device)
    engine = ServingEngine(cfg, params, max_batch=args.max_batch,
                           max_seq=args.max_seq, device=device)
    gen = torch.Generator().manual_seed(1)
    for rid in range(args.requests):
        prompt = torch.randint(3, cfg.vocab, (8,), generator=gen).tolist()
        engine.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))

    t0 = time.time()
    ticks = 0
    emitted_total = 0
    while engine.queue or any(s is not None for s in engine.slots):
        emitted_total += len(engine.step())
        ticks += 1
        if ticks > 10_000:
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU")
    print(f"{args.requests} requests, {emitted_total} tokens in "
          f"{ticks} engine ticks / {dt:.1f}s "
          f"({emitted_total/max(dt,1e-9):.1f} tok/s on {where})")


if __name__ == "__main__":
    main()
