"""Batched serving example of the PyTorch/CUDA port (the port of
``examples/serving.py``): a continuous-batching ``ServingEngine`` over a
reduced llama config takes a wave of requests and drains them.

    PYTHONPATH=src python examples/torch_serving.py                # on the card
    PYTHONPATH=src python examples/torch_serving.py --device cpu

It runs on the card unless ``--device cpu`` is given; without a card and
without that flag it raises.  The parameters are drawn by
``api.init_params`` from seed 0 on the device, and the prompts (8 of 6
tokens, each in [3, vocab)) from a CPU ``torch.Generator`` seeded 1; the
reference draws both from ``jax.random``, which torch cannot reproduce, so
the tokens differ from the reference's run.  The engine keeps the
reference's scheduling, faults included (``serving/engine.py``): every
prompt token is fed through a decode step of all slots, so concurrent
requests change each other's tokens.  ``prompts`` and ``drain`` take their
inputs explicitly, so that a caller can hand both packages the same ones.
"""
import argparse
import time

import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.device import device_name, resolve_device, synchronize
from repro_torch.models import api
from repro_torch.serving import Request, ServingEngine

ARCH = "llama3.2-1b"
#: the wave: requests, prompt length, new tokens a request, the engine's
#: slots and cache length, and the tick cap of the reference's loop
REQUESTS, PROMPT, MAX_NEW = 8, 6, 8
MAX_BATCH, MAX_SEQ, MAX_TICKS = 4, 64, 200


def prompts(vocab: int, n: int = REQUESTS, length: int = PROMPT,
            seed: int = 1):
    """``n`` prompts of ``length`` token ids in [3, vocab), drawn on the
    CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(3, vocab, (n, length), generator=gen).tolist()


def drain(engine, requests, max_ticks: int = MAX_TICKS):
    """The reference's tick loop: submit every request, then step the
    engine until the queue and the slots are empty (at most ``max_ticks``
    + 1 ticks), one line a tick that emitted tokens.  Returns the ticks,
    the tokens emitted by tick and the seconds."""
    for req in requests:
        engine.submit(req)
    print(f"{len(requests)} requests submitted; engine slots: "
          f"{engine.max_batch}")
    t0 = time.perf_counter()
    ticks, emitted_by_tick = 0, []
    while engine.queue or any(s is not None for s in engine.slots):
        emitted = engine.step()
        ticks += 1
        emitted_by_tick.append(dict(sorted(emitted.items())))
        if emitted:
            print(f"tick {ticks:3d}: " + "  ".join(
                f"req{r}->{t}" for r, t in sorted(emitted.items())))
        if ticks > max_ticks:
            break
    synchronize(engine.device)
    secs = time.perf_counter() - t0
    print(f"drained in {ticks} ticks, {secs:.1f}s "
          f"(continuous batching: slots refill as requests finish)")
    return dict(ticks=ticks, emitted=emitted_by_tick, seconds=secs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' (plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device_name(device)}")

    cfg = smoke_config(ARCHS[ARCH])
    params = api.init_params(cfg, 0, device=device)
    engine = ServingEngine(cfg, params, max_batch=MAX_BATCH,
                           max_seq=MAX_SEQ, device=device)
    requests = [Request(rid=rid, prompt=p, max_new=MAX_NEW)
                for rid, p in enumerate(prompts(cfg.vocab))]
    out = drain(engine, requests)
    out.update(device=device_name(device),
               outputs={req.rid: list(req.out) for req in requests})
    return out


if __name__ == "__main__":
    main()
