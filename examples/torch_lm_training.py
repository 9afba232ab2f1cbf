"""LM training example of the PyTorch/CUDA port (the port of
``examples/lm_training.py``): any of the ten architectures at reduced
scale, with optional top-k gradient compression (the paper's projection
applied to the data-parallel gradient exchange).

    PYTHONPATH=src python examples/torch_lm_training.py --arch llama3.2-1b --steps 20
    PYTHONPATH=src python examples/torch_lm_training.py --arch olmoe-1b-7b --compress
    PYTHONPATH=src python examples/torch_lm_training.py --device cpu   # plain versions

It runs on the card unless ``--device cpu`` is given; without a card and
without that flag it raises.  The parameters come from ``api.init_params``
(seed 0, on the device) and step ``s``'s batch from ``api.make_batch(...,
seed=s)``; the reference draws both from ``jax.random``, which torch
cannot reproduce, so the losses differ from the reference's run.  Every
family trains on the plain attention path, as the reference trains; an
encoder-decoder's loss is ``seq2seq_loss``.  ``--compress`` runs on the
one-rank grid of ``launch/mesh.py::make_local_mesh`` (1x1, no process
group): the reference's ``jax.make_mesh((device_count,), ("data",))`` on
one card.  ``make_step`` and ``train`` take their inputs explicitly, so
that a caller can hand both packages the same parameters and batches.
"""
import argparse
import time

from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.device import device_name, resolve_device, synchronize
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import api
from repro_torch.training import (
    AdamW, init_error_state, make_compressed_grad_fn,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--compress", action="store_true",
                    help="top-k gradient compression + error feedback")
    ap.add_argument("--density", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' (plain versions)")
    return ap.parse_args(argv)


def make_step(cfg, opt: AdamW, params, compress: bool = False,
              density: float = 0.05):
    """``step(params, opt_state, err, batch) -> (params, opt_state, err,
    loss)``: ``api.make_train_step``'s step (``err`` passes through as
    None), or with ``compress`` the top-``density`` compressed gradient with
    error feedback on the one-rank grid, then ``opt.update``.  Returns the
    step and the first ``err``."""
    if not compress:
        plain = api.make_train_step(cfg, opt)

        def step(params, opt_state, err, batch):
            params, opt_state, loss = plain(params, opt_state, batch)
            return params, opt_state, err, loss

        return step, None
    mesh = make_local_mesh(device=next(params.parameters()).device)
    grad_fn = make_compressed_grad_fn(api.make_loss_fn(cfg), mesh,
                                      ("data",), density=density)

    def step(params, opt_state, err, batch):
        loss, grads, err = grad_fn(params, batch, err)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, err, loss

    return step, init_error_state(params, mesh.axis_size("data"))


def train(step, params, opt_state, err, batches, note: str = ""):
    """One step a batch of ``batches`` (an iterable, drawn as the steps
    ask), one line a step: its loss and seconds (host clock, ending in the
    loss read).  Returns the losses and the seconds."""
    losses, seconds = [], []
    for s, batch in enumerate(batches):
        t0 = time.perf_counter()
        params, opt_state, err, loss = step(params, opt_state, err, batch)
        loss = float(loss)
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"step {s:3d} loss {loss:.4f} ({note}{seconds[-1]:.2f}s)")
    return dict(losses=losses, seconds=seconds)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device_name(device)}")

    cfg = smoke_config(ARCHS[args.arch])
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt = AdamW(total_steps=args.steps, lr=1e-3)
    params = api.init_params(cfg, 0, device=device)
    opt_state = opt.init(params)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params (reduced config)")

    step, err = make_step(cfg, opt, params, args.compress, args.density)
    note = (f"top-{args.density:.0%} compressed grads, " if args.compress
            else "")
    batches = (api.make_batch(cfg, shape, seed=s, device=device)
               for s in range(args.steps))
    out = train(step, params, opt_state, err, batches, note)
    synchronize(device)
    out.update(device=device_name(device), arch=cfg.name,
               n_params=n_params)
    return out


if __name__ == "__main__":
    main()
