"""Per-architecture API of the LM substrate (port of ``repro.models.api``):
init, input specs, random batches, the loss and the train step, and the
serving steps.

Every family of the reference is ported: ``dense`` and ``vlm``
(``models/transformer.py``), ``moe`` (``models/moe.py``), ``hybrid``
(``models/hybrid.py``), ``ssm`` (``models/xlstm.py``) and ``encdec``
(``models/encdec.py``: its loss is ``seq2seq_loss``, its prefill step
returns the encoder memory, its decode cache holds the cross K / V).  The
sharding specs (``param_pspecs`` and the rest: one card, no FSDP / TP
mesh) are not ported.

The function that makes a step names its attention path: the serving
steps take the flash kernel, the loss and the train step the
differentiable plain path (the kernel has no backward; the reference
trains with it off).
"""
from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Callable, Dict, NamedTuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, hybrid, moe, transformer, xlstm
from repro_torch.models.common import ArchConfig
from repro_torch.training.optimizer import (
    AdamW,
    named_parameters,
    value_and_grad,
)

if TYPE_CHECKING:  # repro_torch.configs imports this package
    from repro_torch.configs import ShapeSpec

__all__ = ["FAMILY", "TensorSpec", "module_for", "input_specs", "make_batch",
           "make_loss_fn", "make_train_step", "make_prefill_step",
           "make_decode_step", "init_params", "init_decode_cache"]

FAMILY = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
    "hybrid": hybrid,
    "ssm": xlstm,
    "encdec": encdec,
}


def module_for(cfg: ArchConfig):
    if cfg.family not in FAMILY:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is unknown")
    return FAMILY[cfg.family]


def _dec_len(cfg: ArchConfig, frames: int) -> int:
    """An encdec decoder's length for ``frames`` encoder frames (the
    audio-to-text compression ``dec_ratio``, at least 16)."""
    return max(frames // cfg.dec_ratio, 16)


class TensorSpec(NamedTuple):
    """Shape and dtype of one input (the port's ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    module_for(cfg)
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.family == "encdec":
        dec = _dec_len(cfg, s)
        if shape.kind == "train":
            return {"frame_embeds": TensorSpec((b, s, cfg.d_model), bf16),
                    "tokens": TensorSpec((b, dec), i32),
                    "labels": TensorSpec((b, dec), i32)}
        if shape.kind == "prefill":
            return {"frame_embeds": TensorSpec((b, s, cfg.d_model), bf16)}
        return {"token": TensorSpec((b,), i32)}   # decode
    if cfg.family == "vlm":
        text = s - cfg.n_patches
        patches = TensorSpec((b, cfg.n_patches, cfg.d_model), bf16)
        if shape.kind == "train":
            return {"tokens": TensorSpec((b, text), i32),
                    "labels": TensorSpec((b, text), i32),
                    "patch_embeds": patches}
        if shape.kind == "prefill":
            return {"tokens": TensorSpec((b, text), i32),
                    "patch_embeds": patches}
        return {"token": TensorSpec((b,), i32)}
    if shape.kind == "train":
        return {"tokens": TensorSpec((b, s), i32),
                "labels": TensorSpec((b, s), i32)}
    if shape.kind == "prefill":
        return {"tokens": TensorSpec((b, s), i32)}
    return {"token": TensorSpec((b,), i32)}       # decode: one new token


def _generator(seed: Union[int, torch.Generator], device: torch.device
               ) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def make_batch(cfg: ArchConfig, shape: ShapeSpec,
               seed: Union[int, torch.Generator] = 0,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random concrete batch matching :func:`input_specs`: token ids
    uniform in [0, vocab), embeddings standard normal cast to their dtype.
    ``seed`` is an int or a ``torch.Generator`` (drawn on its device)."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if spec.dtype == torch.int32:
            x = torch.randint(0, cfg.vocab, spec.shape, generator=gen,
                              device=gen.device, dtype=torch.int32)
        else:
            x = torch.randn(spec.shape, generator=gen,
                            device=gen.device).to(spec.dtype)
        out[name] = x.to(dev)
    return out


def make_loss_fn(cfg: ArchConfig, remat: bool = True,
                 compute_dtype=torch.bfloat16) -> Callable:
    """``loss_fn(params, batch)`` -> scalar f32: the family's ``lm_loss``
    (``encdec``: ``seq2seq_loss``) on the plain attention path, its layers
    in ``compute_dtype`` (the reference's default bf16; f32 for checks at
    the reference's f32 bars)."""
    mod = module_for(cfg)
    loss = mod.seq2seq_loss if cfg.family == "encdec" else mod.lm_loss
    return functools.partial(loss, cfg=cfg, remat=remat,
                             compute_dtype=compute_dtype)


def make_train_step(cfg: ArchConfig, opt: AdamW, remat: bool = True,
                    microbatches: int = 1, compute_dtype=torch.bfloat16
                    ) -> Callable:
    """``train_step(params, opt_state, batch)`` -> ``(params, opt_state,
    loss)``: one optimizer step, the parameters and the optimizer state
    updated in place.  ``microbatches`` > 1 splits the batch's leading axis
    into that many equal parts run one after the other (activation memory
    / M), accumulating f32 gradients divided by M in one parameter-sized
    buffer and the loss divided by M."""
    loss_fn = make_loss_fn(cfg, remat, compute_dtype)
    m = int(microbatches)
    if m < 1:
        raise ValueError(f"microbatches must be at least 1, got "
                         f"{microbatches}")

    def train_step(params, opt_state, batch):
        if m == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % m:
                raise ValueError(f"batch {b} does not split into {m} "
                                 "microbatches")
            n = b // m
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named_parameters(params).items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=grads[next(iter(grads))].device)
            for i in range(m):
                micro = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                l, g = value_and_grad(loss_fn, params, micro)
                for k, gi in g.items():
                    grads[k].add_(gi.float() / m)
                loss = loss + l / m
                del g
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """``prefill_step(params, batch)`` -> next-token logits (B, vocab) in
    f32: the full forward in bf16 without autograd, last position.  For
    ``encdec`` it is the encoder memory (B, S, d) in bf16, as the
    reference's."""
    mod = module_for(cfg)

    def prefill_step(params, batch):
        with torch.no_grad():
            if cfg.family == "encdec":
                return mod.encode(params, batch["frame_embeds"], cfg,
                                  remat=False)
            logits = mod.forward(params, batch["tokens"], cfg,
                                 extra_embeds=batch.get("patch_embeds"))
            return logits[:, -1, :].clone()   # frees the (B, S, vocab) rest

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """``decode_step(params, cache, token, pos)`` -> (logits, cache), without
    autograd; the cache is updated in place."""
    mod = module_for(cfg)

    def decode_step(params, cache, token, pos):
        return mod.decode_step(params, cache, token, pos, cfg)

    return decode_step


def init_params(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0,
                dtype=torch.float32, device: DeviceLike = None):
    """Random parameters (the reference initialises at random too; nothing
    is downloaded), drawn on ``device`` (the card unless the CPU is asked
    for) from ``seed``: an int, or a generator on that device."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters asked for "
                         f"on {dev}")
    return module_for(cfg).init_params(gen, cfg, dtype)


def init_decode_cache(cfg: ArchConfig, shape: ShapeSpec,
                      dtype=torch.bfloat16, device: DeviceLike = None):
    """The zeroed decode state of a shape cell: the KV cache ((L, B,
    seq_len, Hkv, hd) each; a hybrid's Mamba states beside its shared
    block's K and V; an ``encdec`` decoder's K and V of ``max(seq_len //
    dec_ratio, 16)`` rows beside the cross K / V of ``seq_len`` frames),
    or for ``ssm`` the recurrent states, one dict a layer, whose size does
    not depend on ``seq_len`` (and ``dtype`` does not apply: they are
    f32)."""
    mod, dev = module_for(cfg), resolve_device(device)
    if cfg.family == "ssm":
        return mod.init_state(cfg, shape.global_batch, device=dev)
    if cfg.family == "encdec":
        s = shape.seq_len
        return mod.init_cache(cfg, shape.global_batch,
                              max_dec=_dec_len(cfg, s),
                              enc_len=s, dtype=dtype, device=dev)
    return mod.init_cache(cfg, shape.global_batch, shape.seq_len,
                          dtype=dtype, device=dev)
