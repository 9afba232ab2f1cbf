"""Per-architecture API of the LM substrate (port of ``repro.models.api``):
init, input specs, random batches, the loss and the train step, and the
serving steps.

Every family of the reference is ported: ``dense`` and ``vlm``
(``models/transformer.py``), ``moe`` (``models/moe.py``), ``hybrid``
(``models/hybrid.py``), ``ssm`` (``models/xlstm.py``) and ``encdec``
(``models/encdec.py``: its loss is ``seq2seq_loss``, its prefill step
returns the encoder memory, its decode cache holds the cross K / V).

The sharding specs are the reference's for every family:
:func:`param_pspecs`, :func:`batch_axes_for`, :func:`batch_pspecs` and
:func:`cache_pspecs`.  A spec is a tuple over a tensor's own dims, each
entry ``None``, an axis name or a tuple of names: the reference's
``PartitionSpec`` with the stacked leading axes of a parameter dropped
(``layout.reference_leaf`` counts them).  A mesh is anything that gives
axis sizes by name: a mapping, or an ``NMFMesh``.  The train step that
places the parameters by these specs is ``training/sharding.py``; the
reference's ``constrain`` hints have no function in the port, where the
placement is explicit in those layers.

The function that makes a step names its attention path: the serving
steps take the flash kernel, the loss and the train step the
differentiable plain path (the kernel has no backward; the reference
trains with it off).
"""
from __future__ import annotations

import functools
from typing import (TYPE_CHECKING, Any, Callable, Dict, Mapping, NamedTuple,
                    Optional, Tuple, Union)

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.scan import scan
from repro_torch.layout import reference_leaf
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
           "make_decode_step", "init_params", "init_leaves",
           "init_decode_cache",
           "param_pspecs", "batch_axes_for", "batch_pspecs", "cache_pspecs"]

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

            def micro_step(loss, i):
                micro = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                l, g = value_and_grad(loss_fn, params, micro)
                for k, gi in g.items():
                    grads[k].add_(gi.float() / m)
                return loss + l / m, None

            loss, _ = scan(micro_step, torch.zeros(
                (), dtype=torch.float32,
                device=grads[next(iter(grads))].device), range(m))
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def make_prefill_step(cfg: ArchConfig, compute_dtype=None) -> Callable:
    """``prefill_step(params, batch)`` -> next-token logits (B, vocab) in
    f32: the full forward without autograd, last position, in
    ``compute_dtype`` (None: the family's default, the reference's bf16;
    f32 for checks at the reference's f32 bars).  For ``encdec`` it is the
    encoder memory (B, S, d) in the compute dtype, as the reference's.  The
    sharded step is ``serving.sharding.make_prefill_step``."""
    mod = module_for(cfg)
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}

    def prefill_step(params, batch):
        with torch.no_grad():
            if cfg.family == "encdec":
                return mod.encode(params, batch["frame_embeds"], cfg,
                                  remat=False, **kw)
            logits = mod.forward(params, batch["tokens"], cfg,
                                 extra_embeds=batch.get("patch_embeds"),
                                 **kw)
            return logits[:, -1, :].clone()   # frees the (B, S, vocab) rest

    return prefill_step


def make_decode_step(cfg: ArchConfig, compute_dtype=None) -> Callable:
    """``decode_step(params, cache, token, pos)`` -> (logits, cache), without
    autograd, in ``compute_dtype`` (None: the family's default); the cache
    is updated in place.  The sharded step is
    ``serving.sharding.make_decode_step``."""
    mod = module_for(cfg)
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}

    def decode_step(params, cache, token, pos):
        return mod.decode_step(params, cache, token, pos, cfg, **kw)

    return decode_step


def init_params(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0,
                dtype=torch.float32, device: DeviceLike = None):
    """Random parameters (the reference initialises at random too; nothing
    is downloaded), drawn on ``device`` (the card unless the CPU is asked
    for) from ``seed``: an int, or a generator on that device.  On the
    ``meta`` device nothing is drawn: the model's shapes and dtype only."""
    dev = resolve_device(device)
    if dev.type == "meta":
        from repro_torch.convert import _MODELS

        module_for(cfg)
        return _MODELS[cfg.family](cfg, dtype, dev)
    gen = _generator(seed, dev)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters asked for "
                         f"on {dev}")
    return module_for(cfg).init_params(gen, cfg, dtype)


def init_leaves(cfg: ArchConfig, generator: Optional[torch.Generator],
                dtype=torch.float32):
    """The family's one draw sequence: every parameter of the model as
    ``(its named_parameters name, value)``, drawn one at a time from
    ``generator`` on its device (``meta`` for None), the sequence the
    family's ``init_params`` fills a whole model from."""
    return module_for(cfg).init_leaves(generator, cfg, dtype)


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


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

#: (second-to-last dim, last dim) logical sharding by leaf name; the
#: stacked leading dims are never sharded.  The reference's table.
_RULES: Dict[str, Tuple[Optional[str], Optional[str]]] = {
    # in-projections: (d_in -> fsdp, d_out -> tensor)
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
    "in_proj": ("fsdp", "tp"), "w_if": ("fsdp", None), "w_in": ("fsdp", "tp"),
    # out-projections: (d_in -> tensor, d_out -> fsdp)
    "wo": ("tp", "fsdp"), "w_down": ("tp", "fsdp"), "out_proj": ("tp", "fsdp"),
    # embeddings
    "embed": ("tp", "fsdp"),      # (vocab, d)
    "unembed": ("fsdp", "tp"),    # (d, vocab)
    # moe router
    "router": ("fsdp", None),
    # mamba conv (K, channels)
    "conv_w": (None, "tp"),
    # xlstm block-diagonal recurrence (h, hd, 4hd): small, replicated
    "r": (None, None),
}

#: MoE expert weights (E, d_in, d_out): the expert dim takes "ep"
_MOE_EXPERT_LEAVES = {"w_gate", "w_up", "w_down"}

#: a spec entry: no axis, an axis name, or a tuple of names
Axis = Union[None, str, Tuple[str, ...]]


def _axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of ``mesh``: a mapping as it is, an ``NMFMesh``
    as ``{"data": rows, "model": cols}`` (and ``"pod"`` with several
    pods), the axes the reference's mesh of that shape names."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    sizes = {"data": mesh.rows, "model": mesh.cols}
    if mesh.pods > 1:
        sizes["pod"] = mesh.pods
    return sizes


def _guard(axes: Axis, dim_size: int, sizes: Dict[str, int]) -> Axis:
    """``axes`` if the product of their sizes divides ``dim_size``, else
    None (replicated along them); an axis the mesh lacks counts 1 in a
    tuple and drops a single name, as the reference's guards do."""
    if axes is None:
        return None
    if isinstance(axes, tuple):
        n = 1
        for a in axes:
            n *= sizes.get(a, 1)
    else:
        n = sizes.get(axes)
    return axes if n and dim_size % n == 0 else None


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    if isinstance(params, Mapping):
        return {name: tuple(t.shape) for name, t in params.items()}
    return {name: tuple(p.shape) for name, p in params.named_parameters()}


def param_pspecs(cfg: ArchConfig, params, rules: Dict[str, Any],
                 mesh=None) -> Dict[str, Tuple[Axis, ...]]:
    """The spec of every parameter of ``params`` (an ``nn.Module``, or a
    mapping of its ``named_parameters`` names to tensors of any device,
    ``meta`` included), keyed by that name: a tuple over the parameter's
    own dims.

    ``rules`` maps the logical axes ``"fsdp"``, ``"tp"``, ``"ep"`` to mesh
    axis names (or None), e.g. ``{"fsdp": "data", "tp": "model", "ep":
    "model"}``.  A leaf is matched by the innermost key of its path in the
    reference's pytree (``layout.reference_leaf``), in a moe context when
    any key on the path is ``"moe"``; the spec is the reference's over the
    stacked leaf, its stacked dims dropped.  With ``mesh`` an axis whose
    size does not divide its dim is dropped (replicated along it), e.g.
    seamless's 256,206-word vocabulary over a "model" axis of 16."""
    sizes = None if mesh is None else _axis_sizes(mesh)
    out = {}
    for name, shape in _named_shapes(params).items():
        path, index = reference_leaf(name, cfg.family)
        ndim, lead_n = len(index) + len(shape), len(index)
        key = path[-1]
        if ndim <= 1 or key not in _RULES:
            out[name] = (None,) * len(shape)
            continue
        a, b = _RULES[key]
        spec = [rules.get(a), rules.get(b)]
        lead: list = [None] * (ndim - 2)
        if "moe" in path and key in _MOE_EXPERT_LEAVES and ndim >= 3:
            # (..., E, d_in, d_out): the expert dim takes "ep", which then
            # leaves the other two
            lead[-1] = rules.get("ep")
            spec = [s if s != rules.get("ep") else None for s in spec]
        full = (lead + spec)[lead_n:]
        if sizes is not None:
            full = [_guard(ax, shape[i], sizes) for i, ax in enumerate(full)]
        out[name] = tuple(full)
    return out


def batch_axes_for(global_batch: int, mesh, candidates: Tuple[str, ...]
                   ) -> Tuple[str, ...]:
    """The axes of ``candidates`` (those the mesh has, in order) that the
    batch is split over: each is taken while the product so far still
    divides ``global_batch``."""
    sizes = _axis_sizes(mesh)
    axes, prod = [], 1
    for a in candidates:
        if a not in sizes:
            continue
        if global_batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes)


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                 seq_axis: Optional[str] = None
                 ) -> Dict[str, Tuple[Axis, ...]]:
    """Specs of the input batch of :func:`input_specs`: the batch dim over
    the data-parallel axes (``("pod", "data")`` as far as they divide it),
    the sequence over ``seq_axis``, the rest replicated."""
    dp = batch_axes_for(shape.global_batch, mesh, ("pod", "data"))
    bspec = dp if dp else None
    specs = {}
    for name, spec in input_specs(cfg, shape).items():
        ndim = len(spec.shape)
        specs[name] = ((bspec,) if ndim == 1 else
                       (bspec, seq_axis) + (None,) * (ndim - 2))
    return specs


def cache_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh, cache):
    """Specs of a decode state (``cache``, any tree of dicts, lists and
    tensors, as :func:`init_decode_cache` makes it; None stays None), in
    its structure: the batch over the data-parallel axes; a KV cache's
    sequence over ``"model"`` (length parallelism); Mamba and mLSTM states
    over their heads, a Mamba conv window over its channels, where
    ``"model"`` divides them.  A leaf is matched by its innermost key."""
    sizes = _axis_sizes(mesh)
    dp = batch_axes_for(shape.global_batch, mesh, ("pod", "data"))
    bspec = dp if dp else None
    model = "model" if "model" in sizes else None

    def spec(name, leaf):
        nd = leaf.dim()
        if name in ("k", "v", "ck", "cv") and nd == 5:
            prop = [None, bspec, model, None, None]      # (L, B, S, Hkv, hd)
        elif name == "ssm" and nd >= 4:
            prop = [None] * (nd - 4) + [bspec, model, None, None]
        elif name == "conv" and nd >= 3:
            prop = [None] * (nd - 3) + [bspec, None, model]
        elif name == "C" and nd == 4:                    # mLSTM (B, H, hd, hd)
            prop = [bspec, model, None, None]
        elif nd >= 2:
            prop = [None] * (nd - 2) + [bspec, None]
        else:
            return (None,) * nd
        return tuple(_guard(ax, leaf.shape[i], sizes)
                     for i, ax in enumerate(prop))

    def walk(node, name):
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return spec(name, node)

    return walk(cache, None)
