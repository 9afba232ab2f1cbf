"""Decoder-only dense transformer (port of ``repro.models.transformer``):
llama / qwen / phi / deepseek and the internvl2 language model.

The reference keeps a parameter pytree with per-layer leaves stacked along
a leading L axis and scans over them.  Here the parameters live in
``nn.Module``s named after the reference's leaves: a :class:`Transformer`
holds ``embed``, ``norm_f`` (and ``unembed`` when the embeddings are not
tied) and an ``nn.ModuleList`` of :class:`Layer`, each with ``attn``
(:class:`Attention`: ``wq``, ``wk``, ``wv``, ``wo``, optional biases),
``mlp`` (:class:`MLP`: ``w_gate``, ``w_up``, ``w_down``), ``norm_attn`` and
``norm_mlp``.  Weights keep the reference's ``(in, out)`` orientation.

Parameters are stored in their own dtype (f32 by default, as the
reference's) and every layer runs in the compute dtype (bf16 by default).
The reference casts each layer's parameters on every step; the port casts
them once and reuses the copies while no parameter changes (a cast is
deterministic, so the values are the same bits), except under autograd,
where it casts afresh.  The decode cache is updated in place.

Training (``lm_loss``): ``forward(..., remat=True)`` runs each layer under
``torch.utils.checkpoint`` with the layer's f32 parameters as its inputs
and their cast to the compute dtype inside it, as the reference's
``jax.checkpoint`` body casts them, so only each layer's input is kept for
backward and the gradients reach the f32 parameters through the casts.
The loss takes the plain attention path (``flash=False``): the flash
kernel has no backward.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (
    ArchConfig,
    attention,
    attention_decode,
    attention_leaves,
    attention_shapes,
    chunked_lm_loss,
    dense_init,
    draw_device,
    mlp,
    mlp_leaves,
    mlp_shapes,
    rmsnorm,
)

__all__ = ["Attention", "MLP", "Layer", "Transformer", "layer_leaves",
           "init_leaves", "fill", "init_layer", "init_params", "layer_fwd",
           "forward",
           "unembed_matrix", "lm_loss", "init_cache", "decode_step"]

Weights = Dict[str, torch.Tensor]


class _Leaves(nn.Module):
    """A module whose parameters are the named leaves of one reference
    dict, uninitialised until a caller fills them."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], dtype, device):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))

    def leaves(self, dtype) -> Weights:
        return {name: p.to(dtype)
                for name, p in self.named_parameters(recurse=False)}

    def fill(self, values: Weights) -> None:
        with torch.no_grad():
            for name, p in self.named_parameters(recurse=False):
                p.copy_(values[name])


class Attention(_Leaves):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__(attention_shapes(cfg), dtype, device)


class MLP(_Leaves):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__(mlp_shapes(cfg), dtype, device)


class Layer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)
        self.norm_attn = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                                 device=device))
        self.norm_mlp = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                                device=device))

    def weights(self, dtype) -> Weights:
        """This layer's parameters cast to ``dtype``, as the reference's
        ``layer_p`` dict: ``{"attn": {...}, "mlp": {...}, "norm_attn",
        "norm_mlp"}``."""
        return {"attn": self.attn.leaves(dtype), "mlp": self.mlp.leaves(dtype),
                "norm_attn": self.norm_attn.to(dtype),
                "norm_mlp": self.norm_mlp.to(dtype)}


class Transformer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              dtype=dtype, device=device))
        self.layers = nn.ModuleList(Layer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.norm_f = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                              device=device))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.empty(
                (cfg.d_model, cfg.vocab), dtype=dtype, device=device))
        self._cast: Optional[tuple] = None

    def compute_weights(self, dtype) -> Tuple[List[Weights], torch.Tensor]:
        """Every layer's weights and the unembedding matrix in ``dtype``.
        Outside autograd the copies are kept and reused until a parameter
        is changed or moved (its version counter or storage changes)."""
        return cached_cast(self, dtype, lambda: (
            [layer.weights(dtype) for layer in self.layers],
            unembed_matrix(self, self.cfg).to(dtype)))

    def forward(self, tokens, extra_embeds=None,
                compute_dtype=torch.bfloat16, unembed: bool = True):
        return forward(self, tokens, self.cfg, extra_embeds=extra_embeds,
                       compute_dtype=compute_dtype, unembed=unembed)


def cached_cast(model: nn.Module, dtype, make):
    """``make()`` (the model's weights cast to ``dtype``), kept on
    ``model._cast`` outside autograd and reused until a parameter is
    changed or moved (its version counter or storage changes); under
    autograd made afresh, so gradients reach the parameters."""
    if torch.is_grad_enabled():
        return make()
    stamp = (dtype,) + tuple((p.data_ptr(), p._version)
                             for p in model.parameters())
    if model._cast is None or model._cast[0] != stamp:
        model._cast = None     # free the old copies before casting anew
        model._cast = (stamp, make())
    return model._cast[1]


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def layer_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                 dtype=torch.float32, prefix: str = ""
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(prefix + name, value)`` of one layer's parameters, made one at a
    time in draw order: attention, then MLP, then the norms (ones, which
    draw nothing)."""
    yield from attention_leaves(generator, cfg, dtype, prefix + "attn.")
    yield from mlp_leaves(generator, cfg, dtype, prefix + "mlp.")
    for name in ("norm_attn", "norm_mlp"):
        yield prefix + name, torch.ones(cfg.d_model, dtype=dtype,
                                        device=draw_device(generator))


def init_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                dtype=torch.float32) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every parameter of a :class:`Transformer` as ``(its
    named_parameters name, value)``, made one at a time in the order the
    values are drawn from ``generator``: embed, layers 0..L-1, unembed,
    then ``norm_f``.  This is the model's one draw sequence:
    :func:`init_params` fills a whole model from it and
    ``training.sharding.init_sharded`` keeps a rank's block of each leaf
    as it comes.  A None ``generator`` gives the leaves on ``meta``."""
    yield "embed", dense_init(generator, (cfg.vocab, cfg.d_model), dtype,
                              scale=1.0)
    for i in range(cfg.n_layers):
        yield from layer_leaves(generator, cfg, dtype, f"layers.{i}.")
    if not cfg.tie_embeddings:
        yield "unembed", dense_init(generator, (cfg.d_model, cfg.vocab),
                                    dtype)
    yield "norm_f", torch.ones(cfg.d_model, dtype=dtype,
                               device=draw_device(generator))


def fill(module: nn.Module, leaves) -> None:
    """Copy each ``(name, value)`` of ``leaves`` into the parameter of
    ``module`` of that name."""
    with torch.no_grad():
        for name, value in leaves:
            module.get_parameter(name).copy_(value)


def init_layer(generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32, layer: Optional[Layer] = None) -> Layer:
    """Draw one layer's weights (:func:`layer_leaves`) into ``layer``, or
    into a new :class:`Layer` on the generator's device."""
    if layer is None:
        layer = Layer(cfg, dtype, generator.device)
    fill(layer, layer_leaves(generator, cfg, dtype))
    return layer


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> Transformer:
    """A :class:`Transformer` on the generator's device, filled from
    :func:`init_leaves`."""
    model = Transformer(cfg, dtype, generator.device)
    fill(model, init_leaves(generator, cfg, dtype))
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def layer_fwd(p: Weights, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, flash: bool = True,
              causal: bool = True) -> torch.Tensor:
    """Self-attention (causal, or not for an encoder) and the MLP, each
    after its norm and added to the residual stream."""
    h = x + attention(p["attn"], rmsnorm(x, p["norm_attn"], cfg.norm_eps),
                      cfg, positions, causal=causal, flash=flash)
    return h + mlp(p["mlp"], rmsnorm(h, p["norm_mlp"], cfg.norm_eps))


def _remat_layer(x: torch.Tensor, layer: Layer, cfg: ArchConfig,
                 positions: torch.Tensor, compute_dtype, flash: bool,
                 causal: bool = True) -> torch.Tensor:
    return layer_fwd(layer.weights(compute_dtype), x, cfg, positions, flash,
                     causal)


def forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
            extra_embeds: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, unembed: bool = True, *,
            remat: bool = True, flash: bool = True) -> torch.Tensor:
    """Logits (B, S_total, vocab) in f32, or the final hidden states (B,
    S_total, d) in the compute dtype if not ``unembed``.  ``extra_embeds``
    (B, P, d), e.g. vlm patches, are prepended.  ``flash`` picks the
    attention path (the kernel, or the differentiable plain path);
    ``remat`` recomputes each layer in backward (it acts only under
    autograd)."""
    x = params.embed[tokens.long()].to(compute_dtype)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(compute_dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    if remat and torch.is_grad_enabled():
        for layer in params.layers:
            x = checkpoint(_remat_layer, x, layer, cfg, positions,
                           compute_dtype, flash, use_reentrant=False)
        w = None
    else:
        layers, w = params.compute_weights(compute_dtype)
        for layer_p in layers:
            x = layer_fwd(layer_p, x, cfg, positions, flash)
    x = rmsnorm(x, params.norm_f, cfg.norm_eps)
    if not unembed:
        return x
    if w is None:
        w = unembed_matrix(params, cfg).to(compute_dtype)
    return (x @ w).float()


def unembed_matrix(params: Transformer, cfg: ArchConfig) -> torch.Tensor:
    """(d, vocab): ``unembed``, or with tied embeddings ``embed.T *
    d_model**-0.5`` in the parameters' dtype (keeps the logits O(1))."""
    if not cfg.tie_embeddings:
        return params.unembed
    return params.embed.T * (cfg.d_model ** -0.5)


def lm_loss(params: Transformer, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig, remat: bool = True,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (scalar f32): the final hidden states of the token
    segment (a vlm's patch positions are dropped) through
    :func:`chunked_lm_loss` with :func:`unembed_matrix`, on the plain
    attention path (the flash kernel has no backward)."""
    hidden = forward(params, batch["tokens"], cfg,
                     extra_embeds=batch.get("patch_embeds"),
                     compute_dtype=compute_dtype, unembed=False,
                     remat=remat, flash=False)
    n_prefix = hidden.shape[1] - batch["tokens"].shape[1]
    hidden = hidden[:, n_prefix:, :]
    return chunked_lm_loss(hidden, unembed_matrix(params, cfg),
                           batch["labels"], compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def decode_step(params: Transformer, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: int, cfg: ArchConfig,
                compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token of autoregressive decode with a static KV cache: logits
    (B, vocab) in f32.  Row ``pos`` of every layer's cache is written in
    place; the same cache dict is returned.  Inference only: it runs
    without autograd, so the cache never joins a graph."""
    x = params.embed[token.long()][:, None, :].to(compute_dtype)   # (B,1,d)
    layers, w = params.compute_weights(compute_dtype)
    for i, layer_p in enumerate(layers):
        hn = rmsnorm(x, layer_p["norm_attn"], cfg.norm_eps)
        a, _, _ = attention_decode(layer_p["attn"], hn, cfg, cache["k"][i],
                                   cache["v"][i], pos)
        x = x + a
        x = x + mlp(layer_p["mlp"], rmsnorm(x, layer_p["norm_mlp"],
                                            cfg.norm_eps))
    x = rmsnorm(x, params.norm_f, cfg.norm_eps)
    return (x[:, 0, :] @ w).float(), cache
