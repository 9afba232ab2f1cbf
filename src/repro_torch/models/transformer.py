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

``lm_loss`` (training) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.common import (
    ArchConfig,
    attention,
    attention_decode,
    attention_shapes,
    dense_init,
    init_attention,
    init_mlp,
    mlp,
    mlp_shapes,
    rmsnorm,
)

__all__ = ["Attention", "MLP", "Layer", "Transformer", "init_layer",
           "init_params", "layer_fwd", "forward", "unembed_matrix",
           "init_cache", "decode_step"]

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
        if torch.is_grad_enabled():
            return ([layer.weights(dtype) for layer in self.layers],
                    unembed_matrix(self, self.cfg).to(dtype))
        stamp = (dtype,) + tuple((p.data_ptr(), p._version)
                                 for p in self.parameters())
        if self._cast is None or self._cast[0] != stamp:
            self._cast = None     # free the old copies before casting anew
            self._cast = (stamp, (
                [layer.weights(dtype) for layer in self.layers],
                unembed_matrix(self, self.cfg).to(dtype)))
        return self._cast[1]

    def forward(self, tokens, extra_embeds=None,
                compute_dtype=torch.bfloat16, unembed: bool = True):
        return forward(self, tokens, self.cfg, extra_embeds=extra_embeds,
                       compute_dtype=compute_dtype, unembed=unembed)


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32, layer: Optional[Layer] = None) -> Layer:
    """Draw one layer's weights (attention, then MLP; norms are ones) into
    ``layer``, or into a new :class:`Layer` on the generator's device."""
    if layer is None:
        layer = Layer(cfg, dtype, generator.device)
    layer.attn.fill(init_attention(generator, cfg, dtype))
    layer.mlp.fill(init_mlp(generator, cfg, dtype))
    return layer


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> Transformer:
    """A :class:`Transformer` on the generator's device, drawn in the order
    embed, layers 0..L-1, unembed."""
    model = Transformer(cfg, dtype, generator.device)
    with torch.no_grad():
        model.embed.copy_(dense_init(generator, (cfg.vocab, cfg.d_model),
                                     dtype, scale=1.0))
        for layer in model.layers:
            init_layer(generator, cfg, dtype, layer)
        if not cfg.tie_embeddings:
            model.unembed.copy_(dense_init(generator,
                                           (cfg.d_model, cfg.vocab), dtype))
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def layer_fwd(p: Weights, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor) -> torch.Tensor:
    h = x + attention(p["attn"], rmsnorm(x, p["norm_attn"], cfg.norm_eps),
                      cfg, positions)
    return h + mlp(p["mlp"], rmsnorm(h, p["norm_mlp"], cfg.norm_eps))


def forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
            extra_embeds: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, unembed: bool = True
            ) -> torch.Tensor:
    """Logits (B, S_total, vocab) in f32, or the final hidden states (B,
    S_total, d) in the compute dtype if not ``unembed``.  ``extra_embeds``
    (B, P, d), e.g. vlm patches, are prepended."""
    x = params.embed[tokens.long()].to(compute_dtype)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(compute_dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    layers, w = params.compute_weights(compute_dtype)
    for layer_p in layers:
        x = layer_fwd(layer_p, x, cfg, positions)
    x = rmsnorm(x, params.norm_f, cfg.norm_eps)
    if not unembed:
        return x
    return (x @ w).float()


def unembed_matrix(params: Transformer, cfg: ArchConfig) -> torch.Tensor:
    """(d, vocab): ``unembed``, or with tied embeddings ``embed.T *
    d_model**-0.5`` in the parameters' dtype (keeps the logits O(1))."""
    if not cfg.tie_embeddings:
        return params.unembed
    return params.embed.T * (cfg.d_model ** -0.5)


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
