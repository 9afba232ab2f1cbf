"""Encoder-decoder transformer (port of ``repro.models.encdec``, the
seamless-m4t-large-v2 backbone).

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S, d).  The text decoder is causal, with
cross-attention to the encoder memory; its length is ``S //
cfg.dec_ratio`` (at least 16) in the input specs.

The reference stacks each layer's leaves along a leading L axis and scans
over them.  Here :class:`EncDec` holds ``embed`` (V, d), ``enc_layers`` (an
``nn.ModuleList`` of :class:`~repro_torch.models.transformer.Layer`:
``attn``, ``mlp``, ``norm_attn``, ``norm_mlp``), ``dec_layers`` (of
:class:`DecLayer`: ``self_attn``, ``cross_attn``, ``mlp``, ``norm_self``,
``norm_cross``, ``norm_mlp``), ``norm_enc``, ``norm_dec`` and ``unembed``
(d, V); ``repro_torch.layout`` maps ``enc_layers.<i>.*`` and
``dec_layers.<i>.*`` to rows of the reference's stacked leaves.  Weights
keep the ``(in, out)`` orientation; parameters are kept in their own dtype
and cast once to the compute dtype outside autograd
(``transformer.cached_cast``).

Attention paths are named by the caller (``flash``): the serving functions
(:func:`prefill`, and :func:`encode` under it; :func:`decode_step`) take
the flash kernel; :func:`seq2seq_loss` takes the differentiable plain path,
the encoder's self-attention and the decoder's cross-attention not causal.
A decode step's cross-attention is one query row a sequence against the
(B, T, Hkv, hd) slices of the cross K / V cache, read in place through
their strides.  Under autograd with ``remat``, each encoder and decoder
layer runs under ``torch.utils.checkpoint`` with its f32 parameters cast
inside it, as the reference's ``jax.checkpoint`` bodies cast them.  The
decode step writes row ``pos`` of the self-attention cache in place.
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
    chunked_lm_loss,
    dense_init,
    draw_device,
    mlp,
    mlp_leaves,
    rmsnorm,
)
from repro_torch.models.transformer import (
    MLP,
    Attention,
    Layer,
    _remat_layer,
    cached_cast,
    fill,
    layer_fwd,
    layer_leaves,
)

__all__ = ["DecLayer", "EncDec", "init_leaves", "init_params", "encode", "decode_train",
           "seq2seq_loss", "init_cache", "prefill", "decode_step"]

Weights = Dict[str, torch.Tensor]


def _ones(cfg: ArchConfig, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))


class DecLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.self_attn = Attention(cfg, dtype, device)
        self.cross_attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)
        self.norm_self = _ones(cfg, dtype, device)
        self.norm_cross = _ones(cfg, dtype, device)
        self.norm_mlp = _ones(cfg, dtype, device)

    def weights(self, dtype) -> Weights:
        """This layer's parameters cast to ``dtype``, as the reference's
        ``layer_p`` dict."""
        return {"self_attn": self.self_attn.leaves(dtype),
                "cross_attn": self.cross_attn.leaves(dtype),
                "mlp": self.mlp.leaves(dtype),
                "norm_self": self.norm_self.to(dtype),
                "norm_cross": self.norm_cross.to(dtype),
                "norm_mlp": self.norm_mlp.to(dtype)}


class EncDec(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              dtype=dtype, device=device))
        self.enc_layers = nn.ModuleList(
            Layer(cfg, dtype, device)
            for _ in range(cfg.n_enc_layers or cfg.n_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, dtype, device)
                                        for _ in range(cfg.n_layers))
        self.norm_enc = _ones(cfg, dtype, device)
        self.norm_dec = _ones(cfg, dtype, device)
        self.unembed = nn.Parameter(torch.empty((cfg.d_model, cfg.vocab),
                                                dtype=dtype, device=device))
        self._cast: Optional[tuple] = None

    def compute_weights(self, dtype) -> Tuple[List[Weights], List[Weights],
                                              torch.Tensor]:
        """``(encoder layers, decoder layers, unembed)`` in ``dtype``, kept
        outside autograd until a parameter changes (as
        ``Transformer.compute_weights``)."""
        return cached_cast(self, dtype, lambda: (
            [layer.weights(dtype) for layer in self.enc_layers],
            [layer.weights(dtype) for layer in self.dec_layers],
            self.unembed.to(dtype)))


def init_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                dtype=torch.float32) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every parameter of an :class:`EncDec` as ``(its named_parameters
    name, value)``, made one at a time in draw order: embed, encoder layers
    (attention, MLP, norms), decoder layers (self-attention,
    cross-attention, MLP, norms), unembed, then ``norm_enc`` and
    ``norm_dec``; norms are ones and draw nothing (the model's one draw
    sequence, as ``transformer.init_leaves``).  A None ``generator`` gives
    the leaves on ``meta``."""
    dev = draw_device(generator)
    yield "embed", dense_init(generator, (cfg.vocab, cfg.d_model), dtype,
                              scale=1.0)
    for i in range(cfg.n_enc_layers or cfg.n_layers):
        yield from layer_leaves(generator, cfg, dtype, f"enc_layers.{i}.")
    for i in range(cfg.n_layers):
        prefix = f"dec_layers.{i}."
        yield from attention_leaves(generator, cfg, dtype,
                                    prefix + "self_attn.")
        yield from attention_leaves(generator, cfg, dtype,
                                    prefix + "cross_attn.")
        yield from mlp_leaves(generator, cfg, dtype, prefix + "mlp.")
        for name in ("norm_self", "norm_cross", "norm_mlp"):
            yield prefix + name, torch.ones(cfg.d_model, dtype=dtype,
                                            device=dev)
    yield "unembed", dense_init(generator, (cfg.d_model, cfg.vocab), dtype)
    for name in ("norm_enc", "norm_dec"):
        yield name, torch.ones(cfg.d_model, dtype=dtype, device=dev)


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> EncDec:
    """An :class:`EncDec` on the generator's device, filled from
    :func:`init_leaves`."""
    model = EncDec(cfg, dtype, generator.device)
    fill(model, init_leaves(generator, cfg, dtype))
    return model


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[0], x.shape[1]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(params: EncDec, frame_embeds: torch.Tensor, cfg: ArchConfig,
           remat: bool = True, compute_dtype=torch.bfloat16,
           flash: bool = True) -> torch.Tensor:
    """The encoder memory (B, S, d) in the compute dtype: non-causal
    self-attention with rope at ``arange(S)``, then the MLP, every layer;
    the final norm (``transformer.layer_fwd`` with ``causal=False``).
    ``flash`` picks the attention path; ``remat`` recomputes each layer in
    backward (it acts only under autograd)."""
    x = frame_embeds.to(compute_dtype)
    positions = _positions(x)
    if remat and torch.is_grad_enabled():
        for layer in params.enc_layers:
            x = checkpoint(_remat_layer, x, layer, cfg, positions,
                           compute_dtype, flash, False, use_reentrant=False)
    else:
        layers, _, _ = params.compute_weights(compute_dtype)
        for p in layers:
            x = layer_fwd(p, x, cfg, positions, flash, causal=False)
    return rmsnorm(x, params.norm_enc, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross_kv(p: Weights, memory: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's K and V of ``memory`` (B, T, d): (B, T, Hkv,
    hd) each."""
    b, t, _ = memory.shape
    k, v = memory @ p["wk"], memory @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(b, t, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, t, cfg.n_kv_heads, cfg.hd))


def dec_layer_fwd(p: Weights, x: torch.Tensor, mem: torch.Tensor,
                  cfg: ArchConfig, positions: torch.Tensor,
                  flash: bool = True) -> torch.Tensor:
    h = x + attention(p["self_attn"],
                      rmsnorm(x, p["norm_self"], cfg.norm_eps), cfg,
                      positions, causal=True, flash=flash)
    kv = _cross_kv(p["cross_attn"], mem, cfg)
    h = h + attention(p["cross_attn"],
                      rmsnorm(h, p["norm_cross"], cfg.norm_eps), cfg,
                      positions, causal=False, kv=kv, flash=flash)
    return h + mlp(p["mlp"], rmsnorm(h, p["norm_mlp"], cfg.norm_eps))


def _remat_dec(x: torch.Tensor, mem: torch.Tensor, layer: DecLayer,
               cfg: ArchConfig, positions: torch.Tensor, compute_dtype,
               flash: bool) -> torch.Tensor:
    return dec_layer_fwd(layer.weights(compute_dtype), x, mem, cfg,
                         positions, flash)


def decode_train(params: EncDec, memory: torch.Tensor, tokens: torch.Tensor,
                 cfg: ArchConfig, remat: bool = True,
                 compute_dtype=torch.bfloat16, unembed: bool = True,
                 flash: bool = True) -> torch.Tensor:
    """The teacher-forced decoder over ``tokens`` (B, S) against
    ``memory``: logits (B, S, vocab) in f32, or the final hidden states
    (B, S, d) in the compute dtype if not ``unembed``.  Each layer: causal
    self-attention with rope, cross-attention over the memory (no rope, not
    causal), the MLP."""
    x = params.embed[tokens.long()].to(compute_dtype)
    positions = _positions(x)
    mem = memory.to(compute_dtype)
    if remat and torch.is_grad_enabled():
        for layer in params.dec_layers:
            x = checkpoint(_remat_dec, x, mem, layer, cfg, positions,
                           compute_dtype, flash, use_reentrant=False)
        w = None
    else:
        _, layers, w = params.compute_weights(compute_dtype)
        for p in layers:
            x = dec_layer_fwd(p, x, mem, cfg, positions, flash)
    x = rmsnorm(x, params.norm_dec, cfg.norm_eps)
    if not unembed:
        return x
    if w is None:
        w = params.unembed.to(compute_dtype)
    return (x @ w).float()


def seq2seq_loss(params: EncDec, batch: Dict[str, torch.Tensor],
                 cfg: ArchConfig, remat: bool = True,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Next-token cross-entropy (scalar f32) of the decoder over
    ``batch["tokens"]`` against ``batch["labels"]``, given the encoder's
    memory of ``batch["frame_embeds"]``, through :func:`chunked_lm_loss`,
    on the plain attention path (the flash kernel has no backward)."""
    memory = encode(params, batch["frame_embeds"], cfg, remat,
                    compute_dtype, flash=False)
    hidden = decode_train(params, memory, batch["tokens"], cfg, remat,
                          compute_dtype, unembed=False, flash=False)
    return chunked_lm_loss(hidden, params.unembed, batch["labels"],
                           compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# Inference: prefill = encode + the cross K / V; decode = a cached step
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_dec: int, enc_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """``k``, ``v``: (L, B, max_dec, Hkv, hd), the decoder's self-attention
    cache; ``ck``, ``cv``: (L, B, enc_len, Hkv, hd), each layer's
    cross-attention K and V of the memory; all zero."""
    def zeros(length):
        return torch.zeros((cfg.n_layers, batch, length, cfg.n_kv_heads,
                            cfg.hd), dtype=dtype, device=device)

    return {"k": zeros(max_dec), "v": zeros(max_dec),
            "ck": zeros(enc_len), "cv": zeros(enc_len)}


@torch.no_grad()
def prefill(params: EncDec, frame_embeds: torch.Tensor, cfg: ArchConfig,
            max_dec: int, compute_dtype=torch.bfloat16
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Encode the frames (the flash kernel, not causal) and fill every
    layer's cross K / V: ``(cache, memory)``, the cache in the compute
    dtype with a zeroed self-attention part of ``max_dec`` rows."""
    memory = encode(params, frame_embeds, cfg, remat=False,
                    compute_dtype=compute_dtype, flash=True)
    b, t, _ = memory.shape
    cache = init_cache(cfg, b, max_dec, t, dtype=compute_dtype,
                       device=memory.device)
    _, layers, _ = params.compute_weights(compute_dtype)
    for i, p in enumerate(layers):
        k, v = _cross_kv(p["cross_attn"], memory, cfg)
        cache["ck"][i] = k
        cache["cv"][i] = v
    return cache, memory


@torch.no_grad()
def decode_step(params: EncDec, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: int, cfg: ArchConfig,
                compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder token a sequence at position ``pos``: logits (B, vocab)
    in f32.  Self-attention against the cache (row ``pos`` written in
    place), then cross-attention of the one query row over the layer's
    cross K / V through the flash kernel, then the MLP; the same cache dict
    is returned."""
    x = params.embed[token.long()][:, None, :].to(compute_dtype)   # (B,1,d)
    _, layers, w = params.compute_weights(compute_dtype)
    for i, p in enumerate(layers):
        hn = rmsnorm(x, p["norm_self"], cfg.norm_eps)
        a, _, _ = attention_decode(p["self_attn"], hn, cfg, cache["k"][i],
                                   cache["v"][i], pos)
        x = x + a
        ck, cv = cache["ck"][i], cache["cv"][i]
        if ck.dtype != x.dtype:
            ck, cv = ck.to(x.dtype), cv.to(x.dtype)
        # positions are not read: a cross-attention memory takes no rope
        x = x + attention(p["cross_attn"],
                          rmsnorm(x, p["norm_cross"], cfg.norm_eps), cfg,
                          None, causal=False, kv=(ck, cv), flash=True)
        x = x + mlp(p["mlp"], rmsnorm(x, p["norm_mlp"], cfg.norm_eps))
    x = rmsnorm(x, params.norm_dec, cfg.norm_eps)
    return (x[:, 0, :] @ w).float(), cache
