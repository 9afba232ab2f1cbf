"""Zamba2-style hybrid (port of ``repro.models.hybrid``): a Mamba2 backbone
and one *shared* attention + MLP block applied after every
``cfg.attn_every``-th Mamba layer with the same weights each time.

The reference splits the Mamba layers into ``n_layers // attn_every``
groups of ``attn_every`` (stacked (G, E, ...), a double scan) and a stacked
tail of the remainder; the shared block runs after each group.  Here
:class:`Hybrid` holds ``embed``, ``groups`` (an ``nn.ModuleList`` of
``nn.ModuleList`` s of :class:`~repro_torch.models.mamba.MambaBlock`),
``shared`` (a :class:`~repro_torch.models.transformer.Layer`: ``attn``,
``mlp``, ``norm_attn``, ``norm_mlp``), ``norm_f``, ``unembed`` and
``tail``, which is empty when ``n_layers`` is a multiple of
``attn_every``; ``repro_torch.layout`` maps the names to the reference's
stacked leaves.  The reference's simplifications are kept: the shared
block reads the residual stream itself (no concatenated embeddings, no
per-invocation LoRA).

Full-sequence attention takes the flash kernel (``flash=True``, the
serving steps) or the differentiable plain path (the loss).  Under
autograd with ``remat``, each Mamba layer and each application of the
shared block runs under its own non-reentrant ``torch.utils.checkpoint``,
its f32 parameters cast inside it: each is recomputed once in backward
and each one's input is kept.  The reference nests a checkpoint of every
group around checkpoints of its layers, keeping fewer inputs (one a group)
for a second recomputation of each layer; the port takes the flat form,
whose inputs at zamba2-7b's width cost 29 MB a layer per 4096 tokens.
The decode cache holds the shared block's K and V, one (B, S, Hkv, hd)
slice a group, and a state per Mamba block, stacked as the reference
stacks them; a decode step writes them in place.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (
    ArchConfig,
    attention_decode,
    chunked_lm_loss,
    dense_init,
    draw_device,
    mlp,
    rmsnorm,
)
from repro_torch.models.mamba import (
    MambaBlock,
    init_mamba_state,
    mamba_block,
    mamba_decode,
    mamba_leaves,
)
from repro_torch.models.transformer import (
    Layer,
    _remat_layer,
    cached_cast,
    fill,
    layer_fwd,
    layer_leaves,
)

__all__ = ["Hybrid", "init_leaves", "init_params", "forward", "lm_loss", "init_cache",
           "decode_step"]

Weights = Dict[str, torch.Tensor]


def _split(cfg: ArchConfig) -> Tuple[int, int, int]:
    g = cfg.n_layers // cfg.attn_every
    tail = cfg.n_layers - g * cfg.attn_every
    return g, cfg.attn_every, tail


class Hybrid(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__()
        g, e, tail = _split(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              dtype=dtype, device=device))
        self.groups = nn.ModuleList(
            nn.ModuleList(MambaBlock(cfg, dtype, device) for _ in range(e))
            for _ in range(g))
        self.shared = Layer(cfg, dtype, device)
        self.norm_f = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                              device=device))
        self.unembed = nn.Parameter(torch.empty((cfg.d_model, cfg.vocab),
                                                dtype=dtype, device=device))
        self.tail = nn.ModuleList(MambaBlock(cfg, dtype, device)
                                  for _ in range(tail))
        self._cast: Optional[tuple] = None

    def compute_weights(self, dtype) -> Tuple[List[List[Weights]], dict,
                                              List[Weights], torch.Tensor]:
        """``(groups, shared, tail, unembed)`` in ``dtype``: every Mamba
        block's leaves by group, the shared block's weights, the tail's and
        the unembedding; kept outside autograd until a parameter changes
        (as ``Transformer.compute_weights``)."""
        return cached_cast(self, dtype, lambda: (
            [[blk.leaves(dtype) for blk in grp] for grp in self.groups],
            self.shared.weights(dtype),
            [blk.leaves(dtype) for blk in self.tail],
            self.unembed.to(dtype)))

    def forward(self, tokens, extra_embeds=None,
                compute_dtype=torch.bfloat16, unembed: bool = True):
        return forward(self, tokens, self.cfg, extra_embeds=extra_embeds,
                       compute_dtype=compute_dtype, unembed=unembed)


def init_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                dtype=torch.float32) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every parameter of a :class:`Hybrid` as ``(its named_parameters
    name, value)``, made one at a time in draw order: the shared block
    (attention, MLP, its norms), embed, the groups' blocks, unembed, the
    tail's blocks, then ``norm_f`` (the reference's keys; the model's one
    draw sequence, as ``transformer.init_leaves``).  A None ``generator``
    gives the leaves on ``meta``."""
    g, e, tail = _split(cfg)
    yield from layer_leaves(generator, cfg, dtype, "shared.")
    yield "embed", dense_init(generator, (cfg.vocab, cfg.d_model), dtype,
                              scale=1.0)
    for gi in range(g):
        for ei in range(e):
            yield from mamba_leaves(generator, cfg, dtype,
                                    f"groups.{gi}.{ei}.")
    yield "unembed", dense_init(generator, (cfg.d_model, cfg.vocab), dtype)
    for ti in range(tail):
        yield from mamba_leaves(generator, cfg, dtype, f"tail.{ti}.")
    yield "norm_f", torch.ones(cfg.d_model, dtype=dtype,
                               device=draw_device(generator))


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> Hybrid:
    """A :class:`Hybrid` on the generator's device, filled from
    :func:`init_leaves`."""
    model = Hybrid(cfg, dtype, generator.device)
    fill(model, init_leaves(generator, cfg, dtype))
    return model


def _remat_mamba(x: torch.Tensor, block: MambaBlock, cfg: ArchConfig,
                 compute_dtype) -> torch.Tensor:
    return mamba_block(block.leaves(compute_dtype), x, cfg)


def forward(params: Hybrid, tokens: torch.Tensor, cfg: ArchConfig,
            extra_embeds: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, unembed: bool = True, *,
            remat: bool = True, flash: bool = True) -> torch.Tensor:
    """Logits (B, S, vocab) in f32, or the final hidden states (B, S, d)
    in the compute dtype if not ``unembed``.  ``extra_embeds`` is accepted
    and unused, as in the reference.  ``flash`` picks the shared block's
    attention path; ``remat`` checkpoints each Mamba layer and each shared
    block application (it acts only under autograd)."""
    x = params.embed[tokens.long()].to(compute_dtype)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    if remat and torch.is_grad_enabled():
        for grp in params.groups:
            for blk in grp:
                x = checkpoint(_remat_mamba, x, blk, cfg, compute_dtype,
                               use_reentrant=False)
            x = checkpoint(_remat_layer, x, params.shared, cfg, positions,
                           compute_dtype, flash, use_reentrant=False)
        for blk in params.tail:
            x = checkpoint(_remat_mamba, x, blk, cfg, compute_dtype,
                           use_reentrant=False)
        w = None
    else:
        groups, shared, tail, w = params.compute_weights(compute_dtype)
        for grp in groups:
            for p in grp:
                x = mamba_block(p, x, cfg)
            x = layer_fwd(shared, x, cfg, positions, flash)
        for p in tail:
            x = mamba_block(p, x, cfg)
    x = rmsnorm(x, params.norm_f, cfg.norm_eps)
    if not unembed:
        return x
    if w is None:
        w = params.unembed.to(compute_dtype)
    return (x @ w).float()


def lm_loss(params: Hybrid, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            remat: bool = True, compute_dtype=torch.bfloat16
            ) -> torch.Tensor:
    """Next-token cross-entropy (scalar f32) through
    :func:`chunked_lm_loss` with ``unembed``, on the plain attention path
    (the flash kernel has no backward)."""
    hidden = forward(params, batch["tokens"], cfg,
                     compute_dtype=compute_dtype, unembed=False,
                     remat=remat, flash=False)
    return chunked_lm_loss(hidden, params.unembed, batch["labels"],
                           compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# Decode: Mamba recurrent states + the shared block's KV cache (one a group)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """``{"groups": {"ssm": (G, E, B, H, P, N), "conv": (G, E, B, K - 1,
    C)}, "tail": the same with (T, ...) or None, "k", "v": (G, B, max_seq,
    Hkv, hd)}``: the Mamba states in f32 (:func:`init_mamba_state`), K and
    V in ``dtype``, all zero."""
    g, e, tail = _split(cfg)
    state = init_mamba_state(cfg, batch, device=device)

    def stacked(lead):
        return {k: torch.zeros(lead + tuple(v.shape), dtype=v.dtype,
                               device=device) for k, v in state.items()}

    kv = (g, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"groups": stacked((g, e)),
            "tail": stacked((tail,)) if tail else None,
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


def _mamba_step(p: Weights, x: torch.Tensor, states: Dict[str, torch.Tensor],
                idx: Tuple[int, ...], cfg: ArchConfig) -> torch.Tensor:
    """One block's decode step on its state ``states[...][idx]``, written
    back in place."""
    x, new = mamba_decode(p, x, {k: v[idx] for k, v in states.items()}, cfg)
    for k, v in new.items():
        states[k][idx] = v
    return x


@torch.no_grad()
def decode_step(params: Hybrid, cache: dict, token: torch.Tensor, pos: int,
                cfg: ArchConfig, compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, dict]:
    """One token of decode: logits (B, vocab) in f32.  Every Mamba state
    and row ``pos`` of every group's K and V are written in place; the
    same cache dict is returned."""
    x = params.embed[token.long()][:, None, :].to(compute_dtype)
    groups, shared, tail, w = params.compute_weights(compute_dtype)
    for gi, grp in enumerate(groups):
        for ei, p in enumerate(grp):
            x = _mamba_step(p, x, cache["groups"], (gi, ei), cfg)
        hn = rmsnorm(x, shared["norm_attn"], cfg.norm_eps)
        a, _, _ = attention_decode(shared["attn"], hn, cfg, cache["k"][gi],
                                   cache["v"][gi], pos)
        x = x + a
        x = x + mlp(shared["mlp"], rmsnorm(x, shared["norm_mlp"],
                                           cfg.norm_eps))
    if tail and cache["tail"] is not None:
        for ti, p in enumerate(tail):
            x = _mamba_step(p, x, cache["tail"], (ti,), cfg)
    x = rmsnorm(x, params.norm_f, cfg.norm_eps)
    return (x[:, 0, :] @ w).float(), cache
