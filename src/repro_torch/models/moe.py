"""Mixture-of-experts decoder (port of ``repro.models.moe``): olmoe and
qwen3-moe.

The reference's layer is its dense decoder layer with the SwiGLU block
replaced by ``moe_ffn``: a router picks each token's top ``k`` of ``E``
experts, the gates are the softmax of those ``k`` logits in f32, and the
tokens are scattered into a static ``(E, C, d)`` buffer (``C`` the
capacity an expert takes; a token past it is dropped), run through the
stacked expert weights ``(E, d, f)`` / ``(E, f, d)`` as batched products,
and gathered back, weighted by their gates and summed over ``k``.

Numerics and order are the reference's, with these choices of the port:

* the top ``k`` is ``torch.sort(..., descending=True, stable=True)`` cut to
  ``k``: on equal logits the lower expert comes first, as
  ``jax.lax.top_k`` puts it (``torch.topk`` promises no order on the card,
  and bf16 logits do tie);
* the dispatch is an ``index_copy`` of each kept (token, k) pair into the
  slot it owns (the exclusive running count of its expert, in (token, k)
  order), where the reference adds into zeros: every kept pair owns its
  slot, so the values are the reference's, and an overflowed pair, which
  the reference adds as a zero payload, lands in a scratch row that is cut
  off.  ``index_copy`` is deterministic; the combine's gather has a
  deterministic backward under ``torch.use_deterministic_algorithms``,
  and the only pairs that share a slot there (an overflowed pair reads
  slot 0 of its expert with weight 0) add exact zeros;
* the expert products are ``torch.bmm`` over the stacked experts (the
  reference's ``einsum``; it computes them outside any Pallas kernel).

Expert parallelism (:func:`moe_ffn_ep`, the reference's ``shard_map``
body): the grid is an explicit argument (the port has no ambient mesh).
Each rank takes its batch block over ``("pod", "data")`` and its sequence
block over ``"model"``, dispatches with the body's own capacity (at least
4), and exchanges the buffer with the ranks of its ``"model"`` group by two
``NMFMesh.all_to_all``, running the products on its ``E / model`` expert
slab.  :func:`moe_ffn_ep_plain` is the same body in one process, the
exchange done as the transpose that ``all_to_all`` performs: the oracle
of the tests.  The forward, the loss and decode run on one device, so they
take the one-group path (``mesh=None``), as the reference does without a
mesh.

The model holds its parameters in ``nn.Module``s named after the
reference's leaves (``MoELayer``: ``attn``, ``moe`` with ``router``,
``w_gate``, ``w_up``, ``w_down``, ``norm_attn``, ``norm_mlp``), each expert
tensor one stacked parameter; the bf16 copies are cached outside autograd
as the dense model's are.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
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
    rmsnorm,
)
from repro_torch.models.transformer import (
    Attention,
    _Leaves,
    cached_cast,
    fill,
    init_cache,
)

__all__ = ["moe_shapes", "init_moe_ffn", "router_topk", "expert_slots",
           "moe_ffn", "ep_applies", "ep_block", "moe_ffn_ep",
           "moe_ffn_ep_plain", "MoEFFN", "MoELayer", "MoETransformer",
           "moe_leaves", "layer_leaves", "init_leaves", "init_layer",
           "init_params", "layer_fwd", "forward", "lm_loss",
           "init_cache", "decode_step"]

Weights = Dict[str, torch.Tensor]

#: the expert-parallel body's least capacity (``src/repro/models/moe.py:123``;
#: ``moe_ffn``'s is ``k``)
EP_MIN_CAPACITY = 4


def moe_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Leaf name -> shape of one MoE block's parameters."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d)}


def init_moe_ffn(generator: torch.Generator, cfg: ArchConfig,
                 dtype=torch.float32) -> Weights:
    """Router and stacked expert weights from :func:`dense_init` (fan-in
    scaled, as the reference's)."""
    return dict(moe_leaves(generator, cfg, dtype))


# ---------------------------------------------------------------------------
# Routing, dispatch and the experts
# ---------------------------------------------------------------------------

def router_topk(x: torch.Tensor, router: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gates, sel)`` of tokens ``x`` (..., d): the top ``k`` router
    logits (in x's dtype; the lower expert first on a tie) and their
    experts, the gates the softmax of those logits in f32, cast back."""
    logits = x @ router
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[..., :k].float(), dim=-1).to(x.dtype)
    return gates, idx[..., :k]


def expert_slots(sel: torch.Tensor, n_experts: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slot, keep)`` of the (token, k) pairs of each group, ``sel`` (G,
    T, k): a pair's position is the count of earlier pairs (in (token, k)
    order) of its expert; it is kept below ``cap``, and its slot is
    ``expert * cap + position`` (``expert * cap`` when dropped).  Both
    (G, T * k).

    The reference counts with a running sum over a (T * k, E) one-hot; a
    scan along T * k runs E lanes wide on the card (50 ms a layer at 16,384
    tokens), so the port sorts instead: a stable sort by expert keeps each
    expert's pairs in (token, k) order, and a pair's position is its place
    in the sorted order less its expert's start (the exclusive sum of the
    experts' counts).  The same integers; every step is exact and
    deterministic."""
    g = sel.shape[0]
    e_flat = sel.reshape(g, -1)                             # (G, TK)
    order = torch.sort(e_flat, dim=1, stable=True).indices
    counts = torch.zeros((g, n_experts), dtype=e_flat.dtype,
                         device=e_flat.device).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))
    start = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(e_flat.shape[1], device=e_flat.device).expand_as(
        e_flat)
    pos_sorted = rank - torch.gather(start, 1, torch.gather(e_flat, 1, order))
    my_pos = torch.empty_like(e_flat).scatter_(1, order, pos_sorted)
    keep = my_pos < cap
    slot = e_flat * cap + torch.where(keep, my_pos, torch.zeros_like(my_pos))
    return slot, keep


def _dispatch(x: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
              k: int, rows: int) -> torch.Tensor:
    """(G, rows, d) buffer: group g's (token, k) pair p copied to row
    ``slot[g, p]`` when kept, the other rows zero."""
    g, t, d = x.shape
    dest = torch.where(keep, slot, torch.full_like(slot, rows))
    dest = dest + torch.arange(g, device=x.device)[:, None] * (rows + 1)
    x_rep = x.repeat_interleave(k, dim=1).reshape(g * t * k, d)
    buf = torch.index_copy(x.new_zeros((g * (rows + 1), d)), 0,
                           dest.reshape(-1), x_rep)
    return buf.view(g, rows + 1, d)[:, :rows]


def _experts(buf: torch.Tensor, w: Weights) -> torch.Tensor:
    """(E, R, d) rows through each expert's SwiGLU: (E, R, d)."""
    h = torch.bmm(buf, w["w_gate"])
    u = torch.bmm(buf, w["w_up"])
    return torch.bmm(F.silu(h) * u, w["w_down"])


def _combine(out: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gates: torch.Tensor, k: int) -> torch.Tensor:
    """(G, T, d): each pair's expert output (``out`` (G, rows, d) at its
    slot) times its gate (zero when dropped), summed over k."""
    g, tk = slot.shape
    d = out.shape[-1]
    y = torch.gather(out, 1, slot[..., None].expand(g, tk, d))
    w = gates.reshape(g, tk) * keep.to(out.dtype)
    return (y * w[..., None]).view(g, tk // k, k, d).sum(dim=2)


def moe_ffn(p: Weights, x: torch.Tensor, cfg: ArchConfig,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """The reference's ``moe_ffn``: ``x`` (G, Tg, d) in G dispatch groups,
    ``p`` in x's dtype; each group's capacity ``max(ceil(Tg * k / E *
    capacity_factor), k)`` an expert.  Returns (G, Tg, d)."""
    g, tg, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = max(int(math.ceil(tg * k / e * capacity_factor)), k)
    gates, sel = router_topk(x, p["router"], k)
    slot, keep = expert_slots(sel, e, cap)
    buf = _dispatch(x, slot, keep, k, e * cap)              # (G, E*C, d)
    # (E, G*C, d): the groups' rows of one expert side by side
    per_expert = buf.view(g, e, cap, d).transpose(0, 1).reshape(
        e, g * cap, d)
    out = _experts(per_expert, p)
    out = out.view(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    return _combine(out, slot, keep, gates, k)


# ---------------------------------------------------------------------------
# Expert parallelism over the grid (the reference's shard_map body)
# ---------------------------------------------------------------------------

def ep_applies(cfg: ArchConfig, dp: int, model: int, b: int,
               s: int) -> bool:
    """Whether the expert-parallel body runs for (B, S) tokens on a grid of
    ``dp`` batch blocks (``("pod", "data")``) and ``model`` sequence
    blocks, by the reference's shape rules (``src/repro/models/
    moe.py:186-197``): ``model`` above 1 dividing the experts, ``dp``
    dividing B and ``model`` dividing S.  Otherwise all B * S tokens run as
    one group."""
    return not (model == 1 or cfg.n_experts % model or b % dp or s % model)


def ep_block(mesh, b: int, s: int) -> Tuple[slice, slice]:
    """This rank's (batch, sequence) block of the expert-parallel body:
    batch block ``p * rows + i`` over ``("pod", "data")``, sequence block
    ``j`` over ``"model"``."""
    return mesh.block(b, ("pod", "data")), mesh.block(s, ("model",))


def ep_dispatch(p: Weights, xl: torch.Tensor, cfg: ArchConfig,
                 e_shards: int, capacity_factor: float):
    """One rank's tokens (Bl, Sl, d) routed and dispatched at the body's
    capacity (``max(ceil(Bl * Sl * k / E * capacity_factor), 4)``): the
    buffer (e_shards, E / e_shards * C, d) in expert order (part j for the
    ``model`` rank j), and what the combine needs."""
    bl, sl, d = xl.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    x = xl.reshape(1, bl * sl, d)
    cap = max(int(math.ceil(bl * sl * k / e * capacity_factor)),
              EP_MIN_CAPACITY)
    gates, sel = router_topk(x, p["router"], k)
    slot, keep = expert_slots(sel, e, cap)
    buf = _dispatch(x, slot, keep, k, e * cap)[0]
    return buf.reshape(e_shards, e // e_shards * cap, d), (slot, keep,
                                                          gates, cap)


def expert_slab(p: Weights, j: int, e_shards: int) -> Weights:
    """Rank j's ``E / e_shards`` experts of the stacked expert weights."""
    e_loc = p["w_gate"].shape[0] // e_shards
    return {n: p[n][j * e_loc:(j + 1) * e_loc]
            for n in ("w_gate", "w_up", "w_down")}


def ep_experts(slab: Weights, recv: torch.Tensor, e_shards: int,
               cap: int) -> torch.Tensor:
    """A rank's expert slab (:func:`expert_slab`) on what it received,
    (e_shards * E_loc * C, d) in the senders' order: each of its E_loc
    experts runs the rows of every sender, and the result goes back in the
    senders' order, (e_shards, E_loc * C, d)."""
    e_loc = slab["w_gate"].shape[0]
    d = recv.shape[-1]
    recv = recv.reshape(e_shards, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, e_shards * cap, d)
    out = _experts(recv, slab)
    return out.reshape(e_loc, e_shards, cap, d).transpose(0, 1).reshape(
        e_shards, e_loc * cap, d)


def ep_combine(back: torch.Tensor, shape, route, cfg: ArchConfig
                ) -> torch.Tensor:
    slot, keep, gates, cap = route
    d = back.shape[-1]
    y = _combine(back.reshape(1, cfg.n_experts * cap, d), slot, keep, gates,
                 cfg.moe_top_k)
    return y.reshape(shape)


def moe_ffn_ep(p: Weights, x3d: torch.Tensor, cfg: ArchConfig, mesh=None,
               capacity_factor: float = 1.25) -> torch.Tensor:
    """The reference's ``moe_ffn_ep`` on the grid ``mesh`` (an
    :class:`~repro_torch.launch.mesh.NMFMesh`, or ``None``).

    ``x3d`` (B, S, d) is the whole input, the same on every rank, and ``p``
    the whole router and expert weights.  Where :func:`ep_applies` holds,
    this rank runs the expert-parallel body on its block
    (:func:`ep_block`) and returns its (B / dp, S / model, d) block of the
    output: two ``mesh.all_to_all`` over ``"model"``, its ``E / model``
    experts.  Otherwise (no grid, or the reference's shape rules) all B * S
    tokens run through :func:`moe_ffn` as one group, and the whole (B, S,
    d) is returned, on every rank: the reference's choice, made from the
    shapes alone.  The exchange's gradient goes back through it."""
    b, s, d = x3d.shape
    dp = 1 if mesh is None else mesh.axis_size(("pod", "data"))
    e_shards = 1 if mesh is None else mesh.axis_size(("model",))
    if not ep_applies(cfg, dp, e_shards, b, s):
        return moe_ffn(p, x3d.reshape(1, b * s, d), cfg,
                       capacity_factor)[0].reshape(b, s, d)
    bsl, ssl = ep_block(mesh, b, s)
    xl = x3d[bsl, ssl]
    buf, route = ep_dispatch(p, xl, cfg, e_shards, capacity_factor)
    recv = mesh.all_to_all(buf, "model")
    out = ep_experts(expert_slab(p, mesh.index(("model",)), e_shards), recv,
                     e_shards, route[3])
    back = mesh.all_to_all(out, "model")
    return ep_combine(back, xl.shape, route, cfg)


def moe_ffn_ep_plain(p: Weights, x3d: torch.Tensor, cfg: ArchConfig,
                     dp: int, model: int, capacity_factor: float = 1.25
                     ) -> torch.Tensor:
    """:func:`moe_ffn_ep` on a grid of ``dp`` batch blocks and ``model``
    sequence blocks, in one process: every rank's body in turn, the two
    exchanges done as the (sender, receiver) transpose ``all_to_all``
    performs.  Returns the whole (B, S, d) output (each rank's block in its
    place); the one-group path where :func:`ep_applies` does not hold."""
    b, s, d = x3d.shape
    if not ep_applies(cfg, dp, model, b, s):
        return moe_ffn(p, x3d.reshape(1, b * s, d), cfg,
                       capacity_factor)[0].reshape(b, s, d)
    bl, sl = b // dp, s // model
    y = torch.empty_like(x3d)
    for r in range(dp):
        blocks = [x3d[r * bl:(r + 1) * bl, j * sl:(j + 1) * sl]
                  for j in range(model)]
        sent = [ep_dispatch(p, xl, cfg, model, capacity_factor)
                for xl in blocks]
        cap = sent[0][1][3]
        bufs = torch.stack([buf for buf, _ in sent])     # (src, dst, ...)
        outs = torch.stack([
            ep_experts(expert_slab(p, j, model), bufs[:, j].reshape(-1, d),
                       model, cap)
            for j in range(model)])                      # (expert rank, src)
        for j, (xl, (_, route)) in enumerate(zip(blocks, sent)):
            back = outs[:, j].reshape(-1, d)
            y[r * bl:(r + 1) * bl, j * sl:(j + 1) * sl] = ep_combine(
                back, xl.shape, route, cfg)
    return y


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class MoEFFN(_Leaves):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__(moe_shapes(cfg), dtype, device)


class MoELayer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.attn = Attention(cfg, dtype, device)
        self.moe = MoEFFN(cfg, dtype, device)
        self.norm_attn = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                                 device=device))
        self.norm_mlp = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                                device=device))

    def weights(self, dtype) -> Weights:
        """This layer's parameters cast to ``dtype``, as the reference's
        ``layer_p`` dict: ``{"attn": {...}, "moe": {...}, "norm_attn",
        "norm_mlp"}``."""
        return {"attn": self.attn.leaves(dtype), "moe": self.moe.leaves(dtype),
                "norm_attn": self.norm_attn.to(dtype),
                "norm_mlp": self.norm_mlp.to(dtype)}


class MoETransformer(nn.Module):
    """``embed``, the layers, ``norm_f`` and ``unembed`` (the reference's
    MoE model always has its own unembedding)."""

    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              dtype=dtype, device=device))
        self.layers = nn.ModuleList(MoELayer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.norm_f = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                              device=device))
        self.unembed = nn.Parameter(torch.empty((cfg.d_model, cfg.vocab),
                                                dtype=dtype, device=device))
        self._cast: Optional[tuple] = None

    def compute_weights(self, dtype) -> Tuple[List[Weights], torch.Tensor]:
        """Every layer's weights and the unembedding in ``dtype``, kept
        outside autograd until a parameter changes (as
        ``Transformer.compute_weights``)."""
        return cached_cast(self, dtype, lambda: (
            [layer.weights(dtype) for layer in self.layers],
            self.unembed.to(dtype)))

    def forward(self, tokens, extra_embeds=None,
                compute_dtype=torch.bfloat16, unembed: bool = True):
        return forward(self, tokens, self.cfg, extra_embeds=extra_embeds,
                       compute_dtype=compute_dtype, unembed=unembed)


def moe_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
               dtype=torch.float32, prefix: str = ""
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(prefix + name, value)`` of one MoE block's parameters from
    :func:`dense_init`, drawn one at a time (router, then the stacked
    experts)."""
    for name, shape in moe_shapes(cfg).items():
        yield prefix + name, dense_init(generator, shape, dtype)


def layer_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                 dtype=torch.float32, prefix: str = ""
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """One layer's parameters one at a time in draw order: attention, the
    MoE block, then the norms (ones, which draw nothing)."""
    yield from attention_leaves(generator, cfg, dtype, prefix + "attn.")
    yield from moe_leaves(generator, cfg, dtype, prefix + "moe.")
    for name in ("norm_attn", "norm_mlp"):
        yield prefix + name, torch.ones(cfg.d_model, dtype=dtype,
                                        device=draw_device(generator))


def init_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                dtype=torch.float32) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every parameter of a :class:`MoETransformer` as ``(its
    named_parameters name, value)``, made one at a time in draw order:
    embed, layers 0..L-1, unembed, then ``norm_f`` (the model's one draw
    sequence, as ``transformer.init_leaves``); a None ``generator`` gives
    the leaves on ``meta``."""
    yield "embed", dense_init(generator, (cfg.vocab, cfg.d_model), dtype,
                              scale=1.0)
    for i in range(cfg.n_layers):
        yield from layer_leaves(generator, cfg, dtype, f"layers.{i}.")
    yield "unembed", dense_init(generator, (cfg.d_model, cfg.vocab), dtype)
    yield "norm_f", torch.ones(cfg.d_model, dtype=dtype,
                               device=draw_device(generator))


def init_layer(generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32, layer: Optional[MoELayer] = None
               ) -> MoELayer:
    """Draw one layer's weights (:func:`layer_leaves`) into ``layer``, or
    into a new :class:`MoELayer`."""
    if layer is None:
        layer = MoELayer(cfg, dtype, generator.device)
    fill(layer, layer_leaves(generator, cfg, dtype))
    return layer


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> MoETransformer:
    """A :class:`MoETransformer` on the generator's device, filled from
    :func:`init_leaves`."""
    model = MoETransformer(cfg, dtype, generator.device)
    fill(model, init_leaves(generator, cfg, dtype))
    return model


def layer_fwd(p: Weights, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, flash: bool = True) -> torch.Tensor:
    h = x + attention(p["attn"], rmsnorm(x, p["norm_attn"], cfg.norm_eps),
                      cfg, positions, flash=flash)
    return h + moe_ffn_ep(p["moe"], rmsnorm(h, p["norm_mlp"], cfg.norm_eps),
                          cfg)


def _remat_layer(x: torch.Tensor, layer: MoELayer, cfg: ArchConfig,
                 positions: torch.Tensor, compute_dtype, flash: bool
                 ) -> torch.Tensor:
    return layer_fwd(layer.weights(compute_dtype), x, cfg, positions, flash)


def forward(params: MoETransformer, tokens: torch.Tensor, cfg: ArchConfig,
            extra_embeds: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, unembed: bool = True, *,
            remat: bool = True, flash: bool = True,
            n_groups: Optional[int] = None) -> torch.Tensor:
    """Logits (B, S_total, vocab) in f32, or the final hidden states in the
    compute dtype if not ``unembed``; ``extra_embeds`` (B, P, d) are
    prepended.  Every layer's MoE block takes all B * S tokens as one
    dispatch group (no grid).  ``flash`` picks the attention path and
    ``remat`` recomputes each layer in backward, as in
    ``transformer.forward``.  ``n_groups`` is accepted and unused, as in
    the reference (``src/repro/models/moe.py:222,228``)."""
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
        w = params.unembed.to(compute_dtype)
    return (x @ w).float()


def lm_loss(params: MoETransformer, batch: Dict[str, torch.Tensor],
            cfg: ArchConfig, remat: bool = True,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Next-token cross-entropy (scalar f32) through
    :func:`chunked_lm_loss` with ``unembed``, on the plain attention path
    (the flash kernel has no backward)."""
    hidden = forward(params, batch["tokens"], cfg,
                     compute_dtype=compute_dtype, unembed=False,
                     remat=remat, flash=False)
    return chunked_lm_loss(hidden, params.unembed, batch["labels"],
                           compute_dtype=compute_dtype)


@torch.no_grad()
def decode_step(params: MoETransformer, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: int, cfg: ArchConfig,
                compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token of decode with a static KV cache: logits (B, vocab) in
    f32; the B tokens of the step are one dispatch group.  Row ``pos`` of
    every layer's cache is written in place; the same dict is returned."""
    x = params.embed[token.long()][:, None, :].to(compute_dtype)   # (B,1,d)
    layers, w = params.compute_weights(compute_dtype)
    for i, layer_p in enumerate(layers):
        hn = rmsnorm(x, layer_p["norm_attn"], cfg.norm_eps)
        a, _, _ = attention_decode(layer_p["attn"], hn, cfg, cache["k"][i],
                                   cache["v"][i], pos)
        x = x + a
        x = x + moe_ffn_ep(layer_p["moe"],
                           rmsnorm(x, layer_p["norm_mlp"], cfg.norm_eps),
                           cfg)
    x = rmsnorm(x, params.norm_f, cfg.norm_eps)
    return (x[:, 0, :] @ w).float(), cache
