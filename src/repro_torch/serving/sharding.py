"""The serving steps with their parameters and decode state sharded over
the ``data x model`` grid: the counterparts of ``api.make_prefill_step``
and ``api.make_decode_step`` that the reference jits with the shardings
of ``param_pspecs``, ``batch_pspecs`` and ``cache_pspecs``
(``repro.launch.dryrun``), for every family.

* **Parameters** are a rank's blocks, placed and used as the sharded
  train step places and uses them (``training/sharding.py``: FSDP gathers
  over ``"data"``, attention, the SwiGLU and the recurrent blocks split by
  heads over ``"model"``, moe's experts over ``"model"``, the vocabulary
  over ``"model"``), with the same layer functions; only the attention path
  differs: the flash kernel (``Step.flash``), as the unsharded serving
  steps take it.
* **The batch** goes over ``batch_axes_for(B, mesh, ("pod", "data"))``:
  every rank is handed the whole global batch (or the whole token column)
  and takes its block.  A step returns the rank's batch block: a prefill
  the last position's logits (f32, whole over the vocabulary: the layout
  ``P(dp, None)`` the reference puts on a decode's logits), an encdec
  prefill its encoder memory in the compute dtype; a decode step the
  logits.  A prefill unembeds the last position only (the reference
  unembeds every position and keeps the last: the same values).
* **The decode state** (:class:`ShardedCache`) holds the rank's block of
  every leaf of ``api.init_decode_cache``'s tree by ``api.cache_pspecs``,
  leaf for leaf the reference's blocks, so a rank's bytes are the
  reference's per-device bytes.  A decode step updates the blocks in
  place.
* **KV length parallelism** (dense, vlm, moe, the hybrid's shared block,
  encdec's self-attention): a rank holds rows ``mesh.block(T, "model")`` of
  every layer's (B, T, Hkv, hd) cache.  The new q, k and v (the rank's
  heads, when attention runs split) are gathered over ``"model"`` to all
  heads; the rank that owns row ``pos`` writes it (clamped, as
  ``dynamic_update_slice`` clamps); each rank scores all heads against its
  rows under the ``finfo.min`` mask of ``arange(T) <= pos`` on absolute
  rows; the softmax is exact across ranks: the row maxima reduced with
  ``max`` over ``"model"``, then ``exp(s - M)`` and the partial ``P V``
  summed over ``"model"`` in f32 (one reduction), divided.  A rank whose
  rows are all masked adds exactly zero (``exp(finfo.min - M)`` is 0).
  The rank's heads of the result go into the row-parallel ``wo``.
* **encdec cross-attention** at one query row runs the flash kernel on the
  rank's rows of the cross K / V with its log-sum-exp (``lse=True``);
  the slices merge exactly: ``out = sum_r exp(lse_r - M) out_r / sum_r
  exp(lse_r - M)``, ``M`` the maximum over ``"model"``.
* **moe** at S = 1 runs every token of the global batch as one group (the
  expert-parallel rules need ``model`` to divide S), as the reference
  does; a prefill runs expert-parallel where ``moe.ep_applies`` holds.
* **Recurrent states** are read as the heads a rank runs need them and
  written back into the blocks the specs give: Mamba2's ``ssm`` is stored
  by heads over ``"model"`` (its heads are a rank's); its conv window by
  channels over ``"model"``, blocks that cut across ``[x, B, C]``, so the
  window is gathered over ``"model"``, stepped whole and cut back; the
  mLSTM's ``C`` by heads.  The reference's catch-all rule gives the other
  xLSTM states (``(B, H, hd)``: ``n``, ``c``, ``h``; ``(B, H)``: ``m``)
  the batch axes on their second-to-last dim: on a grid whose batch axes
  divide the heads, a rank stores a block of *heads* over ``"data"``.
  That block is kept as it is: a rank gathers what its step reads, and
  the new state is assembled from every rank's part (a sum over the axes
  along which the parts differ) and cut to the stored block.

Every collective is an ``NMFMesh`` call on the axis names of
``launch/mesh.py::AXES``, counted in ``collective_counts()``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.mesh import NMFMesh
from repro_torch.models import api, common, mamba, xlstm
from repro_torch.models.api import batch_axes_for
from repro_torch.models.common import ArchConfig, apply_rope, rmsnorm
from repro_torch.training.sharding import (
    BATCH_AXES,
    Shards,
    Step,
    attention_leaves,
    block_index,
    dense_layer,
    embed_tokens,
    mamba_layer,
    mlp_block,
    mlstm_layer,
    moe_block,
    moe_layer,
    seq_positions,
    slstm_layer,
    split_rmsnorm,
    unembed_matrix,
    whole_leaves,
)

__all__ = ["ShardedCache", "shard_cache", "init_sharded_cache",
           "drawn_cache", "cache_bytes", "make_prefill_step",
           "make_decode_step"]


# ---------------------------------------------------------------------------
# The decode state on the grid
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedCache:
    """A decode state on ``mesh``: ``blocks`` is the tree of
    ``api.init_decode_cache`` (dicts, lists, None) holding this rank's block
    of every leaf; ``specs`` and ``shapes`` hold each leaf's spec
    (``api.cache_pspecs``) and whole shape in the same tree."""

    mesh: NMFMesh
    blocks: Any
    specs: Any
    shapes: Any


def _tree_map(fn: Callable, tree, *rest, name: Optional[str] = None):
    """``fn(innermost key, leaf, *the leaves of rest at its place)`` over
    the tensors of ``tree`` (dicts and lists; None stays None), in order;
    ``rest`` follow its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), name=k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest), name=name)
                for i, v in enumerate(tree)]
    return fn(name, tree, *rest)


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _batch_dim(name: str, ndim: int) -> int:
    """The batch dim of a decode-state leaf: (…, B, T, Hkv, hd) for a KV
    cache, (…, B, H, P, N) for Mamba's ``ssm``, (…, B, K - 1, C) for its
    ``conv``, the first for the xLSTM states."""
    if name in ("k", "v", "ck", "cv", "ssm"):
        return ndim - 4
    if name == "conv":
        return ndim - 3
    return 0


def _dims(spec, shape) -> tuple:
    return tuple((d, shape[d], ax) for d, ax in enumerate(spec)
                 if ax is not None)


def _cut(mesh: NMFMesh, whole: torch.Tensor, spec) -> torch.Tensor:
    return whole[block_index(mesh, _dims(spec, whole.shape))].clone(
        memory_format=torch.contiguous_format)


def _shapes(tree):
    return _tree_map(lambda _, t: tuple(t.shape), tree)


def shard_cache(cache, cfg: ArchConfig, shape, mesh: NMFMesh
                ) -> ShardedCache:
    """This rank's block of every leaf of ``cache`` (the whole state of
    the shape cell ``shape``, as ``api.init_decode_cache`` makes it), by
    ``api.cache_pspecs``: copies; every rank passes the same state."""
    specs = api.cache_pspecs(cfg, shape, mesh, cache)
    blocks = _tree_map(lambda _, t, spec: _cut(mesh, t, spec), cache, specs)
    return ShardedCache(mesh, blocks, specs, _shapes(cache))


def _drawn(cfg: ArchConfig, shape, seed: int, dev: torch.device, dtype,
           cut: Callable, *specs):
    """The state of ``shape`` drawn from ``seed`` one whole leaf at a time
    in the tree's order, each leaf passed to ``cut(name, leaf, *its spec)``
    and freed before the next is drawn: standard normal, but the xLSTM
    normalisers ``n`` at ``1 + |N(0, 1)|`` (positive, as a state that has
    seen tokens holds them)."""
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    meta = api.init_decode_cache(cfg, shape, dtype=dtype, device="meta")

    def one(name, leaf, *spec):
        x = torch.randn(tuple(leaf.shape), generator=gen, device=dev)
        if name == "n":
            x = x.abs_().add_(1.0)
        return cut(name, x.to(leaf.dtype), *spec)

    return _tree_map(one, meta, *specs)


def drawn_cache(cfg: ArchConfig, shape, seed: int, device: DeviceLike = None,
                dtype=torch.bfloat16, rows: Optional[slice] = None):
    """The whole state of ``shape`` as :func:`init_sharded_cache` draws it
    from ``seed`` on ``device``; with ``rows``, only those rows of each
    leaf's batch dim (:func:`_batch_dim`) are kept: the state an unsharded
    step reads for one batch block of the grid."""
    def cut(name, leaf):
        if rows is None:
            return leaf
        index = (slice(None),) * _batch_dim(name, leaf.dim()) + (rows,)
        return leaf[index].clone(memory_format=torch.contiguous_format)

    return _drawn(cfg, shape, seed, resolve_device(device), dtype, cut)


def init_sharded_cache(cfg: ArchConfig, shape, mesh: NMFMesh,
                       device: DeviceLike = None, seed: Optional[int] = None,
                       dtype=torch.bfloat16) -> ShardedCache:
    """The decode state of ``shape`` on ``mesh``, only this rank's blocks
    allocated (on ``device``: the card unless the CPU or ``meta`` is asked
    for).  Without ``seed`` it is ``api.init_decode_cache``'s state (zeros;
    the xLSTM max states at their start, -1e30); with one, each whole leaf
    is drawn from ``seed`` in turn (:func:`drawn_cache`), its block kept
    and the leaf freed before the next is drawn.  ``dtype`` is the KV
    cache's (the recurrent states are f32)."""
    dev = resolve_device(device)
    meta = api.init_decode_cache(cfg, shape, dtype=dtype, device="meta")
    specs = api.cache_pspecs(cfg, shape, mesh, meta)
    if seed is not None:
        blocks = _drawn(cfg, shape, seed, dev, dtype,
                        lambda _, w, spec: _cut(mesh, w, spec), specs)
        return ShardedCache(mesh, blocks, specs, _shapes(meta))

    def empty(name, leaf, spec):
        blk = _cut(mesh, leaf, spec)
        fill = xlstm._NEG if cfg.family == "ssm" and name == "m" else 0.0
        return torch.full(tuple(blk.shape), fill, dtype=leaf.dtype,
                          device=dev)

    return ShardedCache(mesh, _tree_map(empty, meta, specs), specs,
                        _shapes(meta))


def cache_bytes(cache: ShardedCache) -> int:
    """This rank's bytes of the state."""
    return sum(t.numel() * t.element_size() for t in _leaves(cache.blocks))


# ---------------------------------------------------------------------------
# Reading and writing a rank's part of a state leaf
# ---------------------------------------------------------------------------

def _axes(ax) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (``()`` for None)."""
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One state leaf on the grid: this rank's ``block``, the leaf's
    ``spec`` and whole ``shape`` (its leading stacked dims, never sharded,
    cut off by :meth:`at`).

    A part of the leaf is named by axes, one entry a dim (None: the whole
    dim; else the axes it is blocked over), so that every rank makes the
    same choice between a local cut and a collective."""

    mesh: NMFMesh
    block: torch.Tensor
    spec: tuple
    shape: tuple

    def at(self, *lead: int) -> "_Leaf":
        n = len(lead)
        return _Leaf(self.mesh, self.block[lead], self.spec[n:],
                     self.shape[n:])

    def _slice(self, d: int, axes) -> slice:
        n = self.shape[d]
        return self.mesh.block(n, axes) if _axes(axes) else slice(0, n)

    def held(self) -> Tuple[slice, ...]:
        """The part of the whole leaf this rank's block is, a slice a
        dim."""
        return tuple(self._slice(d, ax) for d, ax in enumerate(self.spec))

    def read(self, want: tuple) -> torch.Tensor:
        """The part ``want`` (axes a dim) of the whole leaf: cut from the
        block along a dim blocked as it wants or not blocked at all,
        gathered over the dim's axes otherwise."""
        t = self.block
        for d, (ax, w) in enumerate(zip(self.spec, want)):
            if _axes(ax) and _axes(ax) != _axes(w):
                t = self.mesh.gather(t, self.shape[d], ax, d)
        held = [self._slice(d, ax if _axes(ax) == _axes(w) else None)
                for d, (ax, w) in enumerate(zip(self.spec, want))]
        return t[tuple(slice(s.start - h.start, s.stop - h.start)
                       for s, h in zip((self._slice(d, w)
                                        for d, w in enumerate(want)), held))]

    def write(self, value: torch.Tensor, want: tuple,
              axes: Tuple[str, ...]) -> None:
        """Store ``value``, the part ``want`` of the leaf's new value that
        this rank computed, into its block.  Where the block holds more
        than ``want`` along some dim, the whole is assembled first: every
        rank's part in a zero-filled leaf, summed over ``axes`` (those
        along which the ranks' parts differ)."""
        held = self.held()
        parts = tuple(self._slice(d, w) for d, w in enumerate(want))
        if all(not _axes(w) or _axes(w) == _axes(ax)
               for ax, w in zip(self.spec, want)):
            self.block.copy_(value[tuple(
                slice(h.start - p.start, h.stop - p.start)
                for p, h in zip(parts, held))])
            return
        whole = value.new_zeros(self.shape)
        whole[parts] = value
        whole = self.mesh.all_reduce(whole, axes)
        self.block.copy_(whole[held])


def _leaf(cache: ShardedCache, *path) -> _Leaf:
    blk, spec, shape = cache.blocks, cache.specs, cache.shapes
    for key in path:
        blk, spec, shape = blk[key], spec[key], shape[key]
    return _Leaf(cache.mesh, blk, spec, shape)


@dataclasses.dataclass(frozen=True)
class _Parts:
    """What a rank's decode step reads of a recurrent state, as axes: its
    batch rows (blocked over ``rows``), the heads it runs (over
    ``heads``), and the axes along which ranks' parts differ."""

    rows: Tuple[str, ...]
    heads: Tuple[str, ...]
    axes: Tuple[str, ...]

    def want(self, leaf: _Leaf, by_heads: bool = True) -> tuple:
        """The rank's part of ``leaf`` (B, H, ...): its rows and heads (or
        every channel but its rows, ``by_heads`` False)."""
        rest = (None,) * (len(leaf.shape) - 1)
        if by_heads:
            rest = (self.heads or None,) + rest[1:]
        return (self.rows or None,) + rest


def _parts(step: Step) -> _Parts:
    heads = ("model",) if step.shards.tp_ssm else ()
    return _Parts(step.sum_axes, heads, step.sum_axes + heads)


# ---------------------------------------------------------------------------
# Attention against a cache split by rows over "model"
# ---------------------------------------------------------------------------

def _gather_heads(step: Step, x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, heads, hd) of this rank's heads gathered to all ``n``."""
    return step.mesh.gather(x, n, "model", 2)


def _heads_out(step: Step, wo: torch.Tensor, out: torch.Tensor
               ) -> torch.Tensor:
    """All heads' attention output (B, 1, H, hd) through ``wo``: this
    rank's heads through its rows of ``wo``, summed over ``"model"``, when
    attention runs split."""
    tp = step.shards.tp_attn
    if tp:
        out = out[:, :, step.model_slice(step.cfg.n_heads)]
    return step.from_model(out.reshape(out.shape[0], 1, -1) @ wo, tp)


def _kv_attend(step: Step, q: torch.Tensor, k: _Leaf, v: _Leaf, pos: int
               ) -> torch.Tensor:
    """q (B, 1, H, hd) of all heads against this rank's rows of the cache
    (B, T_loc, Hkv, hd): (B, 1, H, hd) in q's dtype, the softmax over every
    rank's rows (the reference's ``attention_decode`` numerics on one
    rank's rows)."""
    cfg, dtype = step.cfg, q.dtype
    rows = k.held()[1]
    scores = common._gqa_scores(q, k.block.to(dtype), cfg)      # (B,H,1,T)
    valid = torch.arange(rows.start, rows.stop, device=q.device) <= pos
    scores = scores.masked_fill(~valid, torch.finfo(scores.dtype).min)
    vf = common._expand_kv(v.block.to(dtype), cfg)
    if k.spec[1] is None:
        probs = torch.softmax(scores.float(), dim=-1).to(dtype)
        return torch.einsum("bhst,bthd->bshd", probs, vf)
    mesh = step.mesh
    top = mesh.all_reduce(scores.float().amax(-1, keepdim=True), "model",
                          op="max")
    p = torch.exp(scores.float() - top)                         # (B,H,1,T)
    part = torch.einsum("bhst,bthd->bshd", p.to(dtype), vf).float()
    denom = p.sum(-1).transpose(1, 2)[..., None]                # (B,1,H,1)
    tot = mesh.all_reduce(torch.cat([part, denom], dim=-1), "model")
    return (tot[..., :-1] / tot[..., -1:]).to(dtype)


def _attention_decode(step: Step, attn: nn.Module, prefix: str,
                      hn: torch.Tensor, k: _Leaf, v: _Leaf, pos: int
                      ) -> torch.Tensor:
    """``common.attention_decode`` on the grid: ``hn`` (B_loc, 1, d), the
    layer's cache ``k`` / ``v`` (B, T, Hkv, hd) with this rank's rows; row
    ``pos`` written by the rank that holds it; the output summed over
    ``"model"`` when attention runs split."""
    cfg = step.cfg
    tp = step.shards.tp_attn
    a = attention_leaves(step, attn, prefix)
    q, kn, vn = common._qkv(a, step.to_model(hn, tp), step.heads_cfg())
    positions = torch.full((hn.shape[0], 1), int(pos), dtype=torch.int32,
                           device=hn.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    kn = apply_rope(kn, positions, cfg.rope_theta)
    if tp:
        q = _gather_heads(step, q, cfg.n_heads)
        kn = _gather_heads(step, kn, cfg.n_kv_heads)
        vn = _gather_heads(step, vn, cfg.n_kv_heads)
    rows = k.held()[1]
    row = min(max(int(pos), 0), k.shape[1] - 1)   # dynamic_update_slice
    if rows.start <= row < rows.stop:
        k.block[:, row - rows.start] = kn[:, 0].to(k.block.dtype)
        v.block[:, row - rows.start] = vn[:, 0].to(v.block.dtype)
    return _heads_out(step, a["wo"], _kv_attend(step, q, k, v, int(pos)))


def _cross_decode(step: Step, attn: nn.Module, prefix: str,
                  hn: torch.Tensor, ck: _Leaf, cv: _Leaf) -> torch.Tensor:
    """An encdec decode step's cross-attention on the grid: one query row
    a sequence through the flash kernel over this rank's rows of the cross
    K / V, the ranks' slices merged by their log-sum-exps."""
    cfg = step.cfg
    tp = step.shards.tp_attn
    a = attention_leaves(step, attn, prefix)
    x = step.to_model(hn, tp)
    q = x @ a["wq"]
    if "bq" in a:
        q = q + a["bq"]
    q = q.reshape(x.shape[0], 1, -1, cfg.hd)
    if tp:
        q = _gather_heads(step, q, cfg.n_heads)
    kk, vv = ck.block, cv.block
    if kk.dtype != q.dtype:
        kk, vv = kk.to(q.dtype), vv.to(q.dtype)
    groups = cfg.n_heads // cfg.n_kv_heads
    args = (q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2))
    if ck.spec[1] is None:
        out = flash_attention(*args, causal=False, groups=groups)
    else:
        out, lse = flash_attention(*args, causal=False, groups=groups,
                                   lse=True)
        mesh = step.mesh
        top = mesh.all_reduce(lse, "model", op="max")
        w = torch.exp(lse - top)[..., None]                     # (B,H,1,1)
        tot = mesh.all_reduce(torch.cat([w * out.float(), w], dim=-1),
                              "model")
        out = (tot[..., :-1] / tot[..., -1:]).to(q.dtype)
    return _heads_out(step, a["wo"], out.transpose(1, 2))


# ---------------------------------------------------------------------------
# Recurrent blocks, one token
# ---------------------------------------------------------------------------

def _mamba_decode(step: Step, block: nn.Module, prefix: str,
                  x: torch.Tensor, parts: _Parts, conv: _Leaf, ssm: _Leaf
                  ) -> torch.Tensor:
    """``mamba.mamba_decode`` on the grid: ``in_proj`` and ``conv_w``
    gathered whole; the conv window (gathered over ``"model"``) stepped
    whole and written back cut to this rank's channels; the SSM on this
    rank's heads (all of them unless the block runs split), its state read
    and written as the specs keep it."""
    cfg = step.cfg
    tp = step.shards.tp_ssm
    di, n, hp = mamba.d_inner(cfg), cfg.ssm_state, cfg.ssm_head_dim
    h = mamba.n_ssm_heads(cfg)
    hs = step.model_slice(h) if tp else slice(0, h)
    cs = slice(hs.start * hp, hs.stop * hp)
    b = x.shape[0]
    xn = rmsnorm(x, step.leaf(block, prefix, "norm_in"), cfg.norm_eps)
    proj = xn @ step.leaf(block, prefix, "in_proj")
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    old = conv.read(parts.want(conv, by_heads=False))
    win = torch.cat([old.to(xbc.dtype), xbc], dim=1)            # (B,K,C)
    conv.write(win[:, 1:, :].to(old.dtype), parts.want(conv, by_heads=False),
               step.sum_axes)
    ar = functools.partial(torch.arange, device=x.device)
    chans = torch.cat([ar(cs.start, cs.stop), di + ar(2 * n)])
    conv_w = step.leaf(block, prefix, "conv_w")[:, chans]
    conv_out = F.silu(torch.einsum("bkd,kd->bd", win[..., chans], conv_w))
    xin, bb, cc = torch.split(conv_out, [cs.stop - cs.start, n, n], dim=-1)
    p = {leaf: step.leaf(block, prefix, leaf)[hs]
         for leaf in ("A_log", "D", "dt_bias")}
    want = parts.want(ssm)
    y, s_new = mamba.ssm_step(p, xin.reshape(b, -1, hp), dt[:, 0, hs], bb,
                              cc, ssm.read(want), x.dtype)
    ssm.write(s_new, want, parts.axes)
    y = y.reshape(b, 1, -1).to(x.dtype) * F.silu(z[..., cs])
    gate_norm = step.leaf(block, prefix, "gate_norm")[cs]
    y = (split_rmsnorm(step, y, gate_norm, di) if tp
         else rmsnorm(y, gate_norm, cfg.norm_eps))
    out_proj = step.leaf(block, prefix, "out_proj", keep_model=tp)
    return (x + step.from_model(y @ out_proj, tp)).to(x.dtype)


def _mlstm_decode(step: Step, block: nn.Module, prefix: str,
                  x: torch.Tensor, state: Dict[str, torch.Tensor]):
    """``xlstm.mlstm_decode`` on the grid: whole, or this rank's heads
    (``xi`` and the gates from the whole ``w_up`` / ``w_if``, as the
    train step's mLSTM)."""
    cfg = step.cfg
    if not step.shards.tp_ssm:
        return xlstm.mlstm_decode(whole_leaves(step, block, prefix), x,
                                  state, cfg)
    up = 2 * cfg.d_model
    hd = up // cfg.n_heads
    hs = step.model_slice(cfg.n_heads)
    cs = slice(hs.start * hd, hs.stop * hd)
    p = {leaf: step.leaf(block, prefix, leaf)
         for leaf in ("norm", "w_up", "w_if", "b_i", "b_f")}
    xi, gate, i_log, f_log = xlstm._mlstm_in(p, x, cfg)
    w = {leaf: step.leaf(block, prefix, leaf, keep_model=True)
         for leaf in ("wq", "wk", "wv", "w_down")}
    y, new = xlstm.mlstm_decode_heads(xi[:, 0], w["wq"], w["wk"], w["wv"],
                                      i_log[:, 0, hs], f_log[:, 0, hs],
                                      state, hd, x.dtype)
    out_norm = step.leaf(block, prefix, "out_norm")[cs]
    y = xlstm.block_out(y, out_norm, w["w_down"], functools.partial(
        split_rmsnorm, step, n=up), gate[..., cs])
    return x + step.from_model(y, True), new


# ---------------------------------------------------------------------------
# The logits
# ---------------------------------------------------------------------------

def _logits(step: Step, model: nn.Module, x: torch.Tensor, norm: str
            ) -> torch.Tensor:
    """The last position's logits (B_loc, vocab) in f32, whole over the
    vocabulary: the final norm (its f32 weight, as the unsharded steps),
    the unembedding (this rank's vocabulary when it is split, then
    gathered)."""
    x = rmsnorm(x[:, -1], getattr(model, norm), step.cfg.norm_eps)
    logits = (x @ unembed_matrix(step, model)).float()
    if step.shards.tp_vocab:
        logits = step.mesh.gather(logits, step.cfg.vocab, "model", -1)
    return logits


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _lm_prefill(model, batch, step: Step) -> torch.Tensor:
    x = embed_tokens(step, model, batch["tokens"])
    if batch.get("patch_embeds") is not None:
        x = torch.cat([batch["patch_embeds"].to(step.dtype), x], dim=1)
    positions = seq_positions(x)
    body = moe_layer if step.cfg.family == "moe" else dense_layer
    for i, layer in enumerate(model.layers):
        x = body(x, layer, f"layers.{i}.", step, positions)
    return _logits(step, model, x, "norm_f")


def _hybrid_prefill(model, batch, step: Step) -> torch.Tensor:
    x = embed_tokens(step, model, batch["tokens"])
    positions = seq_positions(x)
    for gi, grp in enumerate(model.groups):
        for ei, blk in enumerate(grp):
            x = mamba_layer(x, blk, f"groups.{gi}.{ei}.", step)
        x = dense_layer(x, model.shared, "shared.", step, positions)
    for ti, blk in enumerate(model.tail):
        x = mamba_layer(x, blk, f"tail.{ti}.", step)
    return _logits(step, model, x, "norm_f")


def _xlstm_prefill(model, batch, step: Step) -> torch.Tensor:
    x = embed_tokens(step, model, batch["tokens"])
    for li, blk in enumerate(model.layers):
        if li in step.cfg.slstm_at:
            x = slstm_layer(x, blk, f"layers.{li}.", step)[0]
        else:
            x = mlstm_layer(x, blk, f"layers.{li}.", step)
    return _logits(step, model, x, "norm_f")


def _encdec_prefill(model, batch, step: Step) -> torch.Tensor:
    """The encoder memory of the rank's frames, in the compute dtype."""
    x = batch["frame_embeds"].to(step.dtype)
    positions = seq_positions(x)
    for i, layer in enumerate(model.enc_layers):
        x = dense_layer(x, layer, f"enc_layers.{i}.", step, positions,
                        False)
    return rmsnorm(x, model.norm_enc, step.cfg.norm_eps)


_PREFILLS = {"dense": _lm_prefill, "vlm": _lm_prefill, "moe": _lm_prefill,
             "hybrid": _hybrid_prefill, "ssm": _xlstm_prefill,
             "encdec": _encdec_prefill}


def _step_for(cfg, shards, b, compute_dtype, capacity_factor):
    axes = batch_axes_for(b, shards.mesh, BATCH_AXES)
    return Step(cfg, shards, axes, compute_dtype, capacity_factor,
                flash=True)


def make_prefill_step(cfg: ArchConfig, shards: Shards,
                      compute_dtype=torch.bfloat16,
                      capacity_factor: float = 1.25) -> Callable:
    """``prefill_step(model, batch)`` on the grid, without autograd:
    ``model`` holds this rank's blocks (``training.sharding.shard_model`` /
    ``init_sharded``), ``batch`` is the whole global batch on every rank
    (``api.input_specs``' prefill inputs), of which the rank takes its
    block.  Returns the rank's batch block of the last position's logits
    (f32, whole over the vocabulary), or for ``encdec`` of the encoder
    memory in the compute dtype.  ``capacity_factor`` is the MoE
    blocks'."""
    def prefill_step(model, batch):
        b = next(iter(batch.values())).shape[0]
        step = _step_for(cfg, shards, b, compute_dtype, capacity_factor)
        if step.sum_axes:
            rows = shards.mesh.block(b, step.sum_axes)
            batch = {k: v[rows] for k, v in batch.items()}
        with torch.no_grad():
            return _PREFILLS[cfg.family](model, batch, step)

    return prefill_step


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _lm_decode(model, cache: ShardedCache, tok, pos: int, step: Step):
    eps = step.cfg.norm_eps
    x = embed_tokens(step, model, tok[:, None])
    k, v = _leaf(cache, "k"), _leaf(cache, "v")
    for i, layer in enumerate(model.layers):
        pre = f"layers.{i}."
        hn = rmsnorm(x, step.leaf(layer, pre, "norm_attn"), eps)
        x = x + _attention_decode(step, layer.attn, pre + "attn.", hn,
                                  k.at(i), v.at(i), pos)
        hn = rmsnorm(x, step.leaf(layer, pre, "norm_mlp"), eps)
        if step.cfg.family == "moe":
            x = x + moe_block(step, layer.moe, pre + "moe.", hn)
        else:
            x = x + mlp_block(step, layer.mlp, pre + "mlp.", hn)
    return _logits(step, model, x, "norm_f")


def _hybrid_decode(model, cache: ShardedCache, tok, pos: int, step: Step):
    eps = step.cfg.norm_eps
    parts = _parts(step)
    x = embed_tokens(step, model, tok[:, None])
    k, v = _leaf(cache, "k"), _leaf(cache, "v")
    shared = model.shared
    for gi, grp in enumerate(model.groups):
        for ei, blk in enumerate(grp):
            x = _mamba_decode(step, blk, f"groups.{gi}.{ei}.", x, parts,
                              _leaf(cache, "groups", "conv").at(gi, ei),
                              _leaf(cache, "groups", "ssm").at(gi, ei))
        hn = rmsnorm(x, step.leaf(shared, "shared.", "norm_attn"), eps)
        x = x + _attention_decode(step, shared.attn, "shared.attn.", hn,
                                  k.at(gi), v.at(gi), pos)
        hn = rmsnorm(x, step.leaf(shared, "shared.", "norm_mlp"), eps)
        x = x + mlp_block(step, shared.mlp, "shared.mlp.", hn)
    if len(model.tail) and cache.blocks["tail"] is not None:
        for ti, blk in enumerate(model.tail):
            x = _mamba_decode(step, blk, f"tail.{ti}.", x, parts,
                              _leaf(cache, "tail", "conv").at(ti),
                              _leaf(cache, "tail", "ssm").at(ti))
    return _logits(step, model, x, "norm_f")


def _xlstm_decode(model, cache: ShardedCache, tok, pos: int, step: Step):
    cfg = step.cfg
    parts = _parts(step)
    x = embed_tokens(step, model, tok[:, None])
    for li, blk in enumerate(model.layers):
        leaves = {name: _leaf(cache, li, name) for name in cache.blocks[li]}
        state = {name: lf.read(parts.want(lf))
                 for name, lf in leaves.items()}
        if li in cfg.slstm_at:
            x, new = slstm_layer(x, blk, f"layers.{li}.", step, state)
        else:
            x, new = _mlstm_decode(step, blk, f"layers.{li}.", x, state)
        for name, lf in leaves.items():
            lf.write(new[name], parts.want(lf), parts.axes)
    return _logits(step, model, x, "norm_f")


def _encdec_decode(model, cache: ShardedCache, tok, pos: int, step: Step):
    eps = step.cfg.norm_eps
    x = embed_tokens(step, model, tok[:, None])
    k, v = _leaf(cache, "k"), _leaf(cache, "v")
    ck, cv = _leaf(cache, "ck"), _leaf(cache, "cv")
    for i, layer in enumerate(model.dec_layers):
        pre = f"dec_layers.{i}."
        hn = rmsnorm(x, step.leaf(layer, pre, "norm_self"), eps)
        x = x + _attention_decode(step, layer.self_attn,
                                  pre + "self_attn.", hn, k.at(i), v.at(i),
                                  pos)
        hn = rmsnorm(x, step.leaf(layer, pre, "norm_cross"), eps)
        x = x + _cross_decode(step, layer.cross_attn, pre + "cross_attn.",
                              hn, ck.at(i), cv.at(i))
        hn = rmsnorm(x, step.leaf(layer, pre, "norm_mlp"), eps)
        x = x + mlp_block(step, layer.mlp, pre + "mlp.", hn)
    return _logits(step, model, x, "norm_dec")


_DECODES = {"dense": _lm_decode, "vlm": _lm_decode, "moe": _lm_decode,
            "hybrid": _hybrid_decode, "ssm": _xlstm_decode,
            "encdec": _encdec_decode}


def make_decode_step(cfg: ArchConfig, shards: Shards,
                     compute_dtype=torch.bfloat16,
                     capacity_factor: float = 1.25) -> Callable:
    """``decode_step(model, cache, token, pos)`` -> ``(logits, cache)`` on
    the grid, without autograd: ``model`` holds this rank's blocks,
    ``cache`` is a :class:`ShardedCache` (updated in place and returned),
    ``token`` the whole (B,) column of the step's tokens on every rank,
    ``pos`` the position (a host int).  The logits are the rank's batch
    block (f32, whole over the vocabulary).  Each family follows its
    unsharded ``decode_step``'s numerics (``models/common.py::
    attention_decode``, ``mamba_decode``, ``mlstm_decode``, ``slstm_seq``,
    the encdec cross-attention through the flash kernel)."""
    def decode_step(model, cache: ShardedCache, token, pos):
        b = token.shape[0]
        step = _step_for(cfg, shards, b, compute_dtype, capacity_factor)
        tok = token[shards.mesh.block(b, step.sum_axes)] \
            if step.sum_axes else token
        with torch.no_grad():
            logits = _DECODES[cfg.family](model, cache, tok, int(pos), step)
        return logits, cache

    return decode_step
