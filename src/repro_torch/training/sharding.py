"""The LM train step with its parameters sharded over the ``data x model``
grid: FSDP over ``"data"`` and tensor (and expert) parallelism over
``"model"``, placed by the reference's ``param_pspecs`` (``models/api.py``)
under the reference launcher's rules :data:`RULES`.  This is the port of
what GSPMD does with those specs in ``repro.launch.train``, for every
family: dense and vlm (``models/transformer.py``), moe (``models/moe.py``),
hybrid (``models/hybrid.py``), ssm (``models/xlstm.py``) and encdec
(``models/encdec.py``).

* **Storage.**  Each rank holds, of every leaf, exactly the block its spec
  gives it (``NMFMesh.block`` along each named dim), and AdamW's μ and ν
  have the same blocks, so a rank's parameter and moment bytes are the
  reference's per-device shard bytes.  AdamW runs unchanged on the blocks:
  it is elementwise and has no global norm.  How a block is computed never
  changes its storage.
* **FSDP.**  A layer's leaves are cast to the compute dtype and gathered
  over ``"data"`` just before the layer runs, and dropped after it; under
  remat the gather is issued again in the recompute.  A cast before the
  gather is the cast after it (a gather only moves values).
* **Tensor parallelism** (Megatron's split).  Attention's ``wq`` / ``wk`` /
  ``wv`` and the SwiGLU's ``w_gate`` / ``w_up`` are column-parallel (heads
  and d_ff split), ``wo`` / ``w_down`` row-parallel with one
  ``all_reduce`` over ``"model"`` in the forward; the conjugate pair
  (identity forward and ``all_reduce`` backward, and the reverse) is a
  ``torch.autograd.Function`` over ``NMFMesh.all_reduce``.  The embedding
  is split by vocabulary: a masked lookup, then an ``all_reduce``.  The
  unembedding (tied or not) leaves the logits split by vocabulary, so the
  chunked loss is vocabulary-parallel: the row max and the sum of
  exponentials are reduced over ``"model"``, and the label's logit comes
  from the rank that holds it.  These are the places where the reference's
  ``constrain`` hints put ``"model"``.  A block whose split would cut
  inside a head (``model`` not dividing its heads) keeps its sharded
  storage but is gathered over ``"model"`` too and computed whole, as is a
  block whose dims ``model`` does not divide (the specs then replicate it,
  e.g. seamless's vocabulary of 256,206 over 4 or 16).
* **Each family's blocks** (a rank's heads are the contiguous ``1 /
  model`` of them):

  - *dense, vlm*: as above.
  - *encdec*: the encoder layers are the dense layer, not causal; a
    decoder layer is causal self-attention, then cross-attention whose
    ``wk`` / ``wv`` act on the encoder memory (column-parallel by heads,
    as ``wq``: the memory enters behind the identity / sum conjugate once,
    before the first decoder layer), then the MLP.  The frame embeddings
    and the decoder tokens are both cut to the rank's batch block.
  - *moe*: attention is the dense layer's.  Where ``moe.ep_applies``
    holds, the experts run expert-parallel (the reference's ``shard_map``
    body): each ``"model"`` rank routes its ``S / model`` slice of its
    batch block with the router (FSDP only), exchanges the dispatch
    buffer through ``NMFMesh.all_to_all`` (its backward is the same
    exchange), runs its ``E / model`` experts (gathered over ``"data"``
    only), exchanges back and combines; the ``(B_loc, S / model, d)``
    result is gathered over ``"model"`` along the sequence, whose backward
    is the slice (the residual stream's gradient is the same on every
    ``"model"`` rank).  The router's gradient is summed over ``"model"``
    as well as over the batch axes: each ``"model"`` rank routes other
    tokens.  Elsewhere the experts are gathered whole and every token of
    the global (micro)batch runs as one group, as the reference runs them:
    the hidden states are gathered over the batch axes (backward the
    rank's block: a token's output reads only its own input).
  - *hybrid*: the shared block is the dense layer (its gradients add over
    its uses, one a group).  Mamba2 splits by SSM heads: ``in_proj`` emits
    [z, x, B, C, dt] and ``conv_w`` acts on [x, B, C], so their contiguous
    ``"model"`` blocks do not fall on heads: both are gathered whole, and
    a rank takes its heads' columns of z, x and dt and all of B and C
    (``A_log`` / ``D`` / ``dt_bias`` cut to its heads); ``gate_norm``'s
    RMS over all of d_inner sums its squares over ``"model"``, forward and
    backward; ``out_proj`` is row-parallel.  A leaf gathered over
    ``"model"`` and read only in part on each rank has a partial gradient
    on each: it is summed over ``"model"`` before the cut to the block.
  - *ssm* (xlstm): the mLSTM's ``w_up`` is chunked into the ``xi`` and gate
    halves, so its ``"model"`` block falls on halves, not heads: it is
    gathered whole and ``xi`` / the gate computed whole, as are the gate
    logits (``w_if``, FSDP only); ``wq`` / ``wk`` / ``wv`` split by heads,
    each rank takes its heads' gate logits and gate channels, ``out_norm``
    (over all ``up`` channels) sums its squares over ``"model"``, and
    ``w_down`` is row-parallel.  The sLSTM's ``w_in`` is column-parallel
    by heads, ``r`` and ``b`` (replicated) are cut to the rank's heads, its
    recurrence is per head, ``out_norm`` (over d) reduced as the mLSTM's,
    ``w_down`` row-parallel.

* **Gradients.**  A leaf's gradient is summed over the axes the batch is
  split over (``batch_axes_for``; none when the batch is replicated, as at
  a global batch of 2 on 4x1), and over ``"model"`` for a leaf read on a
  ``"model"`` rank's part of the tokens or channels only, then cut to the
  rank's block, in the backward of the gather.  The loss is each rank's
  sum divided by the global count, summed over the same axes.
* **Collectives.**  Every one is an ``NMFMesh.all_reduce`` (counted by
  ``collective_counts``) but the expert exchange's ``all_to_all``: a
  gather is a zero-filled ``all_reduce``, a reduce-scatter an
  ``all_reduce`` cut to the block.  Under gloo a CUDA tensor takes no
  other collective (an ``all_to_all`` is staged through the host), and
  gloo is how several ranks share one card; NCCL takes the same calls.
  Partial products are summed in f32; gathers (sums with zeros, exact)
  move the compute dtype.

**Initialisation.**  :func:`init_sharded` draws the model leaf by leaf
on the rank's device from the family's ``init_leaves`` (``api.init_leaves``),
the sequence the family's ``init_params`` fills a whole model from, keeps
the rank's block of each leaf and frees the leaf before the next is
drawn: no rank ever holds the whole model, and the blocks are bitwise
``shard_model(api.init_params(cfg, seed))``'s.

Checkpoints hold whole leaves (:func:`gather_state`, gathered one leaf at
a time and kept on the host by rank 0 only, written by rank 0 under a 1x1
run's names in the family's layout), and a restore reads one leaf at a
time and keeps the rank's block (:func:`restore_state`), so any grid shape
resumes any other.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.scan import scan
from repro_torch.launch.mesh import NMFMesh
from repro_torch.models import api, encdec, mamba, moe, xlstm
from repro_torch.models.api import batch_axes_for, param_pspecs
from repro_torch.models.common import ArchConfig, attention, mlp, rmsnorm
from repro_torch.training.optimizer import AdamState, AdamW

__all__ = ["RULES", "FAMILIES", "BATCH_AXES", "Shards", "Step",
           "block_index", "shard_model", "init_sharded", "gather_leaf",
           "gather_named", "gather_state", "restore_state", "state_bytes",
           "split_rmsnorm", "attention_leaves", "attention_block",
           "mlp_block", "dense_layer", "whole_leaves", "moe_block",
           "moe_layer", "mamba_layer", "mlstm_layer", "slstm_layer",
           "dec_layer", "embed_tokens", "unembed_matrix", "seq_positions",
           "make_train_step"]

#: the reference launcher's rules (``repro.launch.train``)
RULES = {"fsdp": "data", "tp": "model", "ep": "model"}
#: the families whose layers this step shards: every one
FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "encdec")
#: the axes a batch may be split over, in order
BATCH_AXES = ("pod", "data")

_ATTN_COLS, _ATTN_ROWS = ("wq", "wk", "wv"), ("wo",)
_MLP_COLS, _MLP_ROWS = ("w_gate", "w_up"), ("w_down",)
#: the first attention and SwiGLU block of each family (every one of a
#: model has the same specs)
_ATTN = {"dense": "layers.0.attn.", "vlm": "layers.0.attn.",
         "moe": "layers.0.attn.", "hybrid": "shared.attn.",
         "encdec": "enc_layers.0.attn."}
_MLP = {"dense": "layers.0.mlp.", "vlm": "layers.0.mlp.",
        "hybrid": "shared.mlp.", "encdec": "enc_layers.0.mlp."}


@dataclasses.dataclass(frozen=True)
class Shards:
    """Where every parameter of a sharded model lies: its spec over its
    own dims and its whole shape, keyed by its ``named_parameters`` name,
    on ``mesh``; and which blocks run split over ``"model"``: attention by
    heads, the SwiGLU by d_ff, the vocabulary, the recurrent blocks by
    heads (Mamba2, mLSTM, sLSTM), the experts by expert."""

    mesh: NMFMesh
    specs: Dict[str, tuple]
    shapes: Dict[str, Tuple[int, ...]]
    tp_attn: bool
    tp_mlp: bool
    tp_vocab: bool
    tp_ssm: bool = False
    ep: bool = False

    def dims(self, name: str, keep_model: bool = False):
        """``(dim, whole size, axes)`` of each sharded dim of ``name``,
        but a ``"model"`` dim that ``keep_model`` keeps split."""
        return tuple((d, self.shapes[name][d], ax)
                     for d, ax in enumerate(self.specs[name])
                     if ax is not None and not (keep_model and ax == "model"))


def block_index(mesh: NMFMesh, dims) -> tuple:
    """The index of this rank's block along ``dims`` (``(dim, whole size,
    axes)`` each)."""
    idx = [slice(None)] * (1 + max((d for d, _, _ in dims), default=-1))
    for d, total, axes in dims:
        idx[d] = mesh.block(total, axes)
    return tuple(idx)


def _tp_plan(cfg: ArchConfig, specs, m: int) -> Dict[str, bool]:
    """Which blocks run split over ``"model"``: each when ``model`` > 1,
    ``model`` divides the heads it splits, and the specs split every leaf
    of the block along it (``Shards``' fields)."""
    plan = dict(tp_attn=False, tp_mlp=False, tp_vocab=False, tp_ssm=False,
                ep=False)
    if m == 1:
        return plan

    def split(prefix, cols, rows, col_dim=1, row_dim=0):
        return (all(specs[prefix + n][col_dim] == "model" for n in cols)
                and all(specs[prefix + n][row_dim] == "model" for n in rows))

    fam = cfg.family
    if fam in _ATTN:
        plan["tp_attn"] = (cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
                           and split(_ATTN[fam], _ATTN_COLS, _ATTN_ROWS))
    if fam in _MLP:
        plan["tp_mlp"] = split(_MLP[fam], _MLP_COLS, _MLP_ROWS)
    plan["tp_vocab"] = specs["embed"][0] == "model" and (
        cfg.tie_embeddings or specs["unembed"][1] == "model")
    if fam == "moe":
        plan["ep"] = specs["layers.0.moe.w_gate"][0] == "model"
    elif fam == "hybrid":
        first = "groups.0.0." if "groups.0.0.out_proj" in specs else "tail.0."
        plan["tp_ssm"] = (mamba.n_ssm_heads(cfg) % m == 0
                          and specs[first + "out_proj"][0] == "model")
    elif fam == "ssm":
        ok = cfg.n_heads % m == 0
        for li in range(cfg.n_layers):
            pre = f"layers.{li}."
            if li in cfg.slstm_at:
                ok = ok and split(pre, ("w_in",), ("w_down",))
            else:
                ok = ok and split(pre, _ATTN_COLS, ("w_down",))
        plan["tp_ssm"] = ok
    return plan


def _placement(model: nn.Module, mesh: NMFMesh) -> Shards:
    """Where every parameter of ``model`` (whole, of any family, on any
    device, ``meta`` included) lies on ``mesh``."""
    cfg = model.cfg
    specs = param_pspecs(cfg, model, RULES, mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return Shards(mesh, specs, shapes,
                  **_tp_plan(cfg, specs, mesh.axis_size("model")))


def _keep(model: nn.Module, name: str, block: torch.Tensor,
          requires_grad: bool = True) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner), leaf,
            nn.Parameter(block, requires_grad=requires_grad))


def shard_model(model: nn.Module, mesh: NMFMesh) -> Shards:
    """Replace every parameter of ``model`` (whole, of any family) by this
    rank's block of it, in place, and return where the blocks lie.  Every
    rank must pass the same model."""
    shards = _placement(model, mesh)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            blk = p[block_index(mesh, shards.dims(name))].clone(
                memory_format=torch.contiguous_format)
            _keep(model, name, blk, p.requires_grad)
    return shards


def init_sharded(cfg: ArchConfig, mesh: NMFMesh, seed: int = 0,
                 device: DeviceLike = None,
                 model: Optional[nn.Module] = None
                 ) -> Tuple[nn.Module, Shards]:
    """``(model, shards)``: a model of ``cfg`` (any family) holding this
    rank's f32 blocks, drawn on ``device`` (the card unless the CPU or
    ``meta`` is asked for) from ``seed`` through the family's own draw
    sequence (``api.init_leaves``): each leaf drawn whole, its block kept,
    the leaf freed before the next is drawn.  The blocks are bitwise
    ``shard_model(api.init_params(cfg, seed))``'s; the peak is the rank's
    blocks and one whole leaf.  On ``meta`` nothing is drawn.  ``model``
    is the whole model on ``meta`` to fill (made here when None: a counter
    of live bytes given one made outside it does not count its meta
    storages)."""
    dev = resolve_device(device)
    if model is None:
        model = api.init_params(cfg, dtype=torch.float32, device="meta")
    shards = _placement(model, mesh)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    with torch.no_grad():
        for name, whole in api.init_leaves(cfg, gen):
            blk = whole[block_index(mesh, shards.dims(name))].clone(
                memory_format=torch.contiguous_format)
            del whole
            _keep(model, name, blk)
    return model, shards


# ---------------------------------------------------------------------------
# Whole leaves: checkpoints and checks
# ---------------------------------------------------------------------------

def gather_leaf(shards: Shards, name: str, block: torch.Tensor
                ) -> torch.Tensor:
    """The whole leaf ``name`` from this rank's ``block`` of it (a
    parameter, μ or ν), on every rank; collective."""
    t = block.detach()
    for d, total, axes in shards.dims(name):
        t = shards.mesh.gather(t, total, axes, d)
    return t


def gather_named(shards: Shards, blocks: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The whole leaf of every block in ``blocks`` (keyed by parameter
    name), on every rank; collective, in the order of ``blocks``."""
    return {name: gather_leaf(shards, name, t) for name, t in blocks.items()}


def gather_state(model: nn.Module, state: AdamState, shards: Shards):
    """On rank 0, ``(params, state)`` with whole leaves on the host: the
    parameters as a dict keyed by name, μ and ν likewise, for a checkpoint
    under a 1x1 run's names (saved with the model's family, which a dict
    does not carry: ``AsyncCheckpointer.save(..., family=)``); None on the
    other ranks.  Collective: every
    rank calls it, one leaf at a time (the leaf gathered on the device,
    copied to the host by rank 0 alone, and freed before the next one), so
    a rank's device holds at most one whole leaf beside its state and only
    rank 0's host holds the whole state."""
    keep = shards.mesh.rank == 0

    def host(blocks):
        out = {}
        for name, t in blocks.items():
            whole = gather_leaf(shards, name, t)
            if keep:
                out[name] = whole.cpu()
            del whole
        return out

    params = host(dict(model.named_parameters()))
    mu, nu = host(state.mu), host(state.nu)
    if not keep:
        return None
    return params, AdamState(state.step.detach().cpu(), mu, nu)


@torch.no_grad()
def restore_state(ckpt_dir: str, step: int, model: nn.Module,
                  state: AdamState, shards: Shards) -> None:
    """Read the checkpoint at ``step`` (written by a run on any grid, 1x1
    included: whole leaves in ``model``'s family's layout) one leaf at a
    time and keep this rank's blocks, in place in ``model`` and ``state``:
    a rank's host holds at most one whole leaf beside its state."""
    where = {}
    for blocks in (dict(model.named_parameters()), state.mu, state.nu):
        for n, t in blocks.items():
            where[id(t)] = (shards.shapes[n],
                            block_index(shards.mesh, shards.dims(n)))
    restore_checkpoint(ckpt_dir, step, (model, state),
                       block=lambda t: where.get(id(t), (tuple(t.shape), ())))


def state_bytes(model: nn.Module, state: AdamState) -> int:
    """This rank's bytes of parameters, μ and ν."""
    return sum(t.numel() * t.element_size()
               for ts in (dict(model.named_parameters()), state.mu, state.nu)
               for t in ts.values())


# ---------------------------------------------------------------------------
# The collectives under autograd
# ---------------------------------------------------------------------------

def _sum(mesh: NMFMesh, x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` summed over ``axes`` in f32 (partial products in the compute
    dtype would otherwise round once more), returned in its dtype."""
    if mesh.axis_size(axes) == 1:
        return x
    return mesh.all_reduce(x.float(), axes).to(x.dtype)


class _Use(torch.autograd.Function):
    """A parameter block cast to the compute dtype and gathered over the
    axes of ``dims``.  Backward: the gradient in the block's dtype, summed
    over ``sum_axes`` (the batch axes, and ``"model"`` for a leaf read on
    part of the tokens or channels) and cut to the block."""

    @staticmethod
    def forward(ctx, block, mesh, dims, sum_axes, dtype):
        ctx.mesh, ctx.dims, ctx.sum_axes = mesh, dims, sum_axes
        ctx.block_dtype = block.dtype
        x = block.detach().to(dtype, copy=True)
        for d, total, axes in dims:
            x = mesh.gather(x, total, axes, d)
        return x

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce(g.to(ctx.block_dtype), ctx.sum_axes)
        if ctx.dims:
            # a copy: a view would keep the whole gradient alive
            g = g[block_index(ctx.mesh, ctx.dims)].clone(
                memory_format=torch.contiguous_format)
        return g, None, None, None, None


class _ToModel(torch.autograd.Function):
    """Identity forward, sum over ``"model"`` backward: the input of a
    column-parallel block (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(ctx.mesh, g, "model"), None


class _FromModel(torch.autograd.Function):
    """Sum over ``"model"`` forward, identity backward: the output of a
    row-parallel block, and the vocabulary-parallel reductions
    (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(mesh, x, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumModel(torch.autograd.Function):
    """Sum over ``"model"`` forward and backward: a partial sum whose total
    each rank reads for its own part only (a norm over channels split by
    heads), so each rank's gradient of the total is a part too."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _sum(mesh, x, "model")

    @staticmethod
    def backward(ctx, g):
        return _sum(ctx.mesh, g, "model"), None


class _Gather(torch.autograd.Function):
    """This rank's block along ``dim`` gathered over ``axes``; backward the
    gradient's block, the only part of it this rank's gradient needs: the
    whole is read alike on every rank of ``axes`` (their gradients of it
    are the same), or token by token, each rank keeping its own."""

    @staticmethod
    def forward(ctx, x, mesh, total, axes, dim):
        ctx.index = (slice(None),) * dim + (mesh.block(total, axes),)
        return mesh.gather(x, total, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None, None, None


@dataclasses.dataclass(frozen=True)
class Step:
    """What one step's layers read: the placement, the batch axes the
    gradients are summed over (the batch is split over them), the compute
    dtype, the MoE capacity factor, and the attention path: the flash
    kernel (``flash``: the serving steps, ``serving/sharding.py``) or the
    differentiable plain path (the train step)."""

    cfg: ArchConfig
    shards: Shards
    sum_axes: Tuple[str, ...]
    dtype: torch.dtype
    capacity_factor: float = 1.25
    flash: bool = False

    @property
    def mesh(self) -> NMFMesh:
        return self.shards.mesh

    def use(self, x: torch.Tensor, name: str, keep_model: bool = False,
            sum_model: bool = False):
        """Block ``x`` of parameter ``name`` (or a function of it that acts
        elementwise) gathered in the compute dtype; ``sum_model`` sums its
        gradient over ``"model"`` too (a leaf read on a ``"model"`` rank's
        part of the tokens or channels)."""
        axes = self.sum_axes + ("model",) if sum_model else self.sum_axes
        return _Use.apply(x, self.mesh, self.shards.dims(name, keep_model),
                          axes, self.dtype)

    def leaf(self, module: nn.Module, prefix: str, leaf: str, **kw):
        return self.use(getattr(module, leaf), prefix + leaf, **kw)

    def to_model(self, x, split: bool):
        return _ToModel.apply(x, self.mesh) if split else x

    def from_model(self, x, split: bool):
        return _FromModel.apply(x, self.mesh) if split else x

    def model_slice(self, n: int) -> slice:
        return self.mesh.block(n, "model")

    def heads_cfg(self) -> ArchConfig:
        """The config of this rank's attention heads (all of them unless
        attention runs split)."""
        if not self.shards.tp_attn:
            return self.cfg
        m = self.mesh.axis_size("model")
        return dataclasses.replace(self.cfg, n_heads=self.cfg.n_heads // m,
                                   n_kv_heads=self.cfg.n_kv_heads // m,
                                   head_dim=self.cfg.hd)


def _run(remat: bool, fn: Callable, *args):
    """``fn(*args)``, recomputed in backward (gathers included) under
    ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def split_rmsnorm(step: Step, x: torch.Tensor, w: torch.Tensor,
                  n: int) -> torch.Tensor:
    """``rmsnorm`` over ``n`` channels of which ``x`` holds this rank's
    (``w`` cut alike): the sum of squares summed over ``"model"``."""
    x32 = x.float()
    ss = _SumModel.apply((x32 * x32).sum(-1, keepdim=True), step.mesh)
    return ((x32 * torch.rsqrt(ss / n + step.cfg.norm_eps))
            * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def attention_leaves(step: Step, attn: nn.Module, prefix: str
                     ) -> Dict[str, torch.Tensor]:
    """An attention block's leaves in the compute dtype: whole, or this
    rank's heads (its biases, replicated, cut to its heads behind the
    conjugate of their use) when attention runs split."""
    tp = step.shards.tp_attn
    a = {}
    for leaf, p in attn.named_parameters(recurse=False):
        w = step.use(p, prefix + leaf, keep_model=tp)
        if tp and w.dim() == 1:
            w = step.to_model(w, True)[step.model_slice(w.shape[0])]
        a[leaf] = w
    return a


def attention_block(step: Step, attn: nn.Module, prefix: str,
                    hn: torch.Tensor, positions, causal: bool = True,
                    memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """An attention block (``attn``, its leaves named ``prefix`` + leaf)
    on the normed input ``hn``, its output summed over ``"model"`` when it
    runs split: whole, or this rank's heads (its biases, replicated, cut to
    its heads behind the conjugate of their use).  ``memory`` is a
    cross-attention's encoder memory (already behind the conjugate)."""
    tp = step.shards.tp_attn
    a = attention_leaves(step, attn, prefix)
    acfg = step.heads_cfg()
    kv = None if memory is None else encdec._cross_kv(a, memory, acfg)
    out = attention(a, step.to_model(hn, tp), acfg, positions, causal=causal,
                    kv=kv, flash=step.flash)
    return step.from_model(out, tp)


def mlp_block(step: Step, block: nn.Module, prefix: str, hn: torch.Tensor
              ) -> torch.Tensor:
    tp = step.shards.tp_mlp
    w = {leaf: step.use(p, prefix + leaf, keep_model=tp)
         for leaf, p in block.named_parameters(recurse=False)}
    return step.from_model(mlp(w, step.to_model(hn, tp)), tp)


def dense_layer(x: torch.Tensor, layer: nn.Module, prefix: str, step: Step,
                positions: torch.Tensor, causal: bool = True
                ) -> torch.Tensor:
    """One dense layer (``transformer.layer_fwd``) on the grid: a decoder
    layer, an encoder layer (not causal), a hybrid's shared block."""
    eps = step.cfg.norm_eps
    hn = rmsnorm(x, step.leaf(layer, prefix, "norm_attn"), eps)
    h = x + attention_block(step, layer.attn, prefix + "attn.", hn,
                            positions, causal)
    hn = rmsnorm(h, step.leaf(layer, prefix, "norm_mlp"), eps)
    return h + mlp_block(step, layer.mlp, prefix + "mlp.", hn)


def whole_leaves(step: Step, block: nn.Module, prefix: str
                 ) -> Dict[str, torch.Tensor]:
    """Every leaf of ``block`` gathered whole in the compute dtype."""
    return {leaf: step.use(p, prefix + leaf)
            for leaf, p in block.named_parameters(recurse=False)}


def moe_block(step: Step, block: nn.Module, prefix: str, x: torch.Tensor
              ) -> torch.Tensor:
    """The MoE block (``moe.moe_ffn_ep``) on this rank's batch block ``x``
    (B_loc, S, d), the same on every ``"model"`` rank: expert-parallel
    where the reference's shape rules (``moe.ep_applies``) hold, else every
    token of the global (micro)batch as one group."""
    cfg, mesh = step.cfg, step.mesh
    b, s, d = x.shape
    m = mesh.axis_size("model")
    dp = mesh.axis_size(step.sum_axes)
    if step.shards.ep and moe.ep_applies(cfg, mesh.axis_size(BATCH_AXES), m,
                                         b * dp, s):
        xs = step.to_model(x, True)[:, step.model_slice(s)]
        router = step.leaf(block, prefix, "router", sum_model=True)
        buf, route = moe.ep_dispatch({"router": router}, xs, cfg, m,
                                     step.capacity_factor)
        recv = mesh.all_to_all(buf, "model")
        slab = {n: step.leaf(block, prefix, n, keep_model=True)
                for n in ("w_gate", "w_up", "w_down")}
        out = moe.ep_experts(slab, recv, m, route[3])
        y = moe.ep_combine(mesh.all_to_all(out, "model"), xs.shape,
                           route, cfg)
        return _Gather.apply(y, mesh, s, "model", 1)
    w = whole_leaves(step, block, prefix)
    if dp > 1:
        x = _Gather.apply(x, mesh, b * dp, step.sum_axes, 0)
    y = moe.moe_ffn(w, x.reshape(1, -1, d), cfg,
                    step.capacity_factor)[0].reshape(x.shape)
    return y[mesh.block(b * dp, step.sum_axes)] if dp > 1 else y


def moe_layer(x: torch.Tensor, layer: nn.Module, prefix: str, step: Step,
              positions: torch.Tensor) -> torch.Tensor:
    """One MoE layer (``moe.layer_fwd``) on the grid."""
    eps = step.cfg.norm_eps
    hn = rmsnorm(x, step.leaf(layer, prefix, "norm_attn"), eps)
    h = x + attention_block(step, layer.attn, prefix + "attn.", hn, positions)
    hn = rmsnorm(h, step.leaf(layer, prefix, "norm_mlp"), eps)
    return h + moe_block(step, layer.moe, prefix + "moe.", hn)


def mamba_layer(x: torch.Tensor, block: nn.Module, prefix: str, step: Step
                ) -> torch.Tensor:
    """One Mamba2 block (``mamba.mamba_block``) on the grid: whole, or this
    rank's SSM heads (see the module's docstring)."""
    cfg = step.cfg
    if not step.shards.tp_ssm:
        return mamba.mamba_block(whole_leaves(step, block, prefix), x, cfg)
    di, n = mamba.d_inner(cfg), cfg.ssm_state
    hp = cfg.ssm_head_dim
    hs = step.model_slice(mamba.n_ssm_heads(cfg))
    cs = slice(hs.start * hp, hs.stop * hp)
    ar = functools.partial(torch.arange, device=x.device)
    # this rank's columns of [z, x, B, C, dt] and channels of [x, B, C]
    cols = torch.cat([ar(cs.start, cs.stop), di + ar(cs.start, cs.stop),
                      2 * di + ar(2 * n),
                      2 * di + 2 * n + ar(hs.start, hs.stop)])
    chans = torch.cat([ar(cs.start, cs.stop), di + ar(2 * n)])

    def part(leaf, index):
        return step.leaf(block, prefix, leaf, sum_model=True)[index]

    p = {"in_proj": part("in_proj", (slice(None), cols)),
         "conv_w": part("conv_w", (slice(None), chans)),
         "A_log": part("A_log", hs), "D": part("D", hs),
         "dt_bias": part("dt_bias", hs), "gate_norm": part("gate_norm", cs),
         "out_proj": step.leaf(block, prefix, "out_proj", keep_model=True)}
    xn = rmsnorm(x, step.leaf(block, prefix, "norm_in"), cfg.norm_eps)
    out = mamba.mamba_mix(p, step.to_model(xn, True), cfg,
                          norm=functools.partial(split_rmsnorm, step, n=di))
    return x + step.from_model(out, True)


def mlstm_layer(x: torch.Tensor, block: nn.Module, prefix: str, step: Step
                ) -> torch.Tensor:
    """One mLSTM block (``xlstm.mlstm_parallel``) on the grid: whole, or
    this rank's heads (see the module's docstring)."""
    cfg = step.cfg
    if not step.shards.tp_ssm:
        return xlstm.mlstm_parallel(whole_leaves(step, block, prefix), x, cfg)
    up = 2 * cfg.d_model
    hd = up // cfg.n_heads
    hs = step.model_slice(cfg.n_heads)
    cs = slice(hs.start * hd, hs.stop * hd)
    p = {leaf: step.leaf(block, prefix, leaf)
         for leaf in ("norm", "w_up", "w_if", "b_i", "b_f")}
    xi, gate, i_log, f_log = xlstm._mlstm_in(p, x, cfg)
    w = {leaf: step.leaf(block, prefix, leaf, keep_model=True)
         for leaf in ("wq", "wk", "wv", "w_down")}
    y = xlstm.mlstm_heads(step.to_model(xi, True), w["wq"], w["wk"], w["wv"],
                          step.to_model(i_log, True)[..., hs],
                          step.to_model(f_log, True)[..., hs], hd)
    out_norm = step.leaf(block, prefix, "out_norm", sum_model=True)[cs]
    y = xlstm.block_out(y, out_norm, w["w_down"], functools.partial(
        split_rmsnorm, step, n=up), step.to_model(gate, True)[..., cs])
    return x + step.from_model(y, True)


def slstm_layer(x: torch.Tensor, block: nn.Module, prefix: str, step: Step,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One sLSTM block (``xlstm.slstm_seq``) on the grid from ``state`` (a
    fresh one if None; else the state of the heads this rank runs): whole,
    or this rank's heads (see the module's docstring).  Returns ``(x, the
    state after the last token)``."""
    cfg = step.cfg
    if not step.shards.tp_ssm:
        return xlstm.slstm_seq(whole_leaves(step, block, prefix), x, cfg,
                               state)
    hd = cfg.d_model // cfg.n_heads
    hs = step.model_slice(cfg.n_heads)
    cs = slice(hs.start * hd, hs.stop * hd)
    c4 = slice(4 * cs.start, 4 * cs.stop)
    xn = rmsnorm(x, step.leaf(block, prefix, "norm"), cfg.norm_eps)
    w_in = step.leaf(block, prefix, "w_in", keep_model=True)
    bias = step.leaf(block, prefix, "b", sum_model=True)[c4]
    pre = (step.to_model(xn, True) @ w_in + bias).float()
    r = step.leaf(block, prefix, "r", sum_model=True)[hs].float()
    ys, state = xlstm.slstm_heads(pre, r, state)
    out_norm = step.leaf(block, prefix, "out_norm", sum_model=True)[cs]
    w_down = step.leaf(block, prefix, "w_down", keep_model=True)
    y = xlstm.block_out(ys.to(x.dtype), out_norm, w_down, functools.partial(
        split_rmsnorm, step, n=cfg.d_model))
    return x + step.from_model(y, True), state


def _slstm_out(x: torch.Tensor, block: nn.Module, prefix: str, step: Step
               ) -> torch.Tensor:
    return slstm_layer(x, block, prefix, step)[0]


def dec_layer(x: torch.Tensor, memory: torch.Tensor, layer: nn.Module,
              prefix: str, step: Step, positions: torch.Tensor
              ) -> torch.Tensor:
    """One decoder layer (``encdec.dec_layer_fwd``) on the grid."""
    eps = step.cfg.norm_eps
    hn = rmsnorm(x, step.leaf(layer, prefix, "norm_self"), eps)
    h = x + attention_block(step, layer.self_attn, prefix + "self_attn.",
                            hn, positions)
    hn = rmsnorm(h, step.leaf(layer, prefix, "norm_cross"), eps)
    h = h + attention_block(step, layer.cross_attn, prefix + "cross_attn.",
                            hn, positions, causal=False, memory=memory)
    hn = rmsnorm(h, step.leaf(layer, prefix, "norm_mlp"), eps)
    return h + mlp_block(step, layer.mlp, prefix + "mlp.", hn)


# ---------------------------------------------------------------------------
# The embeddings and the vocabulary-parallel loss
# ---------------------------------------------------------------------------

def embed_tokens(step: Step, model: nn.Module, tokens: torch.Tensor):
    """The token embeddings in the compute dtype: a lookup in the whole
    table, or a masked lookup in this rank's rows of it, summed over
    ``"model"``."""
    tp = step.shards.tp_vocab
    table = step.use(model.embed, "embed", keep_model=tp)
    ids = tokens.long()
    if not tp:
        return table[ids]
    ids = ids - step.model_slice(step.cfg.vocab).start
    inside = (ids >= 0) & (ids < table.shape[0])
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    return step.from_model(rows.masked_fill(~inside[..., None], 0), True)


def unembed_matrix(step: Step, model: nn.Module) -> torch.Tensor:
    """(d, vocab) in the compute dtype, or (d, this rank's vocabulary)
    when the vocabulary is split: ``unembed``, or with tied embeddings
    ``embed.T * d_model**-0.5`` (``transformer.unembed_matrix``)."""
    tp = step.shards.tp_vocab
    if not step.cfg.tie_embeddings:
        return step.use(model.unembed, "unembed", keep_model=tp)
    scaled = model.embed * (step.cfg.d_model ** -0.5)
    return step.use(scaled, "embed", keep_model=tp).T


def _chunk_nll(xc: torch.Tensor, w: torch.Tensor, yc: torch.Tensor,
               mc: torch.Tensor, lo: int, step: Step) -> torch.Tensor:
    """Summed masked NLL of one sequence chunk against the logits of this
    rank's vocabulary ``[lo, lo + w.shape[1])`` (``common._chunk_nll``):
    ``max + log(sum(exp(logits - max)))`` minus the label's logit, the max
    and the two sums taken over every rank's part."""
    tp = step.shards.tp_vocab
    logits = (xc.to(step.dtype) @ w).float()                    # (B, c, V_loc)
    mx = logits.detach().amax(-1)
    if tp:
        mx = step.mesh.all_reduce(mx, "model", op="max")
    s = step.from_model(torch.exp(logits - mx[..., None]).sum(-1), tp)
    ids = yc.long() - lo
    inside = (ids >= 0) & (ids < logits.shape[-1])
    ll = torch.gather(logits, -1, ids.clamp(0, logits.shape[-1] - 1)[..., None]
                      )[..., 0].masked_fill(~inside, 0.0)
    ll = step.from_model(ll, tp)
    return torch.sum((mx + torch.log(s) - ll) * mc[None, :])


def _vocab_loss(step: Step, hidden: torch.Tensor, w: torch.Tensor,
                labels: torch.Tensor, count: int,
                n_chunks: int = 8) -> torch.Tensor:
    """``common.chunked_lm_loss`` over this rank's vocabulary, its sum
    divided by ``count`` (the global number of predicted positions)."""
    b, s, _ = hidden.shape
    tp = step.shards.tp_vocab
    # every rank's vocabulary adds to the hidden states' gradient
    hidden = step.to_model(hidden, tp)
    y = torch.roll(labels, -1, dims=1)
    valid = (torch.arange(s, device=hidden.device) < s - 1).float()
    while s % n_chunks:
        n_chunks -= 1
    c = s // n_chunks
    lo = step.model_slice(step.cfg.vocab).start if tp else 0
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        total = total + checkpoint(_chunk_nll, hidden[:, i:i + c], w,
                                   y[:, i:i + c], valid[i:i + c], lo, step,
                                   use_reentrant=False)
    return total / count


def seq_positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[0], x.shape[1]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def _final(step: Step, model: nn.Module, x: torch.Tensor, norm: str,
           labels: torch.Tensor, count: int) -> torch.Tensor:
    x = rmsnorm(x, step.use(getattr(model, norm), norm), step.cfg.norm_eps)
    x = x[:, x.shape[1] - labels.shape[1]:, :]
    return _vocab_loss(step, x, unembed_matrix(step, model), labels, count)


# ---------------------------------------------------------------------------
# Each family's loss
# ---------------------------------------------------------------------------

def lm_loss(model: nn.Module, batch: Dict[str, torch.Tensor], step: Step,
            count: int, remat: bool = True) -> torch.Tensor:
    """This rank's part of a dense, vlm or moe ``lm_loss`` on its block of
    the batch: its positions' summed cross-entropy divided by ``count``, on
    the plain attention path, each layer gathered (and under ``remat``
    recomputed, gathers included) in backward."""
    x = embed_tokens(step, model, batch["tokens"])
    if batch.get("patch_embeds") is not None:
        x = torch.cat([batch["patch_embeds"].to(step.dtype), x], dim=1)
    positions = seq_positions(x)
    body = moe_layer if step.cfg.family == "moe" else dense_layer
    for i, layer in enumerate(model.layers):
        x = _run(remat, body, x, layer, f"layers.{i}.", step, positions)
    return _final(step, model, x, "norm_f", batch["labels"], count)


def hybrid_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
                step: Step, count: int, remat: bool = True) -> torch.Tensor:
    """A hybrid's ``lm_loss``: each Mamba2 block and each use of the shared
    block under its own checkpoint, as ``hybrid.forward``."""
    x = embed_tokens(step, model, batch["tokens"])
    positions = seq_positions(x)
    for gi, grp in enumerate(model.groups):
        for ei, blk in enumerate(grp):
            x = _run(remat, mamba_layer, x, blk, f"groups.{gi}.{ei}.", step)
        x = _run(remat, dense_layer, x, model.shared, "shared.", step,
                 positions)
    for ti, blk in enumerate(model.tail):
        x = _run(remat, mamba_layer, x, blk, f"tail.{ti}.", step)
    return _final(step, model, x, "norm_f", batch["labels"], count)


def xlstm_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
               step: Step, count: int, remat: bool = True) -> torch.Tensor:
    """An xlstm's ``lm_loss`` (the reference's forward takes no remat; the
    values are the same with it)."""
    x = embed_tokens(step, model, batch["tokens"])
    for li, blk in enumerate(model.layers):
        body = _slstm_out if li in step.cfg.slstm_at else mlstm_layer
        x = _run(remat, body, x, blk, f"layers.{li}.", step)
    return _final(step, model, x, "norm_f", batch["labels"], count)


def seq2seq_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
                 step: Step, count: int, remat: bool = True
                 ) -> torch.Tensor:
    """``encdec.seq2seq_loss``: the encoder (dense layers, not causal) on
    the rank's frames, then the decoder on its tokens against the
    memory."""
    x = batch["frame_embeds"].to(step.dtype)
    positions = seq_positions(x)
    for i, layer in enumerate(model.enc_layers):
        x = _run(remat, dense_layer, x, layer, f"enc_layers.{i}.", step,
                 positions, False)
    memory = rmsnorm(x, step.use(model.norm_enc, "norm_enc"),
                     step.cfg.norm_eps)
    # every decoder layer's cross K / V reads it by heads
    memory = step.to_model(memory, step.shards.tp_attn)
    x = embed_tokens(step, model, batch["tokens"])
    positions = seq_positions(x)
    for i, layer in enumerate(model.dec_layers):
        x = _run(remat, dec_layer, x, memory, layer, f"dec_layers.{i}.",
                 step, positions)
    return _final(step, model, x, "norm_dec", batch["labels"], count)


_LOSSES = {"dense": lm_loss, "vlm": lm_loss, "moe": lm_loss,
           "hybrid": hybrid_loss, "ssm": xlstm_loss, "encdec": seq2seq_loss}


def make_train_step(cfg: ArchConfig, opt: AdamW, shards: Shards,
                    remat: bool = True, compute_dtype=torch.bfloat16,
                    microbatches: int = 1, capacity_factor: float = 1.25):
    """``train_step(model, opt_state, batch)`` -> ``(model, opt_state,
    loss)`` on the grid, for any family, ``model`` and ``opt_state``
    holding this rank's blocks (:func:`shard_model`), ``batch`` the whole
    global batch on every rank.  Each rank takes its block of the batch
    (its dim 0 over the axes of ``batch_axes_for``, as ``batch_pspecs``
    puts it), and the loss returned is the global batch's, on every rank.
    ``microbatches`` > 1 splits the rank's block into that many equal parts
    run one after the other (``api.make_train_step``'s accumulation: each
    part's loss is its sum over the global count, so the parts' gradients
    add up in an f32 buffer of the rank's blocks).  ``capacity_factor`` is
    the MoE blocks' (``moe.moe_ffn_ep``'s default)."""
    mesh = shards.mesh
    m = int(microbatches)
    if m < 1:
        raise ValueError(f"microbatches must be at least 1, got "
                         f"{microbatches}")
    loss_fn = _LOSSES[cfg.family]

    def train_step(model, opt_state, batch):
        b, s = batch["labels"].shape
        axes = batch_axes_for(b, mesh, BATCH_AXES)
        if axes:
            rows = mesh.block(b, axes)
            batch = {k: v[rows] for k, v in batch.items()}
        step = Step(cfg, shards, axes, compute_dtype, capacity_factor)
        named = dict(model.named_parameters())
        if m == 1:
            loss = loss_fn(model, batch, step, b * (s - 1), remat)
            grads = torch.autograd.grad(loss, list(named.values()))
            loss = loss.detach()
        else:
            n = batch["labels"].shape[0]
            if n % m:
                raise ValueError(f"a rank's batch of {n} does not split "
                                 f"into {m} microbatches")
            n //= m
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in named.values()]

            def micro_step(loss, i):
                micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                part = loss_fn(model, micro, step, b * (s - 1), remat)
                for acc, g in zip(grads, torch.autograd.grad(
                        part, list(named.values()))):
                    acc.add_(g.float())
                return loss + part.detach(), None

            loss, _ = scan(micro_step, torch.zeros(
                (), dtype=torch.float32, device=grads[0].device), range(m))
        loss = mesh.all_reduce(loss, axes)
        model, opt_state = opt.update(dict(zip(named, grads)), opt_state,
                                      model)
        return model, opt_state, loss

    return train_step
