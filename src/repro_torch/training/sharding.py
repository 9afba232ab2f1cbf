"""The LM train step with its parameters sharded over the ``data x model``
grid: FSDP over ``"data"`` and tensor parallelism over ``"model"``, placed
by the reference's ``param_pspecs`` (``models/api.py``) under the
reference launcher's rules :data:`RULES`.  This is the port of what GSPMD
does with those specs in ``repro.launch.train``, for the dense and vlm
families (``models/transformer.py``).

* **Storage.**  Each rank holds, of every leaf, exactly the block its spec
  gives it (``NMFMesh.block`` along each named dim), and AdamW's μ and ν
  have the same blocks, so a rank's parameter and moment bytes are the
  reference's per-device shard bytes.  AdamW runs unchanged on the blocks:
  it is elementwise and has no global norm.
* **FSDP.**  A layer's leaves are cast to the compute dtype and gathered
  over ``"data"`` just before the layer runs, and dropped after it; under
  remat the gather is issued again in the recompute.  A cast before the
  gather is the cast after it (a gather only moves values).
* **Tensor parallelism** (Megatron's split).  ``wq`` / ``wk`` / ``wv`` /
  ``w_gate`` / ``w_up`` are column-parallel (heads and d_ff split),
  ``wo`` / ``w_down`` row-parallel with one ``all_reduce`` over
  ``"model"`` in the forward; the conjugate pair (identity forward and
  ``all_reduce`` backward, and the reverse) is a ``torch.autograd.Function``
  over ``NMFMesh.all_reduce``.  The embedding is split by vocabulary: a
  masked lookup, then an ``all_reduce``.  The unembedding (tied or not)
  leaves the logits split by vocabulary, so the chunked loss is
  vocabulary-parallel: the row max and the sum of exponentials are reduced
  over ``"model"``, and the label's logit comes from the rank that holds
  it.  These are the places where the reference's ``constrain`` hints put
  ``"model"``.  A block whose split would cut inside a head (``model``
  not dividing the query or KV heads) keeps its sharded storage but is
  gathered over ``"model"`` too and computed whole, as is a block whose
  dims ``model`` does not divide (the specs then replicate it).
* **Gradients.**  A leaf's gradient is summed over the axes the batch is
  split over (``batch_axes_for``; none when the batch is replicated, as at
  a global batch of 2 on 4x1), then cut to the rank's block, in the
  backward of the gather.  The loss is each rank's sum divided by the
  global count, summed over the same axes.
* **Collectives.**  Every one is an ``NMFMesh.all_reduce`` (counted by
  ``collective_counts``): a gather is a zero-filled ``all_reduce``, a
  reduce-scatter an ``all_reduce`` cut to the block.  Under gloo a CUDA
  tensor takes no other collective, and gloo is how several ranks share
  one card; NCCL takes the same calls.  Partial products are summed in
  f32; gathers (sums with zeros, exact) move the compute dtype.

**Initialisation.**  :func:`init_sharded` draws the model leaf by leaf
on the rank's device from ``transformer.init_leaves``, the sequence
``transformer.init_params`` fills a whole model from, keeps the rank's
block of each leaf and frees the leaf before the next is drawn: no rank
ever holds the whole model, and the blocks are bitwise
``shard_model(api.init_params(cfg, seed))``'s.

Checkpoints hold whole leaves (:func:`gather_state`, gathered one leaf at
a time and kept on the host by rank 0 only, written by rank 0 under a 1x1
run's names), and a restore keeps the rank's block
(:func:`restore_state`), so any grid shape resumes any other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.scan import scan
from repro_torch.launch.mesh import NMFMesh
from repro_torch.models import api, transformer
from repro_torch.models.api import batch_axes_for, param_pspecs
from repro_torch.models.common import ArchConfig, attention, mlp, rmsnorm
from repro_torch.training.optimizer import AdamState, AdamW

__all__ = ["RULES", "FAMILIES", "Shards", "shard_model", "init_sharded",
           "gather_leaf", "gather_named", "gather_state", "restore_state",
           "state_bytes", "make_train_step"]

#: the reference launcher's rules (``repro.launch.train``)
RULES = {"fsdp": "data", "tp": "model", "ep": "model"}
#: the families whose layers this step shards
FAMILIES = ("dense", "vlm")
#: the axes a batch may be split over, in order
BATCH_AXES = ("pod", "data")

_ATTN_COLS, _ATTN_ROWS = ("wq", "wk", "wv"), ("wo",)
_MLP_COLS, _MLP_ROWS = ("w_gate", "w_up"), ("w_down",)


@dataclasses.dataclass(frozen=True)
class Shards:
    """Where every parameter of a sharded model lies: its spec over its
    own dims and its whole shape, keyed by its ``named_parameters`` name,
    on ``mesh``; and which blocks run tensor-parallel over ``"model"``."""

    mesh: NMFMesh
    specs: Dict[str, tuple]
    shapes: Dict[str, Tuple[int, ...]]
    tp_attn: bool
    tp_mlp: bool
    tp_vocab: bool

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


def _tp_plan(cfg: ArchConfig, specs, m: int) -> Tuple[bool, bool, bool]:
    """(attention, MLP, vocabulary) run split over ``"model"``: each when
    ``model`` > 1 and the specs split every leaf of the block along it (the
    heads of attention only if ``model`` divides both head counts)."""
    if m == 1:
        return False, False, False
    layer = "layers.0."

    def split(names, dim):
        return all(specs[layer + n][dim] == "model" for n in names)

    attn = (cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
            and split(("attn." + n for n in _ATTN_COLS), 1)
            and split(("attn." + n for n in _ATTN_ROWS), 0))
    ffn = (split(("mlp." + n for n in _MLP_COLS), 1)
           and split(("mlp." + n for n in _MLP_ROWS), 0))
    vocab = specs["embed"][0] == "model" and (
        cfg.tie_embeddings or specs["unembed"][1] == "model")
    return attn, ffn, vocab


def _placement(model: nn.Module, mesh: NMFMesh) -> Shards:
    """Where every parameter of ``model`` (a dense or vlm ``Transformer``,
    whole, on any device, ``meta`` included) lies on ``mesh``."""
    cfg = model.cfg
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"sharding the {cfg.family!r} family ({cfg.name}) over the grid "
            "is not ported (ROADMAP queue 1, the item \"sharding moe, "
            "hybrid, ssm and encdec\")")
    specs = param_pspecs(cfg, model, RULES, mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return Shards(mesh, specs, shapes,
                  *_tp_plan(cfg, specs, mesh.axis_size("model")))


def _keep(model: nn.Module, name: str, block: torch.Tensor,
          requires_grad: bool = True) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner), leaf,
            nn.Parameter(block, requires_grad=requires_grad))


def shard_model(model: nn.Module, mesh: NMFMesh) -> Shards:
    """Replace every parameter of ``model`` (a dense or vlm
    ``Transformer``, whole) by this rank's block of it, in place, and
    return where the blocks lie.  Every rank must pass the same model."""
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
    """``(model, shards)``: a dense or vlm model of ``cfg`` holding this
    rank's f32 blocks, drawn on ``device`` (the card unless the CPU or
    ``meta`` is asked for) from ``seed`` through the model's own draw
    sequence (``transformer.init_leaves``): each leaf drawn whole, its
    block kept, the leaf freed before the next is drawn.  The blocks are
    bitwise ``shard_model(api.init_params(cfg, seed))``'s; the peak is the
    rank's blocks and one whole leaf.  On ``meta`` nothing is drawn.
    ``model`` is the whole model on ``meta`` to fill (made here when None:
    a counter of live bytes given one made outside it does not count its
    meta storages)."""
    dev = resolve_device(device)
    if model is None:
        model = api.init_params(cfg, dtype=torch.float32, device="meta")
    shards = _placement(model, mesh)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    with torch.no_grad():
        for name, whole in transformer.init_leaves(gen, cfg):
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
    under a 1x1 run's names; None on the other ranks.  Collective: every
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
    """Read the whole leaves of the checkpoint at ``step`` (written by a
    run on any grid, 1x1 included) and keep this rank's blocks, in place
    in ``model`` and ``state``."""
    named = dict(model.named_parameters())

    def like(dtypes):
        return {n: torch.empty(shards.shapes[n], dtype=dtypes[n])
                for n in named}

    params = like({n: p.dtype for n, p in named.items()})
    whole = AdamState(torch.zeros((), dtype=state.step.dtype),
                      like({n: t.dtype for n, t in state.mu.items()}),
                      like({n: t.dtype for n, t in state.nu.items()}))
    restore_checkpoint(ckpt_dir, step, (params, whole))
    state.step.copy_(whole.step)
    for src, dst in ((params, named), (whole.mu, state.mu),
                     (whole.nu, state.nu)):
        for n, t in dst.items():
            t.copy_(src[n][block_index(shards.mesh, shards.dims(n))])


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
    over the batch axes ``sum_axes`` and cut to the block."""

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


@dataclasses.dataclass(frozen=True)
class _Step:
    """What one step's layers read: the placement, the batch axes the
    gradients are summed over, the compute dtype."""

    cfg: ArchConfig
    shards: Shards
    sum_axes: Tuple[str, ...]
    dtype: torch.dtype

    @property
    def mesh(self) -> NMFMesh:
        return self.shards.mesh

    def use(self, x: torch.Tensor, name: str, keep_model: bool = False):
        """Block ``x`` of parameter ``name`` (or a function of it that acts
        elementwise) gathered in the compute dtype."""
        return _Use.apply(x, self.mesh, self.shards.dims(name, keep_model),
                          self.sum_axes, self.dtype)

    def to_model(self, x, split: bool):
        return _ToModel.apply(x, self.mesh) if split else x

    def from_model(self, x, split: bool):
        return _FromModel.apply(x, self.mesh) if split else x

    def model_slice(self, n: int) -> slice:
        return self.mesh.block(n, "model")


def _attention_weights(step: _Step, layer: nn.Module, prefix: str):
    """The attention block's weights in the compute dtype: whole, or this
    rank's heads when it runs split (its biases, replicated, cut to its
    heads behind the conjugate of their use)."""
    tp = step.shards.tp_attn
    out = {}
    for leaf, p in layer.attn.named_parameters(recurse=False):
        name = prefix + "attn." + leaf
        w = step.use(p, name, keep_model=tp)
        if tp and w.dim() == 1:
            w = step.to_model(w, True)[step.model_slice(w.shape[0])]
        out[leaf] = w
    return out


def _layer(x: torch.Tensor, layer: nn.Module, index: int, step: _Step,
           positions: torch.Tensor) -> torch.Tensor:
    """One decoder layer (``transformer.layer_fwd``) on the grid."""
    cfg, prefix = step.cfg, f"layers.{index}."
    tp_attn, tp_mlp = step.shards.tp_attn, step.shards.tp_mlp
    a = _attention_weights(step, layer, prefix)
    acfg = cfg
    if tp_attn:
        m = step.mesh.axis_size("model")
        acfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // m,
                                   n_kv_heads=cfg.n_kv_heads // m,
                                   head_dim=cfg.hd)
    hn = rmsnorm(x, step.use(layer.norm_attn, prefix + "norm_attn"),
                 cfg.norm_eps)
    out = attention(a, step.to_model(hn, tp_attn), acfg, positions,
                    flash=False)
    h = x + step.from_model(out, tp_attn)
    w = {leaf: step.use(p, prefix + "mlp." + leaf, keep_model=tp_mlp)
         for leaf, p in layer.mlp.named_parameters(recurse=False)}
    hn = rmsnorm(h, step.use(layer.norm_mlp, prefix + "norm_mlp"),
                 cfg.norm_eps)
    return h + step.from_model(mlp(w, step.to_model(hn, tp_mlp)), tp_mlp)


def _embed(step: _Step, model: nn.Module, tokens: torch.Tensor):
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


def _unembed(step: _Step, model: nn.Module) -> torch.Tensor:
    """(d, vocab) in the compute dtype, or (d, this rank's vocabulary)
    when the vocabulary is split: ``unembed``, or with tied embeddings
    ``embed.T * d_model**-0.5`` (``transformer.unembed_matrix``)."""
    tp = step.shards.tp_vocab
    if not step.cfg.tie_embeddings:
        return step.use(model.unembed, "unembed", keep_model=tp)
    scaled = model.embed * (step.cfg.d_model ** -0.5)
    return step.use(scaled, "embed", keep_model=tp).T


def _chunk_nll(xc: torch.Tensor, w: torch.Tensor, yc: torch.Tensor,
               mc: torch.Tensor, lo: int, step: _Step) -> torch.Tensor:
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


def _vocab_loss(step: _Step, hidden: torch.Tensor, w: torch.Tensor,
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


def lm_loss(model: nn.Module, batch: Dict[str, torch.Tensor], step: _Step,
            count: int, remat: bool = True) -> torch.Tensor:
    """This rank's part of ``transformer.lm_loss`` on its block of the
    batch: its positions' summed cross-entropy divided by ``count``, on the
    plain attention path, each layer gathered (and under ``remat``
    recomputed, gathers included) in backward."""
    cfg = step.cfg
    x = _embed(step, model, batch["tokens"])
    if batch.get("patch_embeds") is not None:
        x = torch.cat([batch["patch_embeds"].to(step.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    for i, layer in enumerate(model.layers):
        if remat:
            x = checkpoint(_layer, x, layer, i, step, positions,
                           use_reentrant=False)
        else:
            x = _layer(x, layer, i, step, positions)
    x = rmsnorm(x, step.use(model.norm_f, "norm_f"), cfg.norm_eps)
    x = x[:, s - batch["tokens"].shape[1]:, :]
    return _vocab_loss(step, x, _unembed(step, model), batch["labels"],
                       count)


def make_train_step(cfg: ArchConfig, opt: AdamW, shards: Shards,
                    remat: bool = True, compute_dtype=torch.bfloat16,
                    microbatches: int = 1):
    """``train_step(model, opt_state, batch)`` -> ``(model, opt_state,
    loss)`` on the grid, ``model`` and ``opt_state`` holding this rank's
    blocks (:func:`shard_model`), ``batch`` the whole global batch on every
    rank.  Each rank takes its block of the batch (its dim 0 over the
    axes of ``batch_axes_for``, as ``batch_pspecs`` puts it), and the loss
    returned is the global batch's, on every rank.  ``microbatches`` > 1
    splits the rank's block into that many equal parts run one after the
    other (``api.make_train_step``'s accumulation: each part's loss is its
    sum over the global count, so the parts' gradients add up in an f32
    buffer of the rank's blocks)."""
    mesh = shards.mesh
    m = int(microbatches)
    if m < 1:
        raise ValueError(f"microbatches must be at least 1, got "
                         f"{microbatches}")

    def train_step(model, opt_state, batch):
        b, s = batch["labels"].shape
        axes = batch_axes_for(b, mesh, BATCH_AXES)
        if axes:
            rows = mesh.block(b, axes)
            batch = {k: v[rows] for k, v in batch.items()}
        step = _Step(cfg, shards, axes, compute_dtype)
        named = dict(model.named_parameters())
        if m == 1:
            loss = lm_loss(model, batch, step, b * (s - 1), remat)
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
                part = lm_loss(model, micro, step, b * (s - 1), remat)
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
