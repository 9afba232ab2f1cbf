"""Shared building blocks of the LM substrate (port of
``repro.models.common``).

Functional style, as in the reference: each apply function takes a mapping
of parameter tensors (``p["wq"]`` …), already cast to the compute dtype by
the caller.  The modules of ``models/transformer.py`` hold the parameters
and call these.  Weights keep the reference's ``(in, out)`` orientation, so
``x @ p["wq"]`` is the reference's product.

Full-sequence attention takes one of two paths, named by the caller
(``flash``) and never chosen from what the operands need:

* the flash kernel's wrapper (``kernels/flash_attention.py``): a kernel
  launch on CUDA tensors, the plain version on CPU tensors.  It has no
  backward, as the reference's Pallas kernel has none, and refuses operands
  that need a gradient.  The serving steps take it (``flash=True``, the
  default);
* the reference's differentiable path (its ``USE_FLASH_KERNEL = False``
  default, the one it trains with): GQA scores, the causal mask at
  ``finfo.min``, softmax in f32; above ``_ATTN_CHUNK_THRESHOLD`` live
  scores, query blocks of ``_Q_CHUNK`` rows, each recomputed in backward
  (``torch.utils.checkpoint``), so no (S, T) score matrix is kept for
  backward.  The loss and the train step take it (``flash=False``).

``chunked_lm_loss`` is the reference's vocabulary-chunked cross-entropy,
each chunk's logits recomputed in backward.  ``logical_to_mesh`` maps logical axis names to
mesh axes.  ``constrain`` (a sharding hint to GSPMD) has no function here:
the sharded train step (``training/sharding.py``) places every tensor
itself, and the places where the reference constrains (the heads after
the projections, the scores, the chunked loss's logits, the MoE buffer)
are its tensor-parallel split points.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.scan import scan

__all__ = ["ArchConfig", "draw_device", "dense_init", "attention_shapes",
           "mlp_shapes", "attention_leaves", "init_attention", "mlp_leaves",
           "init_mlp", "rmsnorm", "rope_freqs", "apply_rope",
           "swiglu", "attention", "attention_decode", "mlp",
           "chunked_lm_loss", "logical_to_mesh"]

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # defaults to d_model // n_heads
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0          # hybrid: shared attn block period
    # enc-dec
    n_enc_layers: int = 0        # encdec family: encoder depth (n_layers = decoder)
    dec_ratio: int = 8           # encdec: dec_len = seq // dec_ratio
    # frontend stub
    frontend: Optional[str] = None      # None | "audio" | "vision"
    n_patches: int = 1024        # vlm: image patch embeddings prepended
    # misc
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # xLSTM
    slstm_at: Tuple[int, ...] = ()
    # shapes that need sub-quadratic support
    supports_long: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def draw_device(generator: Optional[torch.Generator]) -> torch.device:
    """Where a draw from ``generator`` lands: its device, or ``meta`` (no
    draw at all) for None."""
    return torch.device("meta") if generator is None else generator.device


def dense_init(generator: Optional[torch.Generator], shape,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal(0, 1) * scale (default ``fan_in ** -0.5``), drawn from
    ``generator`` on its device and scaled in place (one tensor of
    ``shape`` live); ``meta`` for a None generator."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    x = torch.randn(tuple(shape), generator=generator,
                    device=draw_device(generator))
    return x.mul_(s).to(dtype)


def attention_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Leaf name -> shape of one attention block's parameters."""
    shapes = {"wq": (cfg.d_model, cfg.q_dim), "wk": (cfg.d_model, cfg.kv_dim),
              "wv": (cfg.d_model, cfg.kv_dim), "wo": (cfg.q_dim, cfg.d_model)}
    if cfg.qkv_bias:
        shapes.update(bq=(cfg.q_dim,), bk=(cfg.kv_dim,), bv=(cfg.kv_dim,))
    return shapes


def mlp_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Leaf name -> shape of one SwiGLU block's parameters."""
    return {"w_gate": (cfg.d_model, cfg.d_ff), "w_up": (cfg.d_model, cfg.d_ff),
            "w_down": (cfg.d_ff, cfg.d_model)}


def attention_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                     dtype=torch.float32, prefix: str = ""
                     ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(prefix + name, value)`` of one attention block's parameters, made
    one at a time in draw order: projections from :func:`dense_init`,
    biases (``qkv_bias``) zero."""
    for name, shape in attention_shapes(cfg).items():
        yield prefix + name, (
            dense_init(generator, shape, dtype) if len(shape) == 2
            else torch.zeros(shape, dtype=dtype,
                             device=draw_device(generator)))


def init_attention(generator: torch.Generator, cfg: ArchConfig,
                   dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Projections from :func:`dense_init`, biases (``qkv_bias``) zero."""
    return dict(attention_leaves(generator, cfg, dtype))


def mlp_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
               dtype=torch.float32, prefix: str = ""
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(prefix + name, value)`` of one SwiGLU block's parameters from
    :func:`dense_init`, drawn one at a time."""
    for name, shape in mlp_shapes(cfg).items():
        yield prefix + name, dense_init(generator, shape, dtype)


def init_mlp(generator: torch.Generator, cfg: ArchConfig,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return dict(mlp_leaves(generator, cfg, dtype))


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S).  Rotates the two halves of
    the head (split and concatenate, not interleaved pairs), in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs      # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


# ---------------------------------------------------------------------------
# Attention (GQA + RoPE), full-sequence and single-token-decode forms
# ---------------------------------------------------------------------------

def _qkv(p: Params, x: torch.Tensor, cfg: ArchConfig):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[0], x.shape[1]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def _expand_kv(k: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B,T,Hkv,hd) -> (B,T,H,hd): each KV head repeated over its query
    group (query head h reads KV head h // groups).  A broadcast, so its
    backward is a sum over the group (no scatter)."""
    groups = cfg.n_heads // cfg.n_kv_heads
    if groups == 1:
        return k
    b, t, hkv, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, hkv, groups, hd).reshape(
        b, t, hkv * groups, hd)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, cfg: ArchConfig
                ) -> torch.Tensor:
    """q: (B,S,H,hd) k: (B,T,Hkv,hd) -> scores (B,H,S,T) in q's dtype,
    divided by ``sqrt(hd)`` rounded to that dtype (a host number, so no
    copy to the card)."""
    hd = q.shape[-1]
    kf = _expand_kv(k, cfg)
    root = float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype))
    return torch.einsum("bshd,bthd->bhst", q, kf) / root


#: live-score budget above which the plain path runs in query blocks
_ATTN_CHUNK_THRESHOLD = 2048 * 2048
_Q_CHUNK = 512


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: ArchConfig, causal: bool, q_offset: int) -> torch.Tensor:
    """q: (B,Sq,H,hd); k, v: (B,T,Hkv,hd) -> (B,Sq,H,hd), the reference's
    numerics: scores in q's dtype, masked to ``finfo.min`` where key >
    ``q_offset`` + row, softmax in f32, probabilities cast back."""
    scores = _gqa_scores(q, k, cfg)                            # (B,H,Sq,T)
    sq, t = scores.shape[-2], scores.shape[-1]
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    # the f32 softmax casts its input itself (no f32 copy of the scores)
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, _expand_kv(v, cfg))


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: ArchConfig, causal: bool) -> torch.Tensor:
    """The reference's XLA path: whole when S * T is at most
    ``_ATTN_CHUNK_THRESHOLD``, else (S a multiple of ``_Q_CHUNK``) one
    query block at a time, each recomputed in backward."""
    S, T = q.shape[1], k.shape[1]
    if not (S * T > _ATTN_CHUNK_THRESHOLD and S % _Q_CHUNK == 0):
        return _attend(q, k, v, cfg, causal, 0)

    def block(_, i):
        return None, checkpoint(_attend, q[:, i:i + _Q_CHUNK], k, v, cfg,
                                causal, i, use_reentrant=False)

    _, out = scan(block, None, range(0, S, _Q_CHUNK), dim=1)
    return out.reshape(q.shape)


def attention(p: Params, x: torch.Tensor, cfg: ArchConfig,
              positions: Optional[torch.Tensor], causal: bool = True,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              flash: bool = True) -> torch.Tensor:
    """Full-sequence attention: through the flash kernel's wrapper
    (``flash``, no backward), or the differentiable plain path.  ``kv`` is
    a cross-attention memory (no rope, not causal; ``positions`` is not
    read)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if kv is not None:
        k, v = kv
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    causal = causal and kv is None
    if flash:
        groups = cfg.n_heads // cfg.n_kv_heads
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              groups=groups).transpose(1, 2)
    else:
        out = _plain_attention(q, k, v, cfg, causal)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"]


def attention_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token per row of x (B, 1, d) at position ``pos`` against the
    (B, T, Hkv, hd) cache, in the reference's numerics: scores in the
    compute dtype, the ``finfo.min`` mask over ``arange(T) <= pos``, softmax
    in f32, probabilities cast back.  Writes row ``pos`` of the cache in
    place (the reference returns updated copies) and returns the cache
    tensors themselves."""
    B = x.shape[0]
    T = cache_k.shape[1]
    q, k, v = _qkv(p, x, cfg)
    positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    row = min(max(int(pos), 0), T - 1)   # dynamic_update_slice clamps
    cache_k[:, row] = k[:, 0].to(cache_k.dtype)
    cache_v[:, row] = v[:, 0].to(cache_v.dtype)
    scores = _gqa_scores(q, cache_k.to(x.dtype), cfg)           # (B,H,1,T)
    valid = torch.arange(T, device=x.device) <= int(pos)
    scores = scores.masked_fill(~valid, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    vf = _expand_kv(cache_v.to(x.dtype), cfg)
    out = torch.einsum("bhst,bthd->bshd", probs, vf)
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"]
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# Dense FFN block
# ---------------------------------------------------------------------------

def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# ---------------------------------------------------------------------------
# Chunked vocab loss
# ---------------------------------------------------------------------------

def _chunk_nll(xc: torch.Tensor, w: torch.Tensor, yc: torch.Tensor,
               mc: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Summed masked NLL of one sequence chunk: logits (B, c, V) in f32
    from the product in ``compute_dtype``, ``logsumexp`` minus the label's
    logit."""
    logits = (xc.to(compute_dtype) @ w).float()
    lse = torch.logsumexp(logits, dim=-1)                       # (B, c)
    ll = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    return torch.sum((lse - ll) * mc[None, :])


def chunked_lm_loss(hidden: torch.Tensor, unembed: torch.Tensor,
                    labels: torch.Tensor, n_chunks: int = 8,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Cross-entropy of hidden (B, S, d) against ``labels`` (B, S) through
    ``unembed`` (d, V), without (B, S, V) logits.  Position t predicts
    label t + 1 (labels rolled left, the last position masked); the
    unembedding is cast to ``compute_dtype`` once; ``n_chunks`` falls
    until it divides S, and each chunk's logits are made, reduced and
    recomputed in backward, so at most one chunk's (B, S / n_chunks, V)
    logits live at a time.  Returns the f32 sum over chunks
    divided by ``B * (S - 1)``.  The label's logit is a ``gather`` where
    the reference contracts a one-hot: the same value exactly."""
    b, s, _ = hidden.shape
    y = torch.roll(labels, -1, dims=1)
    valid = (torch.arange(s, device=hidden.device) < s - 1).float()
    while s % n_chunks:
        n_chunks -= 1
    c = s // n_chunks
    w = unembed.to(compute_dtype)

    def chunk(total, i):
        return total + checkpoint(_chunk_nll, hidden[:, i:i + c], w,
                                  y[:, i:i + c], valid[i:i + c],
                                  compute_dtype, use_reentrant=False), None

    total, _ = scan(chunk, torch.zeros((), dtype=torch.float32,
                                       device=hidden.device), range(0, s, c))
    return total / (b * (s - 1))


def logical_to_mesh(spec_tree: Any, rules: Mapping[str, Any]) -> Any:
    """Map the logical axis names of every spec in ``spec_tree`` (a tuple
    of names or None, in dicts and lists) to mesh axes by ``rules``; a
    name ``rules`` lacks (and None) maps to None."""
    if isinstance(spec_tree, tuple) and all(
            isinstance(e, (str, type(None))) for e in spec_tree):
        return tuple(rules.get(ax) for ax in spec_tree)
    if isinstance(spec_tree, Mapping):
        return {k: logical_to_mesh(v, rules) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(logical_to_mesh(v, rules) for v in spec_tree)
    return spec_tree
