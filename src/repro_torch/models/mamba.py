"""Mamba2 (SSD: state-space duality) blocks (port of
``repro.models.mamba``): the chunkwise-parallel form for the forward and
training, and the constant-memory recurrent form for decode.

Per head h with scalar decay A_h and state S in R^{headdim x d_state}:

    S_t = exp(A_h dt_t) S_{t-1} + dt_t x_t B_t^T          (outer product)
    y_t = S_t C_t + D_h x_t

The forward takes chunks of Q tokens: inside a chunk the quadratic,
attention-like form on (Q x Q) tiles, across chunks the (B, H, P, N) f32
state carried by a Python loop (the reference's ``lax.scan``), so only one
chunk's (B, H, Q, Q) decay tensor is live at a time.  Numerics are the
reference's: the decay, ``dt`` and the state in f32, ``x * dt`` in the
compute dtype.  ``dt``'s softplus is ``logaddexp(x, 0)``, as
``jax.nn.softplus`` computes it (``F.softplus`` returns x itself above its
threshold of 20).  Parameters are in the caller's compute dtype, as the
reference casts every leaf (``A_log``, ``D``, ``dt_bias`` included) before
the block runs.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.scan import scan
from repro_torch.models.common import (
    ArchConfig,
    dense_init,
    draw_device,
    rmsnorm,
)
from repro_torch.models.transformer import _Leaves

__all__ = ["CONV_K", "d_inner", "n_ssm_heads", "mamba_shapes",
           "mamba_leaves", "init_mamba_block", "MambaBlock", "softplus", "ssd_chunked",
           "causal_conv", "mamba_mix", "mamba_block", "init_mamba_state", "ssm_step",
           "mamba_decode"]

CONV_K = 4  # depthwise causal conv width

Weights = Dict[str, torch.Tensor]


def d_inner(cfg: ArchConfig) -> int:
    return 2 * cfg.d_model


def n_ssm_heads(cfg: ArchConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def mamba_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Leaf name -> shape of one Mamba block's parameters.  ``in_proj``
    emits [z (di), x (di), B (n), C (n), dt (heads)]."""
    di, n, hp = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg)
    return {"in_proj": (cfg.d_model, 2 * di + 2 * n + hp),
            "conv_w": (CONV_K, di + 2 * n), "A_log": (hp,), "D": (hp,),
            "dt_bias": (hp,), "norm_in": (cfg.d_model,),
            "gate_norm": (di,), "out_proj": (di, cfg.d_model)}


def mamba_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                 dtype=torch.float32, prefix: str = ""
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(prefix + name, value)`` of one block's parameters, made one at a
    time in draw order: the projections from :func:`dense_init`
    (``conv_w`` at scale 0.5), then ``A_log`` and ``dt_bias`` zero, ``D``
    and the norms one (no draw).  A None ``generator`` gives them on
    ``meta``."""
    shapes = mamba_shapes(cfg)
    for name, scale in (("in_proj", None), ("conv_w", 0.5),
                        ("out_proj", None)):
        yield prefix + name, dense_init(generator, shapes[name], dtype,
                                        scale=scale)
    for name, value in (("A_log", 0.0), ("D", 1.0), ("dt_bias", 0.0),
                        ("norm_in", 1.0), ("gate_norm", 1.0)):
        yield prefix + name, torch.full(shapes[name], value, dtype=dtype,
                                        device=draw_device(generator))


def init_mamba_block(generator: torch.Generator, cfg: ArchConfig,
                     dtype=torch.float32) -> Weights:
    """:func:`mamba_leaves` as a dict."""
    return dict(mamba_leaves(generator, cfg, dtype))


class MambaBlock(_Leaves):
    """One Mamba2 block's parameters under the reference's leaf names."""

    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__(mamba_shapes(cfg), dtype, device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) lower-triangular pairwise cumulative
    sums: ``out[i, j] = sum_{j < s <= i} a[s]`` for i >= j, -inf above the
    diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int
                ) -> torch.Tensor:
    """Chunkwise SSD.  x: (B, S, H, P), dt: (B, S, H), a_log: (H,) (decay
    ``-exp(a_log)``), b, c: (B, S, N) (one SSM group shared by the heads).
    Returns y (B, S, H, P) in x's dtype.  S must be a multiple of
    ``min(chunk, S)``, as the reference's reshape requires."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    nc = s // q
    if nc * q != s:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {q}")
    a = -torch.exp(a_log.float())                               # (H,)
    dt = softplus(dt.float())                                   # (B,S,H)
    adt = a * dt
    xdt = x * dt.to(x.dtype)[..., None]
    xc = xdt.reshape(bsz, nc, q, h, p)
    adtc = adt.reshape(bsz, nc, q, h).transpose(-1, -2)         # (B,NC,H,Q)
    bc = b.reshape(bsz, nc, q, n)
    cc = c.reshape(bsz, nc, q, n)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)

    def step(state, chunk):
        xk, adt_h, bk, ck = chunk
        xk = xk.float().permute(0, 2, 1, 3)                     # (B,H,Q,P)
        bk, ck = bk.float(), ck.float()                         # (B,Q,N)
        # intra-chunk: (C B^T) * L, times x
        l_mat = torch.exp(_segsum(adt_h))                       # (B,H,Q,Q)
        scores = ck @ bk.transpose(-1, -2)                      # (B,Q,Q)
        y_diag = (scores[:, None] * l_mat) @ xk                 # (B,H,Q,P)
        # inter-chunk, from the carried state
        a_cum = torch.cumsum(adt_h, dim=-1)                     # (B,H,Q)
        y_off = (ck[:, None] @ state.transpose(-1, -2)) \
            * torch.exp(a_cum)[..., None]                       # (B,H,Q,P)
        # the state carried out of this chunk
        decay_states = torch.exp(a_cum[..., -1:] - a_cum)       # (B,H,Q)
        st = (xk * decay_states[..., None]).transpose(-1, -2) @ bk[:, None]
        state = state * torch.exp(a_cum[..., -1])[..., None, None] + st
        return state, (y_diag + y_off).permute(0, 2, 1, 3)     # (B,Q,H,P)

    # unbind: one backward node for all the chunks
    _, ys = scan(step, state, zip(xc.unbind(1), adtc.unbind(1),
                                  bc.unbind(1), cc.unbind(1)), dim=1)
    return ys.reshape(bsz, s, h, p).to(x.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv then SiLU: x (B, S, D), w (K, D)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out)


def mamba_mix(p: Weights, xn: torch.Tensor, cfg: ArchConfig,
              chunk: int = 128, norm=None) -> torch.Tensor:
    """The block's mixer on the normed input xn (B, S, d_model): the SSM
    heads of ``p`` (as many as ``A_log`` holds; ``in_proj`` / ``conv_w``
    / ``gate_norm`` / ``out_proj`` hold their channels), projected back to
    d_model, no residual.  ``norm(y, w)`` is the gated norm (``rmsnorm``
    by default)."""
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    h = p["A_log"].shape[0]
    di = h * hp
    bsz, s, _ = xn.shape
    proj = xn @ p["in_proj"]
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    xbc = causal_conv(xbc, p["conv_w"])
    xin, b, c = torch.split(xbc, [di, n, n], dim=-1)
    xin = xin.reshape(bsz, s, h, hp)
    dt = dt + p["dt_bias"]
    y = ssd_chunked(xin, dt, p["A_log"], b, c, chunk)
    y = y + p["D"][None, None, :, None] * xin
    y = y.reshape(bsz, s, di) * F.silu(z)
    y = (rmsnorm(y, p["gate_norm"], cfg.norm_eps) if norm is None
         else norm(y, p["gate_norm"]))
    return y @ p["out_proj"]


def mamba_block(p: Weights, x: torch.Tensor, cfg: ArchConfig,
                chunk: int = 128) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model), residual included."""
    xn = rmsnorm(x, p["norm_in"], cfg.norm_eps)
    return x + mamba_mix(p, xn, cfg, chunk)


# ---------------------------------------------------------------------------
# Recurrent decode (one token, constant state)
# ---------------------------------------------------------------------------

def init_mamba_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    """The SSM state (B, H, P, N) in f32 and the conv window (B, K - 1,
    di + 2n) in ``dtype`` (f32 by default, whatever the KV cache's)."""
    di, n, h = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg)
    return {"ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_K - 1, di + 2 * n), dtype=dtype,
                                device=device)}


def ssm_step(p: Weights, xin: torch.Tensor, dt: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, ssm: torch.Tensor, dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the SSM heads of ``p`` (as many as ``A_log`` holds, with
    ``D`` and ``dt_bias``): ``xin`` (B, H, P) after the conv, ``dt`` (B, H)
    before its bias, ``b`` and ``c`` (B, N), the f32 state ``ssm`` (B, H, P,
    N).  Returns ``(y (B, H, P) in ``dtype``, D skip included; the new
    state)``.  Every head is independent (a rank of a grid runs its
    own)."""
    dt = softplus((dt + p["dt_bias"]).float())                  # (B,H)
    a = -torch.exp(p["A_log"].float())
    decay = torch.exp(a * dt)                                   # (B,H)
    xdt = (xin * dt[..., None].to(xin.dtype)).float()
    upd = xdt[..., None] * b.float()[:, None, None, :]          # (B,H,P,N)
    s_new = ssm * decay[..., None, None] + upd
    y = (s_new @ c.float()[:, None, :, None])[..., 0].to(dtype)
    return y + p["D"][None, :, None] * xin, s_new


def mamba_decode(p: Weights, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d_model); returns ``(y, new state)`` (new tensors: the
    caller writes them back)."""
    di, n, h = d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg)
    bsz = x.shape[0]
    xn = rmsnorm(x, p["norm_in"], cfg.norm_eps)
    proj = xn @ p["in_proj"]
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    # the conv over the rolling window
    win = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)   # (B,K,D)
    conv_out = F.silu(torch.einsum("bkd,kd->bd", win,
                                   p["conv_w"]))[:, None, :]
    new_conv = win[:, 1:, :].to(state["conv"].dtype)
    xin, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    xin = xin.reshape(bsz, h, cfg.ssm_head_dim)
    y, s_new = ssm_step(p, xin, dt[:, 0], b[:, 0], c[:, 0], state["ssm"],
                        x.dtype)
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return (x + y @ p["out_proj"]).to(x.dtype), {"ssm": s_new,
                                                 "conv": new_conv}
