"""xLSTM (port of ``repro.models.xlstm``): mLSTM blocks (matrix memory,
parallel in training) and sLSTM blocks (scalar memory with a true
hidden-to-hidden recurrence).

The mLSTM forward is the stabilized chunkwise form: quadratic inside
chunks of Q tokens (the largest Q at most ``chunk`` that divides S), the
(B, H, hd, hd) matrix memory, its normaliser and its max state carried
across chunks by a Python loop (the reference's ``lax.scan``); decode is
the O(1)-state recurrent form, which is what qualifies xlstm for
``long_500k``.  The sLSTM runs a Python loop over time with the
block-diagonal per-head recurrence (the reference's ``lax.scan``), taking
and returning its state, so one step of it is its decode.  The mLSTM head
is ``2 d / h`` wide, the sLSTM head ``d / h``: neither reads
``cfg.head_dim``.  The max states start at -1e30, masked decays are
-inf, as the reference's.

:class:`XLSTM` holds ``embed``, ``layers`` (an ``nn.ModuleList`` of
:class:`MLSTMBlock` and, at ``cfg.slstm_at``, :class:`SLSTMBlock`),
``norm_f`` and ``unembed``.  The reference keeps its layers as a Python
list of unlike dicts, not stacked.  Every layer runs in the compute dtype
(the reference casts each f32 leaf); the recurrences and states are f32.
The reference's forward takes ``remat`` and ignores it; so does the port's.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.scan import scan
from repro_torch.models.common import (
    ArchConfig,
    chunked_lm_loss,
    dense_init,
    draw_device,
    rmsnorm,
)
from repro_torch.models.transformer import _Leaves, cached_cast, fill

__all__ = ["MLSTM_CHUNK", "mlstm_shapes", "mlstm_leaves", "init_mlstm",
           "block_out", "mlstm_heads", "mlstm_parallel", "init_mlstm_state",
           "mlstm_decode_heads", "mlstm_decode",
           "slstm_shapes", "slstm_leaves", "init_slstm", "slstm_heads",
           "slstm_seq",
           "init_slstm_state", "MLSTMBlock", "SLSTMBlock", "XLSTM",
           "init_leaves", "init_params", "forward", "lm_loss", "init_state",
           "decode_step"]

Weights = Dict[str, torch.Tensor]
MLSTM_CHUNK = 256
_NEG = -1e30   # the max states' start


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, h = cfg.d_model, cfg.n_heads
    up = 2 * d   # projection factor 2 as in xLSTM
    return {"norm": (d,), "w_up": (d, 2 * up), "wq": (up, up),
            "wk": (up, up), "wv": (up, up), "w_if": (up, 2 * h),
            "b_i": (h,), "b_f": (h,), "out_norm": (up,), "w_down": (up, d)}


def _leaves(generator: Optional[torch.Generator], shapes, drawn, constant,
            dtype, prefix: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(prefix + name, value)``: ``drawn`` (name, scale) from
    :func:`dense_init` in order, then ``constant`` (name, value) filled
    (no draw); on ``meta`` for a None ``generator``."""
    for name, scale in drawn:
        yield prefix + name, dense_init(generator, shapes[name], dtype,
                                        scale=scale)
    for name, value in constant:
        yield prefix + name, torch.full(shapes[name], value, dtype=dtype,
                                        device=draw_device(generator))


def mlstm_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                 dtype=torch.float32, prefix: str = ""
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """One mLSTM block's parameters one at a time in draw order:
    projections from :func:`dense_init` (``w_if`` at scale 0.01), then the
    norms one, ``b_i`` zero, ``b_f`` 3 (a forget gate near 1)."""
    return _leaves(generator, mlstm_shapes(cfg),
                   (("w_up", None), ("wq", None), ("wk", None),
                    ("wv", None), ("w_if", 0.01), ("w_down", None)),
                   (("norm", 1.0), ("b_i", 0.0), ("b_f", 3.0),
                    ("out_norm", 1.0)), dtype, prefix)


def init_mlstm(generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32) -> Weights:
    """:func:`mlstm_leaves` as a dict."""
    return dict(mlstm_leaves(generator, cfg, dtype))


def _mlstm_in(p: Weights, x: torch.Tensor, cfg: ArchConfig):
    """``(xi, gate, i_log, f_log)``: the up-projection's two halves and the
    f32 input and (log-sigmoid) forget gate logits per head."""
    h = cfg.n_heads
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    xi, gate = torch.chunk(xn @ p["w_up"], 2, dim=-1)
    if_logits = xi @ p["w_if"]
    i_log = (if_logits[..., :h] + p["b_i"]).float()
    f_log = F.logsigmoid((if_logits[..., h:] + p["b_f"]).float())
    return xi, gate, i_log, f_log


def block_out(y: torch.Tensor, out_norm: torch.Tensor, w_down: torch.Tensor,
              norm, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tail of a block, no residual: ``norm(y, out_norm)``, times
    SiLU(``gate``) where there is one (the mLSTM's), through ``w_down``."""
    y = norm(y, out_norm)
    if gate is not None:
        y = y * F.silu(gate)
    return y @ w_down


def _mlstm_out(p: Weights, x: torch.Tensor, y: torch.Tensor,
               gate: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x + block_out(y, p["out_norm"], p["w_down"], functools.partial(
        rmsnorm, eps=cfg.norm_eps), gate)


def mlstm_heads(xi: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                wv: torch.Tensor, i_log: torch.Tensor, f_log: torch.Tensor,
                hd: int, chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """The stabilized chunkwise recurrence of the heads that ``wq`` /
    ``wk`` / ``wv`` (up, H * hd) project ``xi`` (B, S, up) onto, their gate
    logits ``i_log`` / ``f_log`` (B, S, H) in f32: y (B, S, H * hd) in
    xi's dtype.  Every head is independent (a rank of a grid runs its
    own)."""
    b, s, _ = xi.shape
    h = wq.shape[1] // hd
    q = min(chunk, s)
    while s % q:
        q -= 1

    def heads(w):
        return (xi @ w).reshape(b, s, h, hd).float()

    qh, kh, vh = heads(wq), heads(wk), heads(wv)
    kh = kh / math.sqrt(hd)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xi.device))
    c_state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                          device=xi.device)
    n_state = torch.zeros((b, h, hd), dtype=torch.float32, device=xi.device)
    m_state = torch.full((b, h), _NEG, dtype=torch.float32, device=xi.device)

    def step(carry, chunk):
        c_state, n_state, m_state = carry
        qk, kk, vk, ik, fk = chunk
        # (B,Q,H,hd) x 3, (B,Q,H) x 2
        fcum = torch.cumsum(fk, dim=1)                      # inclusive
        # intra-chunk log decay D[t, j] = fcum[t] - fcum[j] + i[j], j <= t
        dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + ik[:, None, :, :]
        dmat = dmat.masked_fill(~mask[None, :, :, None], float("-inf"))
        # carry-in log weight per position: fcum[t] + m_prev
        carry_log = fcum + m_state[:, None, :]              # (B,Q,H)
        m_t = torch.maximum(torch.amax(dmat, dim=2), carry_log)
        dexp = torch.exp(dmat - m_t[:, :, None, :])         # (B,Q,Q,H)
        cw = torch.exp(carry_log - m_t)                     # (B,Q,H)
        scores = torch.einsum("bthd,bjhd->btjh", qk, kk) * dexp
        y_intra = torch.einsum("btjh,bjhd->bthd", scores, vk)
        # C's layout is [v-dim, k-dim]: q contracts with the k index
        y_carry = torch.einsum("bthe,bhde->bthd", qk, c_state) \
            * cw[..., None]
        n_carry = torch.einsum("bthd,bhd->bth", qk, n_state) * cw
        denom_raw = scores.sum(dim=2) + n_carry
        denom = torch.maximum(denom_raw.abs(), torch.exp(-m_t))
        y_k = (y_intra + y_carry) / denom[..., None]        # (B,Q,H,hd)
        # the state carried out of this chunk
        f_total = fcum[:, -1, :]                            # (B,H)
        out_log = f_total[:, None, :] - fcum + ik           # (B,Q,H)
        m_new = torch.maximum(m_state + f_total, torch.amax(out_log, dim=1))
        w_out = torch.exp(out_log - m_new[:, None, :])      # (B,Q,H)
        carry = torch.exp(m_state + f_total - m_new)
        c_state = c_state * carry[..., None, None] + torch.einsum(
            "bjh,bjhd,bjhe->bhde", w_out, vk, kk)
        n_state = n_state * carry[..., None] + torch.einsum(
            "bjh,bjhd->bhd", w_out, kk)
        return (c_state, n_state, m_new), y_k

    chunks = zip(*(torch.split(t, q, dim=1)
                   for t in (qh, kh, vh, i_log, f_log)))
    _, ys = scan(step, (c_state, n_state, m_state), chunks, dim=1)
    return ys.reshape(b, s, h * hd).to(xi.dtype)


def mlstm_parallel(p: Weights, x: torch.Tensor, cfg: ArchConfig,
                   chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """The stabilized chunkwise form over x (B, S, d), residual
    included."""
    hd = 2 * cfg.d_model // cfg.n_heads
    xi, gate, i_log, f_log = _mlstm_in(p, x, cfg)
    y = mlstm_heads(xi, p["wq"], p["wk"], p["wv"], i_log, f_log, hd, chunk)
    return _mlstm_out(p, x, y, gate, cfg)


def init_mlstm_state(cfg: ArchConfig, batch: int, device=None
                     ) -> Dict[str, torch.Tensor]:
    h = cfg.n_heads
    hd = 2 * cfg.d_model // h
    return {"C": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, h, hd), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, h), _NEG, dtype=torch.float32,
                            device=device)}


def mlstm_decode_heads(xi1: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                       wv: torch.Tensor, i_log: torch.Tensor,
                       f_log: torch.Tensor, state: Dict[str, torch.Tensor],
                       hd: int, dtype
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The one-token recurrent step of the heads whose columns ``wq`` /
    ``wk`` / ``wv`` hold (``hd`` wide each) on ``xi1`` (B, up), their f32
    gate logits ``i_log`` / ``f_log`` (B, h) and their ``state``: ``(y (B,
    1, h * hd) in ``dtype``, new state)``.  Every head is independent (a
    rank of a grid runs its own)."""
    b = xi1.shape[0]
    h = wq.shape[1] // hd
    q = (xi1 @ wq).reshape(b, h, hd).float()
    k = (xi1 @ wk).reshape(b, h, hd).float()
    v = (xi1 @ wv).reshape(b, h, hd).float()
    m_new = torch.maximum(f_log + state["m"], i_log)
    fs = torch.exp(f_log + state["m"] - m_new)
    is_ = torch.exp(i_log - m_new)
    ks = k / math.sqrt(hd)
    c_new = state["C"] * fs[..., None, None] \
        + is_[..., None, None] * (v[..., :, None] * ks[..., None, :])
    n_new = state["n"] * fs[..., None] + is_[..., None] * k / math.sqrt(hd)
    num = (c_new @ q[..., None])[..., 0]                       # (B,H,hd)
    den = torch.maximum((n_new * q).sum(-1).abs(), torch.exp(-m_new))
    y = (num / den[..., None]).reshape(b, 1, h * hd).to(dtype)
    return y, {"C": c_new, "n": n_new, "m": m_new}


def mlstm_decode(p: Weights, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step, x (B, 1, d); returns ``(y, new
    state)``."""
    hd = 2 * cfg.d_model // cfg.n_heads
    xi, gate, i_log, f_log = _mlstm_in(p, x, cfg)
    y, new = mlstm_decode_heads(xi[:, 0], p["wq"], p["wk"], p["wv"],
                                i_log[:, 0], f_log[:, 0], state, hd, x.dtype)
    return _mlstm_out(p, x, y, gate, cfg), new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    return {"norm": (d,), "w_in": (d, 4 * d), "r": (h, hd, 4 * hd),
            "b": (4 * d,), "out_norm": (d,), "w_down": (d, d)}


def slstm_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                 dtype=torch.float32, prefix: str = ""
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """One sLSTM block's parameters one at a time in draw order: ``w_in``
    (the z, i, f, o pre-activations) from :func:`dense_init`, the
    block-diagonal recurrence ``r`` at scale 0.1, ``w_down``; then the
    norms one, ``b`` zero."""
    return _leaves(generator, slstm_shapes(cfg),
                   (("w_in", None), ("r", 0.1), ("w_down", None)),
                   (("norm", 1.0), ("b", 0.0), ("out_norm", 1.0)), dtype,
                   prefix)


def init_slstm(generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32) -> Weights:
    """:func:`slstm_leaves` as a dict."""
    return dict(slstm_leaves(generator, cfg, dtype))


def init_slstm_state(cfg: ArchConfig, batch: int, device=None
                     ) -> Dict[str, torch.Tensor]:
    h = cfg.n_heads
    hd = cfg.d_model // h

    def zeros():
        return torch.zeros((batch, h, hd), dtype=torch.float32,
                           device=device)

    return {"c": zeros(), "n": zeros(),
            "m": torch.full((batch, h), _NEG, dtype=torch.float32,
                            device=device),
            "h": zeros()}


def slstm_heads(pre: torch.Tensor, r: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The sLSTM recurrence of the heads of ``r`` (H, hd, 4 hd) over their
    pre-activations ``pre`` (B, S, H * 4 hd) in f32, one step a token, from
    ``state`` (a fresh one if None): ``(y (B, S, H * hd) in f32, the state
    after the last token)``.  Every head is independent (a rank of a grid
    runs its own)."""
    b = pre.shape[0]
    h, hd = r.shape[0], r.shape[1]
    if state is None:
        state = {"c": pre.new_zeros((b, h, hd)),
                 "n": pre.new_zeros((b, h, hd)),
                 "m": pre.new_full((b, h), _NEG),
                 "h": pre.new_zeros((b, h, hd))}

    def step(carry, pre_t):
        c, n, m, hprev = carry
        # a bmm over the heads: a broadcast matmul would save a (B, H,
        # hd, 4hd) copy of r for backward at every step
        rec = torch.bmm(hprev.transpose(0, 1), r).transpose(0, 1)
        zifo = pre_t.reshape(b, h, 4 * hd) + rec
        z, i_, f_, o_ = torch.chunk(zifo, 4, dim=-1)
        i_log = i_.mean(-1)                                  # per head
        f_log = F.logsigmoid(f_.mean(-1))
        fm = f_log + m
        m_new = torch.maximum(fm, i_log)
        fs = torch.exp(fm - m_new)[..., None]
        is_ = torch.exp(i_log - m_new)[..., None]
        c = fs * c + is_ * torch.tanh(z)
        n = fs * n + is_
        hprev = torch.sigmoid(o_) * c / torch.clamp_min(n, 1e-6)
        return (c, n, m_new, hprev), hprev

    # unbind, not pre[:, t]: one backward node for all the steps, where
    # each select's backward would write a whole (B, S, 4d) gradient
    (c, n, m, hprev), ys = scan(
        step, (state["c"], state["n"], state["m"], state["h"]),
        pre.unbind(1), dim=1)
    return ys.reshape(b, pre.shape[1], h * hd), {"c": c, "n": n, "m": m,
                                                 "h": hprev}


def slstm_seq(p: Weights, x: torch.Tensor, cfg: ArchConfig,
              state: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The sLSTM over x (B, S, d), one step a token, from ``state`` (a
    fresh one if None); returns ``(y, the state after the last token)``."""
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    pre = (xn @ p["w_in"] + p["b"]).float()                  # (B,S,4d)
    if state is None:
        state = init_slstm_state(cfg, x.shape[0], device=x.device)
    ys, state = slstm_heads(pre, p["r"].float(), state)
    return x + block_out(ys.to(x.dtype), p["out_norm"], p["w_down"],
                         functools.partial(rmsnorm, eps=cfg.norm_eps)), state


# ---------------------------------------------------------------------------
# The model (unlike layers in a list; sLSTM at cfg.slstm_at)
# ---------------------------------------------------------------------------

class MLSTMBlock(_Leaves):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__(mlstm_shapes(cfg), dtype, device)


class SLSTMBlock(_Leaves):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__(slstm_shapes(cfg), dtype, device)


class XLSTM(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model),
                                              dtype=dtype, device=device))
        self.layers = nn.ModuleList(
            (SLSTMBlock if li in cfg.slstm_at else MLSTMBlock)(cfg, dtype,
                                                               device)
            for li in range(cfg.n_layers))
        self.norm_f = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                              device=device))
        self.unembed = nn.Parameter(torch.empty((cfg.d_model, cfg.vocab),
                                                dtype=dtype, device=device))
        self._cast: Optional[tuple] = None

    def compute_weights(self, dtype) -> Tuple[List[Weights], torch.Tensor]:
        """Every layer's leaves and the unembedding in ``dtype``, kept
        outside autograd until a parameter changes."""
        return cached_cast(self, dtype, lambda: (
            [layer.leaves(dtype) for layer in self.layers],
            self.unembed.to(dtype)))

    def forward(self, tokens, extra_embeds=None,
                compute_dtype=torch.bfloat16, unembed: bool = True):
        return forward(self, tokens, self.cfg, extra_embeds=extra_embeds,
                       compute_dtype=compute_dtype, unembed=unembed)


def init_leaves(generator: Optional[torch.Generator], cfg: ArchConfig,
                dtype=torch.float32) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every parameter of an :class:`XLSTM` as ``(its named_parameters
    name, value)``, made one at a time in draw order: layers 0..L-1, embed,
    unembed, then ``norm_f`` (the model's one draw sequence, as
    ``transformer.init_leaves``).  A None ``generator`` gives the leaves on
    ``meta``."""
    for li in range(cfg.n_layers):
        leaves = slstm_leaves if li in cfg.slstm_at else mlstm_leaves
        yield from leaves(generator, cfg, dtype, f"layers.{li}.")
    yield "embed", dense_init(generator, (cfg.vocab, cfg.d_model), dtype,
                              scale=1.0)
    yield "unembed", dense_init(generator, (cfg.d_model, cfg.vocab), dtype)
    yield "norm_f", torch.ones(cfg.d_model, dtype=dtype,
                               device=draw_device(generator))


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> XLSTM:
    """An :class:`XLSTM` on the generator's device, filled from
    :func:`init_leaves`."""
    model = XLSTM(cfg, dtype, generator.device)
    fill(model, init_leaves(generator, cfg, dtype))
    return model


def forward(params: XLSTM, tokens: torch.Tensor, cfg: ArchConfig,
            extra_embeds: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, unembed: bool = True, *,
            remat: bool = False, flash: bool = True) -> torch.Tensor:
    """Logits (B, S, vocab) in f32, or the final hidden states in the
    compute dtype if not ``unembed``.  ``extra_embeds``, ``remat`` and
    ``flash`` are accepted and unused (no attention), as the reference
    ignores the first two."""
    x = params.embed[tokens.long()].to(compute_dtype)
    layers, w = params.compute_weights(compute_dtype)
    for li, p in enumerate(layers):
        if li in cfg.slstm_at:
            x, _ = slstm_seq(p, x, cfg)
        else:
            x = mlstm_parallel(p, x, cfg)
    x = rmsnorm(x, params.norm_f, cfg.norm_eps)
    if not unembed:
        return x
    return (x @ w).float()


def lm_loss(params: XLSTM, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            remat: bool = False, compute_dtype=torch.bfloat16
            ) -> torch.Tensor:
    """Next-token cross-entropy (scalar f32) through
    :func:`chunked_lm_loss` with ``unembed``."""
    hidden = forward(params, batch["tokens"], cfg,
                     compute_dtype=compute_dtype, unembed=False)
    return chunked_lm_loss(hidden, params.unembed, batch["labels"],
                           compute_dtype=compute_dtype)


def init_state(cfg: ArchConfig, batch: int, device=None
               ) -> List[Dict[str, torch.Tensor]]:
    """A state dict per layer: the sLSTM's ``c``, ``n``, ``m``, ``h`` or
    the mLSTM's ``C``, ``n``, ``m``, all f32, whatever the sequence's
    length."""
    return [init_slstm_state(cfg, batch, device) if li in cfg.slstm_at
            else init_mlstm_state(cfg, batch, device)
            for li in range(cfg.n_layers)]


@torch.no_grad()
def decode_step(params: XLSTM, states: List[Dict[str, torch.Tensor]],
                token: torch.Tensor, pos: int, cfg: ArchConfig,
                compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One token of decode (``pos`` is unused: the states carry the
    position): logits (B, vocab) in f32.  Each layer's state dict is
    updated in place; the same list is returned."""
    x = params.embed[token.long()][:, None, :].to(compute_dtype)
    layers, w = params.compute_weights(compute_dtype)
    for li, (p, st) in enumerate(zip(layers, states)):
        if li in cfg.slstm_at:
            x, new = slstm_seq(p, x, cfg, state=st)
        else:
            x, new = mlstm_decode(p, x, st, cfg)
        st.update(new)
    x = rmsnorm(x, params.norm_f, cfg.norm_eps)
    return (x[:, 0, :] @ w).float(), states
