"""AdamW with a warmup-cosine schedule (port of
``repro.training.optimizer``).

A parameter tree is an ``nn.Module`` (its ``named_parameters``) or a flat
dict of tensors.  The state keeps μ and ν as f32 tensors keyed like the
parameters and the step as an int32 scalar tensor on their device, so the
schedule and the bias correction never leave the card.

The update runs in place under ``torch.no_grad()``: parameters, μ and ν are
overwritten (the port's form of the reference's buffer donation), and the
returned state holds the same μ and ν with the new step.

Weight decay is decoupled and falls on the leaves that have two or more
dims *in the reference's layout* (``repro_torch.layout``), which depends
on the family.  The dense and moe models stack each per-layer leaf along
a leading L axis, so a layer's norm weights (``layers.<i>.norm_attn``:
(d,) here, (L, d) there) and its biases are decayed, and ``norm_f`` is
not.  The hybrid stacks its groups twice, (G, E, ...), and its tail once,
so every Mamba vector (``A_log``, ``D``, ``dt_bias``, the norms) is
decayed, and its shared block not at all; xlstm keeps a list of unlike
layers, so none of its vectors is; the encdec stacks its encoder and
decoder layers once each, so their norms are decayed and ``norm_enc`` /
``norm_dec`` are not.  :func:`reference_ndim` counts the
stacked axes; :meth:`AdamW.update` reads the family from the model
(``params.cfg``; a dict of tensors takes the dense layout).
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, Mapping, NamedTuple, Optional, Tuple,
                    Union)

import torch
from torch import nn

from repro_torch.layout import family_of, reference_leaf

__all__ = ["AdamW", "AdamState", "named_parameters", "reference_ndim",
           "value_and_grad"]

Params = Union[nn.Module, Mapping[str, torch.Tensor]]

class AdamState(NamedTuple):
    step: torch.Tensor                  # int32 scalar
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def named_parameters(params: Params) -> Dict[str, torch.Tensor]:
    """Name -> tensor of every leaf of a parameter tree."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    if isinstance(params, Mapping):
        return dict(params)
    raise TypeError(f"a parameter tree is an nn.Module or a dict of "
                    f"tensors, not {type(params).__name__}")


def reference_ndim(name: str, p: torch.Tensor,
                   family: Optional[str] = None) -> int:
    """The number of dims of leaf ``name`` in the reference's layout of
    ``family`` (None: the dense layout): its own, and the stacked axes in
    front of it there."""
    return p.dim() + len(reference_leaf(name, family)[1])


def value_and_grad(loss_fn: Callable, params: Params, batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``loss_fn(params, batch)`` and its gradient with respect to every
    leaf, keyed like the leaves (``torch.autograd.grad``: nothing is left in
    ``.grad``).  A dict's tensors are differentiated through detached
    copies, so the caller's tensors need not require a gradient."""
    if not isinstance(params, nn.Module):
        params = {name: t.detach().requires_grad_(True)
                  for name, t in named_parameters(params).items()}
    named = named_parameters(params)
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup: int = 200
    total_steps: int = 10000

    def init(self, params: Params) -> AdamState:
        named = named_parameters(params)
        device = next(iter(named.values())).device
        # two sets of zeros: μ and ν are updated in place
        mu = {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in named.items()}
        nu = {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in named.items()}
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         mu, nu)

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup to ``lr``, then a cosine to a 0.1 floor, in f32."""
        s = step.float()
        warm = torch.clamp(s / max(self.warmup, 1), max=1.0)
        prog = torch.clamp((s - self.warmup)
                           / max(self.total_steps - self.warmup, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return self.lr * warm * (0.1 + 0.9 * cos)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState,
               params: Params) -> Tuple[Params, AdamState]:
        """One AdamW step in place; returns ``(params, new state)``."""
        named = named_parameters(params)
        family = family_of(params)
        if set(grads) != set(named):
            raise ValueError(
                f"gradients do not match the parameters: missing "
                f"{sorted(set(named) - set(grads))}, unexpected "
                f"{sorted(set(grads) - set(named))}")
        step = state.step + 1
        lr = self.schedule(step)
        stepf = step.float()
        c1 = 1 - self.b1 ** stepf          # bias corrections, f32
        c2 = 1 - self.b2 ** stepf
        b1, b2 = self.b1, self.b2
        for name, p in named.items():
            g32 = grads[name].float()
            m, n = state.mu[name], state.nu[name]
            m.mul_(b1).add_((1 - b1) * g32)
            n.mul_(b2).add_((1 - b2) * g32 * g32)
            delta = (m / c1) / (torch.sqrt(n / c2) + self.eps)
            if reference_ndim(name, p, family) >= 2:   # decoupled decay
                delta = delta + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, AdamState(step, state.mu, state.nu)
