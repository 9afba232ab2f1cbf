"""Where each parameter of the port's language models sits in the
reference's parameter pytree.

The reference stacks per-layer leaves along leading axes and scans over
them; the port holds one module per layer.  :func:`reference_leaf` maps a
port parameter name (as ``named_parameters`` gives it) to the reference's
path and to the index of its row in the stacked leaf, by family:

* dense, vlm, moe: ``layers.<i>.attn.wq`` is row ``(i,)`` of
  ``layers/attn/wq`` (L, ...);
* hybrid: ``groups.<g>.<e>.in_proj`` is row ``(g, e)`` of
  ``groups/in_proj`` (G, E, ...), ``tail.<t>.in_proj`` row ``(t,)`` of
  ``tail/in_proj`` (T, ...); the ``shared`` block is applied after every
  group with one weight set and is not stacked;
* ssm (xlstm): the reference's ``layers`` is a Python list of unlike
  blocks, so ``layers.<i>.norm`` is the leaf ``layers/<i>/norm``, not
  stacked;
* encdec: ``enc_layers.<i>.attn.wq`` is row ``(i,)`` of
  ``enc_layers/attn/wq`` (L_enc, ...), ``dec_layers.<i>.cross_attn.wk``
  row ``(i,)`` of ``dec_layers/cross_attn/wk`` (L, ...).

Every other parameter (``embed``, ``norm_f``, ``unembed``; an encdec's
``norm_enc`` and ``norm_dec``) is a leaf of its own.  The optimizer's
weight-decay rule, the checkpoints and the converter all read the
reference's layout through this one function.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

from torch import nn

__all__ = ["reference_leaf", "family_of"]

_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")
_GROUP = re.compile(r"^groups\.(\d+)\.(\d+)\.(.+)$")
_TAIL = re.compile(r"^tail\.(\d+)\.(.+)$")
_STACKS = re.compile(r"^(enc_layers|dec_layers)\.(\d+)\.(.+)$")


def reference_leaf(name: str, family: Optional[str] = None
                   ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``(path, index)`` of port parameter ``name`` in the reference's
    pytree of ``family`` (None: the dense layout): the leaf's path, and the
    row of it that the parameter is (``()`` for a leaf that is not
    stacked)."""
    if family == "hybrid":
        m = _GROUP.match(name)
        if m:
            return (("groups",) + tuple(m.group(3).split(".")),
                    (int(m.group(1)), int(m.group(2))))
        m = _TAIL.match(name)
        if m:
            return ("tail",) + tuple(m.group(2).split(".")), (int(m.group(1)),)
        return tuple(name.split(".")), ()
    if family == "ssm":
        return tuple(name.split(".")), ()
    if family == "encdec":
        m = _STACKS.match(name)
        if m:
            return ((m.group(1),) + tuple(m.group(3).split(".")),
                    (int(m.group(2)),))
        return tuple(name.split(".")), ()
    m = _LAYER.match(name)
    if m:
        return ("layers",) + tuple(m.group(2).split(".")), (int(m.group(1)),)
    return tuple(name.split(".")), ()


def family_of(tree) -> Optional[str]:
    """The family of the first model (an ``nn.Module`` with a ``cfg``) in
    ``tree`` (a module, or nested tuples, lists and dicts), or None."""
    if isinstance(tree, nn.Module):
        cfg = getattr(tree, "cfg", None)
        return getattr(cfg, "family", None)
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            family = family_of(sub)
            if family is not None:
                return family
    return None
