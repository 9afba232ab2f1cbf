"""Carry state from the reference package into the port.

Everything crosses as numpy arrays, so this module needs neither ``jax`` nor
the reference package:

* :func:`bsr_from_reference` — a reference BSR operand's ``tiles`` /
  ``block_cols`` (``np.asarray`` of them) as the port's :class:`BSR`;
* :func:`estimator_from_reference` — a fitted port estimator from a
  reference model's ``u_`` / ``v_`` and its streaming statistics
  (``_av_acc``, ``_gv_acc``, ``n_docs_seen_``), so both fold in the same
  documents identically and a ``partial_fit`` continues both alike;
* the initial guess crosses as numpy too: ``EnforcedNMF.fit(a, u0=u0)``
  takes a numpy ``u0``.  ``jax.random`` cannot be reproduced in torch, so
  parity checks hand both packages one numpy ``u0``;
* :func:`model_from_reference` — an LM parameter pytree
  (``jax.tree.map(np.asarray, params)``) as the port's model of its
  family: a ``Transformer`` (dense, vlm), a ``MoETransformer`` (each
  stacked expert tensor one parameter a layer), a ``Hybrid`` (the (G, E,
  ...) groups and (T, ...) tail unstacked into Mamba blocks) or an
  ``XLSTM`` (the reference's list of layers copied as it is) or an
  ``EncDec`` (the stacked ``enc_layers`` and ``dec_layers`` unstacked);
* :func:`adam_state_from_reference` — the reference's ``AdamState`` for
  those parameters as the port's, so that both optimizers start from one
  state;
* :func:`cache_from_reference` — a decode state of the reference
  (``jax.tree.map(np.asarray, cache)``) as the port's: the same tree of
  dicts and lists (a hybrid's stacked ``groups`` / ``tail`` states, an
  xlstm's list of per-layer dicts), each leaf a tensor of its dtype (bf16
  included), checked against ``cfg``'s ``api.init_decode_cache``.

The leaves are placed by ``repro_torch.layout``, the one map from the
port's parameter names to the reference's stacked leaves.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.bsr import BSR, _make_bsr
from repro_torch.layout import reference_leaf
from repro_torch.models.common import ArchConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.moe import MoETransformer
from repro_torch.models.transformer import Transformer
from repro_torch.models.xlstm import XLSTM
from repro_torch.nmf.config import NMFConfig
from repro_torch.nmf.estimator import EnforcedNMF
from repro_torch.training.optimizer import AdamState

__all__ = ["bsr_from_reference", "estimator_from_reference",
           "model_from_reference", "adam_state_from_reference",
           "cache_from_reference"]

#: the port's model class of each family
_MODELS = {"dense": Transformer, "vlm": Transformer, "moe": MoETransformer,
           "hybrid": Hybrid, "ssm": XLSTM, "encdec": EncDec}


def bsr_from_reference(tiles, block_cols, shape: Tuple[int, int],
                       device: DeviceLike = None) -> BSR:
    """The port's :class:`BSR` (with its Gram coverage) from a reference
    BSR's arrays, copied."""
    return _make_bsr(np.array(tiles), np.array(block_cols, np.int32),
                     (int(shape[0]), int(shape[1])), resolve_device(device))


def estimator_from_reference(u, v, m_ref: int, config: NMFConfig,
                             device: DeviceLike = None, *, av=None, gv=None,
                             n_docs_seen: Optional[int] = None
                             ) -> EnforcedNMF:
    """A fitted :class:`EnforcedNMF` holding the reference model's factors
    ``u`` (n, k) and ``v`` (m, k); ``m_ref`` is the reference fit's document
    count (it scales ``t_v`` budgets in ``transform``).  ``av`` (n, k) and
    ``gv`` (k, k) are its streaming statistics (``_av_acc`` / ``_gv_acc``,
    which the reference seeds at the end of every ``fit``) and
    ``n_docs_seen`` its ``n_docs_seen_`` (default ``m_ref``); without the
    statistics a ``partial_fit`` starts a new stream instead of continuing
    the fit."""
    model = EnforcedNMF(config, device=device)
    model.u_ = model._factor(u)
    model.v_ = model._factor(v)
    model.n_features_ = model.u_.shape[0]
    model.n_docs_seen_ = int(m_ref if n_docs_seen is None else n_docs_seen)
    model._m_ref = int(m_ref)
    if (av is None) != (gv is None):
        raise ValueError("give both streaming statistics (av and gv) or "
                         "neither")
    if av is not None:
        model._av_acc = model._factor(av)
        model._gv_acc = model._factor(gv)
    return model


def _model(cfg: ArchConfig, device) -> nn.Module:
    if cfg.family not in _MODELS:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) has "
                                  "no model in the port")
    return _MODELS[cfg.family](cfg, torch.float32, device)


def _placed(cfg: ArchConfig
            ) -> Dict[str, Tuple[str, Tuple[int, ...], Tuple[int, ...]]]:
    """Port parameter name -> (reference path, row index, row shape) for
    ``cfg``'s model (built on the meta device: shapes only)."""
    return {name: ("/".join(path), index, tuple(p.shape))
            for name, p in _model(cfg, "meta").named_parameters()
            for path, index in [reference_leaf(name, cfg.family)]}


def _reference_leaves(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Path ("layers/attn/wq", …) -> shape of every leaf of the reference's
    parameter pytree of ``cfg``: a stacked leaf's shape is its stacked
    axes' sizes in front of a row's."""
    rows: Dict[str, tuple] = {}
    for path, index, shape in _placed(cfg).values():
        rows.setdefault(path, (shape, []))[1].append(index)
    return {path: tuple(1 + max(i[a] for i in idx)
                        for a in range(len(idx[0]))) + shape
            for path, (shape, idx) in rows.items()}


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, sub in items:
            out.update(_flatten(sub, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}


def _checked_leaves(tree, cfg: ArchConfig) -> Dict[str, object]:
    """``tree``'s leaves by path, checked against ``cfg``'s layout."""
    want = _reference_leaves(cfg)
    got = _flatten(tree)
    if set(got) != set(want):
        raise ValueError(
            f"parameter tree does not match {cfg.name}: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}")
    for path, shape in want.items():
        if tuple(np.shape(got[path])) != shape:
            raise ValueError(f"{path}: shape {tuple(np.shape(got[path]))}, "
                             f"{cfg.name} needs {shape}")
        dtype = np.asarray(got[path]).dtype
        if dtype.kind in "biuc":    # bf16 (ml_dtypes) is kind "V"
            raise ValueError(f"{path}: dtype {dtype}, {cfg.name} needs "
                             "real floating-point leaves")
    return got


def _unstacked(got: Dict[str, object], cfg: ArchConfig
               ) -> Dict[str, np.ndarray]:
    """Port parameter name (``layers.3.attn.wq``) -> f32 array: each
    parameter's row of its reference leaf."""
    leaves: Dict[str, np.ndarray] = {}
    out = {}
    for name, (path, index, _) in _placed(cfg).items():
        if path not in leaves:
            leaves[path] = np.asarray(got[path], dtype=np.float32)
        out[name] = np.array(leaves[path][index])
    return out


def adam_state_from_reference(state, cfg: ArchConfig,
                              device: DeviceLike = None) -> AdamState:
    """The port's :class:`AdamState` from the reference's (``step``, ``mu``,
    ``nu``; numpy leaves) for ``cfg``'s parameters: μ and ν unstacked
    into f32 tensors keyed like the model's ``named_parameters``, the step
    an int32 scalar.  Raises ``ValueError`` as
    :func:`model_from_reference` does."""
    step, mu, nu = state
    dev = resolve_device(device)
    moments = [{name: torch.from_numpy(x).to(dev)
                for name, x in _unstacked(_checked_leaves(tree, cfg),
                                          cfg).items()}
               for tree in (mu, nu)]
    return AdamState(torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                  device=dev), *moments)


def model_from_reference(params, cfg: ArchConfig, device: DeviceLike = None
                         ) -> nn.Module:
    """The port's model of ``cfg``'s family holding the reference's
    parameters: ``params`` is the reference's pytree with numpy leaves.
    Each stacked leaf is unstacked into the port's per-layer modules (a
    moe router ``(L, d, E)`` and expert tensors ``(L, E, d, f)``; a
    hybrid's ``(G, E, ...)`` groups and ``(T, ...)`` tail; an encdec's
    encoder and decoder stacks); xlstm's list
    of layers is copied as it is; nothing is transposed (both keep ``(in,
    out)``).  Raises ``ValueError`` when the tree's leaves, shapes or
    dtypes are not those of ``cfg``."""
    return _filled(_model(cfg, resolve_device(device)), params, cfg)



def _filled(model, params, cfg: ArchConfig):
    leaves = _unstacked(_checked_leaves(params, cfg), cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(leaves[name]))
    return model


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor of its dtype; bf16 (ml_dtypes) crosses as
    its bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def cache_from_reference(cache, cfg: ArchConfig, device: DeviceLike = None):
    """The port's decode state holding the reference's ``cache`` (its tree
    with numpy leaves, as its ``init_decode_cache`` / ``prefill`` /
    ``decode_step`` make it): the same tree, each leaf a tensor of the
    leaf's dtype on ``device``.  Raises ``ValueError`` when the tree is not
    one of ``cfg``'s decode states (its structure and shapes against
    ``api.init_decode_cache`` at the batch and length it holds)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.models import api

    dev = resolve_device(device)
    got = _flatten(cache)
    if cfg.family == "ssm":
        b = int(np.shape(got["0/m"])[0]) if "0/m" in got else 0
        t = 1
    else:
        kv = got.get("ck" if cfg.family == "encdec" else "k")
        if kv is None:
            raise ValueError(f"not a decode state of {cfg.name}: no "
                             "KV leaf")
        b, t = int(np.shape(kv)[1]), int(np.shape(kv)[2])
    want = _flatten(api.init_decode_cache(cfg, ShapeSpec("reference", t, b,
                                                         "decode"),
                                          device="meta"))
    if set(got) != set(want):
        raise ValueError(
            f"decode state does not match {cfg.name}: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}")
    for path, leaf in want.items():
        if (leaf is None) != (got[path] is None):
            raise ValueError(f"{path}: {cfg.name} needs "
                             f"{'no leaf' if leaf is None else 'a leaf'}")
        if leaf is not None and \
                tuple(np.shape(got[path])) != tuple(leaf.shape):
            raise ValueError(f"{path}: shape {tuple(np.shape(got[path]))}, "
                             f"{cfg.name} needs {tuple(leaf.shape)}")

    def convert(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return _tensor(node, dev)

    return convert(cache)
