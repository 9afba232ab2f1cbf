"""Carry state from the reference package into the port.

Everything crosses as numpy arrays, so this module needs neither ``jax`` nor
the reference package:

* :func:`bsr_from_reference` — a reference BSR operand's ``tiles`` /
  ``block_cols`` (``np.asarray`` of them) as the port's :class:`BSR`;
* :func:`estimator_from_reference` — a fitted port estimator from a
  reference model's ``u_`` / ``v_``, so both fold in the same documents
  identically;
* the initial guess crosses as numpy too: ``EnforcedNMF.fit(a, u0=u0)``
  takes a numpy ``u0``.  ``jax.random`` cannot be reproduced in torch, so
  parity checks hand both packages one numpy ``u0``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.bsr import BSR, _make_bsr
from repro_torch.nmf.config import NMFConfig
from repro_torch.nmf.estimator import EnforcedNMF

__all__ = ["bsr_from_reference", "estimator_from_reference"]


def bsr_from_reference(tiles, block_cols, shape: Tuple[int, int],
                       device: DeviceLike = None) -> BSR:
    """The port's :class:`BSR` (with its Gram coverage) from a reference
    BSR's arrays, copied."""
    return _make_bsr(np.array(tiles), np.array(block_cols, np.int32),
                     (int(shape[0]), int(shape[1])), resolve_device(device))


def estimator_from_reference(u, v, m_ref: int, config: NMFConfig,
                             device: DeviceLike = None) -> EnforcedNMF:
    """A fitted :class:`EnforcedNMF` holding the reference model's factors
    ``u`` (n, k) and ``v`` (m, k); ``m_ref`` is the reference fit's document
    count (it scales ``t_v`` budgets in ``transform``)."""
    model = EnforcedNMF(config, device=device)
    model.u_ = model._factor(u)
    model.v_ = model._factor(v)
    model.n_features_ = model.u_.shape[0]
    model.n_docs_seen_ = int(m_ref)
    model._m_ref = int(m_ref)
    return model
