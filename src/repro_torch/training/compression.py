"""Top-k compressed data-parallel gradients with error feedback (port of
``repro.training.compression``): the paper's enforced top-t projection
applied to the gradient exchange.

Each data-parallel rank keeps only the top ``density`` fraction of its
gradient entries by magnitude (the bisection threshold of
``core/topk.py::topk_project_bisect``, the primitive of Alg. 2) before
the reduction; what the projection drops is fed into the rank's next
gradient (error feedback).

The reference's ``shard_map`` becomes one process a rank over
``torch.distributed``: ``mesh`` is the port's :class:`~repro_torch.launch.
mesh.NMFMesh`, and the reduction over ``data_axes`` is its counted
``all_reduce`` (one a leaf and one for the loss, as the reference's
``psum`` / ``pmean``).  One rank holds one slot of the error state, not the
whole ``(ndp, ...)`` stack the reference shards.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence, Tuple

import torch

from repro_torch.core.topk import topk_project_bisect
from repro_torch.training.optimizer import (
    Params,
    named_parameters,
    value_and_grad,
)

__all__ = ["sparsify_tree", "init_error_state", "make_compressed_grad_fn"]

Tree = Dict[str, torch.Tensor]


def sparsify_tree(grads: Mapping[str, torch.Tensor], density: float
                  ) -> Tuple[Tree, Tree]:
    """Per-leaf top-k projection, keeping ``max(int(size * density), 1)``
    entries a leaf (up to threshold ties); returns ``(sparse, error)``
    with ``error = grads - sparse``."""
    sparse = {n: topk_project_bisect(g, max(int(g.numel() * density), 1))
              for n, g in grads.items()}
    return sparse, {n: g - sparse[n] for n, g in grads.items()}


def init_error_state(params: Params, ndp: int) -> Tree:
    """This rank's zero error-feedback slot: an f32 tensor shaped like each
    parameter.  ``ndp`` is the data-parallel width; the reference stacks
    all ``ndp`` slots on every rank, here each rank holds its own."""
    if int(ndp) < 1:
        raise ValueError(f"ndp must be at least 1, got {ndp}")
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named_parameters(params).items()}


def _data_index(mesh, data_axes: Tuple[str, ...]) -> int:
    """This rank's position along ``data_axes`` (``"pod"``, ``"data"``,
    ``"model"``; row-major in that order, as the reference's
    ``P(data_axes)`` lays the batch out)."""
    return mesh.index(data_axes)


def make_compressed_grad_fn(loss_fn: Callable, mesh,
                            data_axes: Sequence[str], density: float = 0.01
                            ) -> Callable:
    """``grad_fn(params, batch, err) -> (loss, grads, err)`` for data
    parallelism with top-k compression and error feedback.

    Every rank passes the same ``params`` and the whole ``batch``; each
    takes its block of the batch's leading axis (``ndp`` equal blocks, in
    rank order along ``data_axes``), and ``err`` is its own slot
    (:func:`init_error_state`).  On each rank: the local gradient plus the
    slot, projected to its top ``density`` entries, summed over
    ``data_axes`` and divided by ``ndp``; the remainder is the new slot,
    and the loss is averaged over the ranks."""
    data_axes = tuple(data_axes)
    ndp = mesh.axis_size(data_axes)

    def grad_fn(params, batch, err):
        r = _data_index(mesh, data_axes)

        def block(x):
            if x.shape[0] % ndp:
                raise ValueError(f"batch axis {x.shape[0]} does not split "
                                 f"into {ndp} data-parallel blocks")
            n = x.shape[0] // ndp
            return x[r * n:(r + 1) * n]

        local = {name: block(x) for name, x in batch.items()}
        loss, g = value_and_grad(loss_fn, params, local)
        g = {n: gi + err[n].to(gi.dtype) for n, gi in g.items()}
        g_sparse, new_err = sparsify_tree(g, density)
        g_avg = {n: mesh.all_reduce(gi, data_axes) / ndp
                 for n, gi in g_sparse.items()}
        loss = mesh.all_reduce(loss, data_axes) / ndp
        return loss, g_avg, new_err

    return grad_fn
