"""The mesh execution layer: a local matmul backend, sharded over
``torch.distributed`` ranks (port of ``repro.backend.sharded``).

Sharding is an execution property of the one ALS engine, not a second
algorithm.  :class:`ShardedBackend` wraps a *local* backend (``torch-csr``
or ``cuda-bsr``) with the collectives of the reference's DESIGN.md §4:

* ``matmul`` / ``matmul_t`` run the inner backend on this rank's block
  (both orientations are stored, so the transpose product is a forward
  product) and ``all_reduce`` the partial products over the contracted
  axis (``psum`` becomes ``all_reduce(SUM)`` on that axis's process
  group);
* ``gram`` stays local; the engine reduces it with ``reduce_u`` /
  ``reduce_v``, sums over the factor's shard axis;
* ``sqnorm`` / ``relative_error`` sum the inner backend's per-block parts
  (``local_sqnorm`` / ``local_dot``) over the whole grid.

One iteration is four sums of useful data (two products, two k x k
Grams), one histogram sum and one max per enforced factor
(:class:`repro_torch.core.topk.DistTopK`), and the engine's scalar
bookkeeping; no factor or block of A is ever gathered inside the engine.
On ``cuda-bsr`` every half-step of every rank is one launch of the fused
``bsr_spmm_gram`` kernel on its block (``bsr_spmm`` + ``gram`` on
``cuda-bsr-unfused`` and where the fused kernel does not take k at the
block's tiles).

A process holds one rank's block (:class:`repro_torch.core.distributed.
DistCSR` / ``DistBSR``), so there is no ``shard_map``: :func:`make_sharded_als`
and :func:`make_sharded_online` run the unified engines
(:func:`repro_torch.core.nmf.als_nmf`, :func:`repro_torch.core.online.
online_als_step`) on a :class:`ShardView` of the block with a
:class:`ShardedBackend`, on every rank at once.  The reference's
module-level jit caches and its buffer donation have no counterpart: an
eager engine compiles nothing, and each step allocates its outputs.

Only ``all_reduce`` is used (gloo takes no collective on CUDA tensors
but ``all_reduce`` and ``broadcast``), and every call is counted
(:func:`repro_torch.launch.mesh.collective_counts`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.backend.base import get_backend
from repro_torch.core.distributed import (
    DistBSR, DistCSR, _bsr_block, _coo_of, _csr_block,
)
from repro_torch.kernels.bsr import BSROperand

__all__ = ["ShardView", "ShardedBackend", "make_sharded_als",
           "make_sharded_online", "SHARD_FORMATS"]

ROWS, COLS = ("data",), ("model",)


@dataclasses.dataclass(frozen=True)
class ShardView:
    """One rank's view of the sharded operand: ``fwd`` is the block A_ij as
    the inner backend's operand (local column ids), ``tsp`` the same block
    transposed, so ``A^T @ U`` is a forward product.  ``shape`` is the
    block's (n_loc, m_loc)."""

    fwd: Any
    tsp: Any

    @property
    def shape(self) -> Tuple[int, int]:
        return self.fwd.shape


class ShardedBackend:
    """A local backend with mesh collectives over ``mesh``'s axes: U's
    rows over ``"data"`` (``row_group``), V's over ``"model"``
    (``col_group``).  Runs on every rank of the mesh at once."""

    fuse_epilogue = False

    def __init__(self, inner, mesh):
        self.inner = inner
        self.mesh = mesh

    @property
    def name(self) -> str:
        return f"sharded[{self.inner.name}]"

    def accepts(self, a) -> bool:
        return isinstance(a, ShardView)

    def prepare(self, a, dtype=None, device=None):
        if not isinstance(a, ShardView):
            raise TypeError(
                "ShardedBackend consumes ShardView blocks; distribute the "
                "matrix first (the engines from make_sharded_als / "
                "make_sharded_online expose run.distribute)")
        return a

    # -- the products: local product + sum over the contracted axis ---------

    def matmul(self, a: ShardView, v: torch.Tensor) -> torch.Tensor:
        """A @ V: A_ij @ V_j summed over the column blocks."""
        return self.mesh.all_reduce(self.inner.matmul(a.fwd, v), COLS)

    def matmul_t(self, a: ShardView, u: torch.Tensor) -> torch.Tensor:
        """A^T @ U: the forward product on the transposed block, summed
        over the row blocks."""
        return self.mesh.all_reduce(self.inner.matmul(a.tsp, u), ROWS)

    def gram(self, x: torch.Tensor) -> torch.Tensor:
        return self.inner.gram(x)

    def matmul_with_gram(self, a: ShardView, v: torch.Tensor):
        """``(A @ V, V_j^T V_j)``: the inner backend's fused pair on the
        block (one ``bsr_spmm_gram`` launch on ``cuda-bsr``); only the
        product is summed, the Gram stays local for ``reduce_v``."""
        y, g = self.inner.matmul_with_gram(a.fwd, v)
        return self.mesh.all_reduce(y, COLS), g

    def matmul_t_with_gram(self, a: ShardView, u: torch.Tensor):
        """``(A^T @ U, U_i^T U_i)`` on the transposed block, the product
        summed over the row blocks, the Gram local for ``reduce_u``."""
        y, g = self.inner.matmul_with_gram(a.tsp, u)
        return self.mesh.all_reduce(y, ROWS), g

    # -- reductions -----------------------------------------------------------

    def reduce_u(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x, ROWS)

    def reduce_v(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x, COLS)

    def reduce_all(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over the whole grid (one ``all_reduce`` on the default
        group; the reference sums over one axis, then the other)."""
        return self.mesh.all_reduce(x, ROWS + COLS)

    # -- metrics --------------------------------------------------------------

    def local_sqnorm(self, a: ShardView) -> torch.Tensor:
        return self.inner.local_sqnorm(a.fwd)

    def local_dot(self, a: ShardView, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
        return self.inner.local_dot(a.fwd, u, v)

    def sqnorm(self, a: ShardView) -> torch.Tensor:
        return self.reduce_all(self.local_sqnorm(a))

    def relative_error(self, a: ShardView, u: torch.Tensor, v: torch.Tensor,
                       a_sqnorm: torch.Tensor) -> torch.Tensor:
        """``||A - U V^T||_F / ||A||_F`` from the blocks' parts: the cross
        term ``<A_ij, U_i V_j^T>`` (``local_dot``: ``bsr_dot_uv`` on BSR
        blocks, a gather-dot on CSR blocks) summed over the grid, and the
        Gram term from the summed Grams."""
        cross = self.reduce_all(self.local_dot(a, u, v))
        gu = self.reduce_u(u.T @ u)
        gv = self.reduce_v(v.T @ v)
        err_sq = torch.clamp_min(a_sqnorm - 2.0 * cross
                                 + torch.sum(gu * gv), 0.0)
        return torch.sqrt(err_sq / torch.clamp_min(a_sqnorm, 1e-30))


# ---------------------------------------------------------------------------
# Shard formats: the block each inner backend carries
# ---------------------------------------------------------------------------

class _CsrShardFormat:
    """Padded-CSR blocks (``DistCSR``), both orientations."""

    dist_type = DistCSR

    def block(self, coo, mesh, device) -> DistCSR:
        rows, cols, vals, shape = coo
        return _csr_block(rows, cols, vals, shape, mesh.shape,
                          (mesh.i, mesh.j), device)

    def local(self, dist: DistCSR) -> ShardView:
        return ShardView(fwd=dist.fwd, tsp=dist.tsp)


class _BsrShardFormat:
    """BSR tile blocks (``DistBSR``): the block's ledger-resolved tiles in both
    orientations, each with its own split plan, fed to the CUDA kernels."""

    dist_type = DistBSR

    def block(self, coo, mesh, device) -> DistBSR:
        """This rank's block, at the tiles ``cuda-bsr`` resolves for a
        block's shape (each rank's kernels see the (n / rows, m / cols)
        block, so that is the shape the ledger keys on, as in the
        reference's ``BsrShardFormat.ingest``)."""
        from repro_torch.backend.base import get_backend

        rows, cols, vals, shape = coo
        r, c = mesh.shape
        tiles = get_backend("cuda-bsr").tile_config(
            max(shape[0] // r, 1), max(shape[1] // c, 1), device=device)
        return _bsr_block(rows, cols, vals, shape, mesh.shape,
                          (mesh.i, mesh.j), bm=tiles.bm, bk=tiles.bk,
                          bcap=None, bcap_t=None, device=device)

    def local(self, dist: DistBSR) -> ShardView:
        """The two views over the same tile tensors (no copy): ``fwd`` runs
        A_ij @ V_j on ``bsr``, ``tsp`` runs A_ij^T @ U_i on ``bsr_t``."""
        op = dist.op
        return ShardView(fwd=op,
                         tsp=BSROperand(op.bsr_t, op.bsr,
                                        (op.shape[1], op.shape[0])))


_CSR, _BSR = _CsrShardFormat(), _BsrShardFormat()

#: local backends whose operands a ShardView carries, by registry name and
#: the reference's aliases
SHARD_FORMATS = {
    "torch-csr": _CSR, "jnp-csr": _CSR,
    "cuda-bsr": _BSR, "pallas-bsr": _BSR,
    "cuda-bsr-unfused": _BSR, "pallas-bsr-unfused": _BSR,
}


def _check_inner(inner: str):
    try:
        return SHARD_FORMATS[inner]
    except KeyError:
        raise ValueError(
            f"ShardedBackend wraps one of {sorted(SHARD_FORMATS)}, got "
            f"{inner!r}") from None


def _attach(run, fmt, mesh, be):
    """The surface both engines share: ``distribute`` (this rank's block
    of any input) and ``backend``."""

    def distribute(a, pad_cols_to=None, device=None):
        """This rank's block of ``a`` in the engine's shard format, on
        ``device`` (the mesh's by default; the streaming packer ingests on
        the host and copies on a side stream); an already distributed block
        passes through, moved to the mesh's device.
        ``pad_cols_to`` widens the logical column count with empty
        documents first (a streamed chunk the grid does not divide): no
        stored entry changes, and an all-zero column gives an exactly zero
        V row that adds nothing to the statistics."""
        if isinstance(a, (DistCSR, DistBSR)):
            if not isinstance(a, fmt.dist_type):
                raise TypeError(
                    f"a {type(a).__name__} block cannot run on the "
                    f"{be.name} engine")
            if pad_cols_to is not None and a.shape[1] != pad_cols_to:
                raise ValueError(
                    f"operand is already distributed at {a.shape}; pad to "
                    f"{pad_cols_to} columns before distributing")
            if tuple(a.grid) != mesh.shape or tuple(a.index) != (mesh.i,
                                                                  mesh.j):
                raise ValueError(
                    f"block {a.index} of grid {a.grid} handed to rank "
                    f"({mesh.i}, {mesh.j}) of a {mesh.shape} mesh")
            return a.to(mesh.device if device is None else device)
        rows, cols, vals, (n, m) = _coo_of(a)
        if pad_cols_to is not None:
            if pad_cols_to < m:
                raise ValueError(
                    f"pad_cols_to={pad_cols_to} is narrower than the "
                    f"operand's {m} columns")
            m = pad_cols_to
        return fmt.block((rows, cols, vals, (n, m)), mesh,
                         mesh.device if device is None else device)

    run.distribute = distribute
    run.backend = be
    run.mesh = mesh
    run.local = fmt.local
    return run


def make_sharded_als(mesh, *, sparsify_u=None, sparsify_v=None,
                     track_error: bool = True, inner: str = "torch-csr"):
    """The batch ALS engine on ``mesh``: ``run(dist, u0, iters) ->
    NMFResult`` with ``dist`` this rank's block (``run.distribute(a)``),
    ``u0`` this rank's rows of U (``mesh.row_block``), and the result's
    ``u`` / ``v`` this rank's rows of U and V; the traces are the global
    ones, equal on every rank.  ``sparsify_u`` / ``sparsify_v`` should be
    :class:`~repro_torch.core.topk.DistTopK` over ``("data",)`` /
    ``("model",)`` or ``None``."""
    from repro_torch.core.nmf import als_nmf

    fmt = _check_inner(inner)
    be = ShardedBackend(get_backend(inner), mesh)

    def run(dist, u0: torch.Tensor, iters: int):
        return als_nmf(fmt.local(dist), u0, iters=iters,
                       sparsify_u=sparsify_u, sparsify_v=sparsify_v,
                       track_error=track_error, backend=be)

    return _attach(run, fmt, mesh, be)


def make_sharded_online(mesh, *, sparsify_u=None, sparsify_v=None,
                        inner: str = "torch-csr"):
    """The online engine on ``mesh``: ``run(dist_chunk, u, stats, iters,
    forget=1.0) -> OnlineStepResult`` with the chunk's columns sharded over
    ``"model"``, ``u`` and ``stats.av`` this rank's rows (``"data"``),
    ``stats.gv`` whole.  The chunk's statistics ``A_c V_c`` and
    ``V_c^T V_c`` are summed through the backend's hooks, so the
    accumulators are the global ones.  ``sparsify_v`` is the per-chunk
    ``DistTopK`` over ``("model",)``."""
    from repro_torch.core.online import online_als_step

    fmt = _check_inner(inner)
    be = ShardedBackend(get_backend(inner), mesh)

    def run(dist_chunk, u: torch.Tensor, stats, iters: int, forget=1.0):
        return online_als_step(fmt.local(dist_chunk), u, stats, forget,
                               iters=iters, sparsify_u=sparsify_u,
                               sparsify_v=sparsify_v, backend=be)

    return _attach(run, fmt, mesh, be)
