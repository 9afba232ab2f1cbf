"""The NMF device grid over ``torch.distributed`` (port of
``repro.launch.mesh.make_nmf_mesh``).

One process (rank) holds one (p, i, j) block of the ``pods x rows x cols``
grid, row-major as the reference's ``devices.reshape(pods, rows, cols)``:
``(p, i, j)`` from ``rank = (p * rows + i) * cols + j``.  With one pod (the
default) that is the 2-D ``rows x cols`` grid, ``(i, j) = divmod(rank,
cols)``.  The reference's mesh axes become process groups:

* ``"data"`` — the ranks that share (p, j) (they differ in i);
* ``"model"`` — the ranks that share (p, i): V's and A's column blocks;
* ``"pod"`` — the ranks that share (i, j);
* ``("pod", "data")`` — the ranks that share j.  It is one group and one
  ``all_reduce``, not two nested ones, so that a ``2 x 2 x 2`` grid reduces
  in the order a ``4 x 2`` grid does.  U's and A's row blocks are sharded
  over it, at the combined row index ``p * rows + i``
  (:meth:`NMFMesh.row_block`); with one pod it is ``"data"``.

Every reduction goes through :meth:`NMFMesh.all_reduce`, and the
expert-parallel exchange through :meth:`NMFMesh.all_to_all`, whose
backward is the same exchange; both count their calls and bytes
(:func:`collective_counts`), backward included, and are the identity over
an axis of one rank.  A 1x1 mesh with no process group initialized has no
groups at all and runs anywhere, the reference's "1x1 runs anywhere": the
same code, no collective.  gloo takes no collective on CUDA tensors but
``all_reduce`` and ``broadcast``, so under gloo an ``all_to_all`` of a CUDA
tensor goes through one explicit copy to the host and one back; the
backend the caller initialized decides that.

The collective backend (``nccl`` or ``gloo``) is the caller's choice, made
when the process group is initialized; nothing here picks another when one
fails.  :func:`spawn_mesh` starts a grid of ranks on one host for tests and
measurements.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["NMFMesh", "make_nmf_mesh", "make_local_mesh",
           "make_production_mesh", "spawn_mesh",
           "collective_counts", "reset_collective_counts", "AXES",
           "ROW_AXES"]

#: the reference's axis names: U's rows shard over ("pod", "data"), V's
#: over "model"
AXES = ("pod", "data", "model")
ROW_AXES = ("pod", "data")

_COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "bytes": 0}
_ALL_TO_ALL: Dict[str, int] = {"calls": 0, "bytes": 0}


def collective_counts() -> Dict[str, int]:
    """The ``all_reduce`` calls this process issued since the last reset,
    and the bytes they reduced; once it has issued an ``all_to_all``, also
    ``"all_to_all"`` (calls) and ``"all_to_all_bytes"`` (the bytes it
    sent).  An NMF fit issues no ``all_to_all``, so its counts keep their
    two keys."""
    out = dict(_COLLECTIVES)
    if _ALL_TO_ALL["calls"]:
        out.update(all_to_all=_ALL_TO_ALL["calls"],
                   all_to_all_bytes=_ALL_TO_ALL["bytes"])
    return out


def reset_collective_counts() -> None:
    for counts in (_COLLECTIVES, _ALL_TO_ALL):
        for key in counts:
            counts[key] = 0


def _axes(axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for ax in axes:
        if ax not in AXES:
            raise ValueError(f"unknown mesh axis {ax!r}; use {AXES}")
    return tuple(ax for ax in AXES if ax in axes)


@dataclasses.dataclass(frozen=True, eq=False)
class NMFMesh:
    """This process's place in the ``pods x rows x cols`` grid and its
    groups.

    ``groups`` maps an axis set (in ``AXES`` order) to this rank's process
    group of the ranks that differ along it; it is empty on a 1x1 mesh
    without a process group.  The default group spans the grid."""

    rows: int
    cols: int
    rank: int
    device: torch.device
    pods: int = 1
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)

    @property
    def row_group(self):
        """The group of ``"data"``."""
        return self.groups.get(("data",))

    @property
    def col_group(self):
        """The group of ``"model"``."""
        return self.groups.get(("model",))

    @property
    def shape(self) -> Tuple[int, ...]:
        """``(rows, cols)``, or ``(pods, rows, cols)`` with several pods."""
        if self.pods == 1:
            return (self.rows, self.cols)
        return (self.pods, self.rows, self.cols)

    @property
    def size(self) -> int:
        return self.pods * self.rows * self.cols

    @property
    def p(self) -> int:
        """This rank's pod (its coordinate on ``"pod"``)."""
        return self.rank // (self.rows * self.cols)

    @property
    def i(self) -> int:
        """This rank's row block within its pod (its coordinate on
        ``"data"``)."""
        return (self.rank // self.cols) % self.rows

    @property
    def j(self) -> int:
        """This rank's column block (its coordinate on ``"model"``)."""
        return self.rank % self.cols

    def _extent(self, ax: str) -> Tuple[int, int]:
        """(size, this rank's coordinate) along one axis."""
        return {"pod": (self.pods, self.p), "data": (self.rows, self.i),
                "model": (self.cols, self.j)}[ax]

    def axis_size(self, axes: Union[str, Sequence[str]]) -> int:
        out = 1
        for ax in _axes(axes):
            out *= self._extent(ax)[0]
        return out

    def index(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's position along ``axes``, row-major in the order
        given: ``p * rows + i`` along ``("pod", "data")``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        _axes(axes)
        out = 0
        for ax in axes:
            size, coord = self._extent(ax)
            out = out * size + coord
        return out

    def block(self, n: int, axes: Union[str, Sequence[str]]) -> slice:
        """The rows of an n-row array sharded over ``axes`` that this rank
        holds."""
        n_loc = n // self.axis_size(axes)
        r = self.index(axes)
        return slice(r * n_loc, (r + 1) * n_loc)

    def _group(self, axes: Sequence[str]):
        """The group of ``axes``, an axis of one rank left out: the default
        group when the rest spans the grid."""
        axes = tuple(ax for ax in _axes(axes) if self._extent(ax)[0] > 1)
        if axes == tuple(ax for ax in AXES if self._extent(ax)[0] > 1):
            return None
        return self.groups[axes]

    def all_reduce(self, x: torch.Tensor, axes: Union[str, Sequence[str]],
                   op: str = "sum") -> torch.Tensor:
        """``x`` reduced (``"sum"``, ``"max"`` or ``"min"``) over the ranks
        that differ along ``axes``: the reference's ``psum`` / ``pmax``.
        Returns a new tensor; ``x`` is left as it was.  Over an axis of one
        rank it is ``x`` itself."""
        if self.axis_size(axes) == 1:
            return x
        return self._reduce_(
            x.detach().clone(memory_format=torch.contiguous_format), axes, op)

    def _reduce_(self, y: torch.Tensor, axes, op: str = "sum"
                 ) -> torch.Tensor:
        """:meth:`all_reduce` in place on ``y``, a contiguous buffer of the
        caller's own."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(y, op=red, group=self._group(axes))
        _COLLECTIVES["all_reduce"] += 1
        _COLLECTIVES["bytes"] += y.numel() * y.element_size()
        return y

    def all_to_all(self, x: torch.Tensor,
                   axis: Union[str, Sequence[str]]) -> torch.Tensor:
        """The reference's ``all_to_all(x, axis, split_axis=0,
        concat_axis=0, tiled=True)``: ``x`` split into ``n`` equal parts
        along dim 0 (``n`` the ranks along ``axis``), part ``g`` sent to the
        g-th of them, and the parts received concatenated along dim 0 in
        the senders' order.  Returns a new tensor; over an axis of one rank
        it is ``x`` itself.  Under autograd the gradient goes back through
        the same exchange (a permutation that is its own inverse, so its
        own transpose), counted like the forward's.

        Under ``nccl`` it is ``all_to_all_single`` on the device.  gloo
        takes no ``all_to_all`` on CUDA tensors, so under ``gloo`` a CUDA
        tensor is copied to the host, exchanged there, and the result
        copied back: the backend the caller initialized decides it."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"all_to_all over {axis!r} splits dim 0 into "
                             f"{n} parts; it has {x.shape[0]} rows")
        group = self._group(_axes(axis))
        staged = x.is_cuda and dist.get_backend(group) == "gloo"
        return _AllToAll.apply(x, group, staged)

    def barrier(self) -> None:
        """Wait for every rank (an ``all_reduce`` of one int, on the
        device, so that it also orders against the ranks' queued work)."""
        self.all_reduce(torch.zeros((1,), dtype=torch.int64,
                                    device=self.device), AXES)

    def agree(self, value: int) -> bool:
        """True when every rank passed the same integer."""
        if self.size == 1:
            return True
        x = torch.tensor([int(value), -int(value)], dtype=torch.int64,
                         device=self.device)
        hi = self.all_reduce(x, AXES, op="max").tolist()
        return hi[0] == -hi[1]

    # -- factor blocks --------------------------------------------------------

    def row_block(self, n: int) -> slice:
        """The rows of an (n, k) factor sharded over ``("pod", "data")``
        (over ``"data"`` with one pod) that this rank holds: block ``p *
        rows + i`` of ``pods * rows``."""
        return self.block(n, ROW_AXES)

    def col_block(self, m: int) -> slice:
        """The rows of an (m, k) factor sharded over ``"model"``."""
        return self.block(m, ("model",))

    def gather(self, x: torch.Tensor, total: int,
               axis: Union[str, Sequence[str]], dim: int = 0
               ) -> torch.Tensor:
        """The whole tensor, ``total`` long along ``dim``, from this rank's
        block of it (:meth:`block` over ``axis``), on every rank: the block
        written into a zero-filled buffer, then summed over the axis in
        place (only ``all_reduce``; a sum with zeros is exact)."""
        if self.axis_size(axis) == 1:
            return x
        shape = list(x.shape)
        shape[dim] = total
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out[(slice(None),) * (dim % x.dim()) + (self.block(total, axis),)] = x
        # summed in place: the whole tensor is allocated once
        return self._reduce_(out, axis)


def _exchange(x: torch.Tensor, group, staged: bool) -> torch.Tensor:
    """One tiled exchange of ``x`` over ``group``, through the host when
    ``staged``; counted."""
    y = x.detach().contiguous()
    src = y.cpu() if staged else y
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _ALL_TO_ALL["calls"] += 1
    _ALL_TO_ALL["bytes"] += y.numel() * y.element_size()
    return out.to(x.device) if staged else out


class _AllToAll(torch.autograd.Function):
    """``NMFMesh.all_to_all`` forward and backward (the same exchange)."""

    @staticmethod
    def forward(ctx, x, group, staged):
        ctx.group, ctx.staged = group, staged
        return _exchange(x, group, staged)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.staged), None, None


def _check_shape(rows: int, cols: int, pods: int = 1) -> Tuple[int, int, int]:
    rows, cols, pods = int(rows), int(cols), int(pods)
    if rows <= 0 or cols <= 0 or pods <= 0:
        shape = (rows, cols) if pods == 1 else (pods, rows, cols)
        raise ValueError(f"mesh_shape {shape} must be positive")
    return rows, cols, pods


def _shape_name(rows: int, cols: int, pods: int) -> tuple:
    return (rows, cols) if pods == 1 else (pods, rows, cols)


#: one set of groups per (pods, rows, cols) and world: ``dist.new_group`` is
#: a collective call, so every rank builds the groups once, in one order
_MESHES: Dict[tuple, NMFMesh] = {}

#: the axis sets of the grid's groups, in the order they are made, each with
#: the axes its members share; a grid of one pod makes the first two: every
#: column, then every row
_GROUPS = ((("data",), ("pod", "model")),
           (("model",), ("pod", "data")),
           (("pod",), ("data", "model")),
           (("pod", "data"), ("model",)),
           (("data", "model"), ("pod",)),
           (("pod", "model"), ("data",)))


def make_nmf_mesh(rows: int, cols: int, device: DeviceLike = None,
                  pods: int = 1) -> NMFMesh:
    """This process's :class:`NMFMesh` on a ``pods x rows x cols`` grid.

    With a process group initialized its world size must be ``pods * rows
    * cols`` (else ``ValueError``, the reference's message).  The first
    call for a grid is collective: every rank must make it, with the same
    shape (checked by an ``all_reduce``), and the groups of every axis set
    are created then, by every rank, in one loop and one order
    (``dist.new_group`` is collective; a rank that skipped one would hang
    the grid).  One pod makes the groups of a 2-D grid: every column, then
    every row.  Later calls return the same mesh and issue no collective,
    so they are safe from any thread.  Without a process group only 1x1 is
    possible.  ``device`` is where this rank's blocks live (the card unless
    ``"cpu"`` is asked for)."""
    rows, cols, pods = _check_shape(rows, cols, pods)
    shape_name = _shape_name(rows, cols, pods)
    world_want = pods * rows * cols
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if world_want != 1:
            raise ValueError(
                f"mesh_shape {shape_name} needs {world_want} devices, "
                "have 1 (no torch.distributed process group is initialized;"
                " start the ranks with torch.distributed.run or spawn_mesh)")
        return NMFMesh(1, 1, 0, device)
    world = dist.get_world_size()
    if world != world_want:
        raise ValueError(
            f"mesh_shape {shape_name} needs {world_want} devices, have "
            f"{world}")
    key = (pods, rows, cols, id(dist.group.WORLD), str(device))
    mesh = _MESHES.get(key)
    if mesh is not None:
        return mesh
    # every rank names the same grid (checked before any group is made:
    # ranks that disagree would call new_group with different members),
    # and the transport works.  The pods ride above bit 32 of the rows, so
    # a 2-D grid's check is the one it always was
    code = rows + ((pods - 1) << 32)
    # a meta grid (the dry-run's) checks on the host: meta holds no values
    shape = torch.tensor([code, cols, -code, -cols], dtype=torch.int64,
                         device="cpu" if device.type == "meta" else device)
    dist.all_reduce(shape, op=dist.ReduceOp.MAX)
    _COLLECTIVES["all_reduce"] += 1
    _COLLECTIVES["bytes"] += 32
    got = shape.tolist()
    if got[0] != -got[2] or got[1] != -got[3]:
        hi, lo = got[0], -got[2]
        raise ValueError(
            f"the ranks disagree on mesh_shape: this rank has {shape_name}"
            f", the grid has pods in [{(lo >> 32) + 1}, {(hi >> 32) + 1}], "
            f"rows in [{lo & 0xFFFFFFFF}, {hi & 0xFFFFFFFF}] and cols in "
            f"[{-got[3]}, {got[1]}]")
    rank = dist.get_rank()
    coords = {"pod": rank // (rows * cols), "data": (rank // cols) % rows,
              "model": rank % cols}
    extent = {"pod": pods, "data": rows, "model": cols}

    def rank_of(c):
        return (c["pod"] * rows + c["data"]) * cols + c["model"]

    def made(varies, shared):
        """Every group of the ranks that differ along ``varies`` (one for
        each value of the ``shared`` coordinates, in row-major order),
        made by every rank; returns this rank's."""
        mine = None
        for fixed in itertools.product(*(range(extent[a]) for a in shared)):
            c = dict(zip(shared, fixed))
            members = [rank_of({**c, **dict(zip(varies, v))})
                       for v in itertools.product(
                           *(range(extent[a]) for a in varies))]
            g = dist.new_group(sorted(members))
            if all(coords[a] == c[a] for a in shared):
                mine = g
        return mine

    groups = {varies: made(varies, shared)
              for varies, shared in (_GROUPS if pods > 1 else _GROUPS[:2])}
    mesh = NMFMesh(rows, cols, rank, device, pods, groups)
    _MESHES[key] = mesh
    return mesh


def make_production_mesh(multi_pod: bool = False) -> NMFMesh:
    """The reference's production grid (``repro.launch.mesh.
    make_production_mesh``): 16 x 16 over ``("data", "model")``, or with
    ``multi_pod`` 2 x 16 x 16 over ``("pod", "data", "model")``, as rank
    0's :class:`NMFMesh` on the ``meta`` device.

    It is built only on the ``fake`` process group that the dry-run starts
    (``launch.dryrun.fake_world``, world 256 or 512): its collectives
    return at once and are counted as on a real grid.  Under any other
    backend it refuses, so that no launcher builds a 256-rank grid by
    mistake."""
    pods = 2 if multi_pod else 1
    world = pods * 256
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_backend() != "fake":
        raise RuntimeError(
            "make_production_mesh builds the 16x16 / 2x16x16 grid only on "
            "the dry-run's fake process group (repro_torch.launch.dryrun."
            "fake_world); a real backend would need "
            f"{world} processes")
    return make_nmf_mesh(16, 16, device="meta", pods=pods)


# ---------------------------------------------------------------------------
# Spawning a grid of ranks on one host
# ---------------------------------------------------------------------------

def make_local_mesh(data: int = 1, model: int = 1,
                    device: DeviceLike = None) -> NMFMesh:
    """The ``data x model`` grid of the train launcher (the reference's
    ``make_local_mesh``) over the process group the caller initialized:
    :func:`make_nmf_mesh` with rows over ``"data"`` and columns over
    ``"model"``; 1x1 with none."""
    return make_nmf_mesh(data, model, device=device)


#: what gloo raises when the ranks' transport fails to connect the group
#: (a pair's socket closed by its peer while the mesh is made): the one
#: failure :func:`spawn_mesh` starts a grid again for
_CONNECT_FAILED = "connectFullMesh failed"

#: grid starts :func:`spawn_mesh` makes at most
_STARTS = 3


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               device: str, threads: Optional[int], fn: Callable,
               args: tuple, results) -> None:
    """One rank: join the group, run ``fn``, report ``(rank, status,
    value)``: status True with ``fn``'s result, False with a traceback,
    or ``"connect"`` when a group's transport failed to connect (the
    world's, or a subgroup's that ``fn`` made)."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # every failure reaches the parent, then exits
        tb = traceback.format_exc()
        results.put((rank, "connect" if _CONNECT_FAILED in tb else False,
                     tb))
        raise SystemExit(1)


def _start_grid(fn: Callable, world: int, backend: str, device: str,
                init_file: str, args: tuple, timeout: float,
                threads: Optional[int]):
    """Start ``world`` ranks on the store ``init_file`` and collect them:
    ``(results by rank, failure or None, whether the failure is a group's
    transport failing to connect)``.  Every rank is stopped and
    joined, and the store removed, before it returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend,
                               f"file://{os.path.abspath(init_file)}",
                               device, threads, fn, args, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    failure, connect = None, False
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world and failure is None:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    # a last message may still be in the pipe
                    try:
                        rank, ok, val = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} without "
                                   "reporting")
                        break
                elif time.monotonic() > deadline:
                    failure = (f"ranks {sorted(set(range(world)) - set(out))}"
                               f" still running after {timeout:.0f} s")
                    break
                else:
                    continue
            if ok is True:
                out[rank] = val
            else:
                failure = f"rank {rank} failed:\n{val}"
                connect = ok == "connect"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join()
        # a file store must be new or empty when a group starts on it
        try:
            os.unlink(init_file)
        except OSError:
            pass
    return out, failure, connect


def spawn_mesh(fn: Callable, rows: int, cols: int, *, backend: str,
               device: str, init_file: Optional[str] = None,
               args: tuple = (), timeout: float = 300.0,
               threads: Optional[int] = None, pods: int = 1) -> list:
    """Run ``fn(rank, *args)`` in ``pods * rows * cols`` new processes (the
    spawn start method), each a rank of one process group, and return their
    results by rank.

    ``backend`` is the collective transport (``"gloo"`` or ``"nccl"``),
    named by the caller.  ``device`` is every rank's device (``"cpu"``, or
    a card, which each rank makes its current device: several gloo ranks
    may share one card, NCCL takes one rank a card).  The ranks meet
    through a ``file://`` store at ``init_file`` (by default a new file in
    a temporary directory; removed afterwards), not a port, so several
    grids may start at once.  ``fn`` must be importable by name and return
    something picklable (numbers, numpy arrays, CPU tensors).  ``threads``
    caps each rank's intra-op threads.

    A rank that raises, exits or is still running after ``timeout``
    seconds makes this raise ``RuntimeError`` (with the rank's traceback)
    after every other rank was stopped.  Nothing is rerun but a grid
    whose group failed to connect (gloo's ``connectFullMesh``, making the
    world's group or a subgroup): every rank, a finished one too, is
    started anew on a fresh store, up to ``_STARTS`` starts in all.  That
    is a flake of gloo's transport on one host (~2% of 2x2 grids), not a
    failure of the ranks' work."""
    rows, cols, pods = _check_shape(rows, cols, pods)
    world = pods * rows * cols
    tmpdir = None
    if init_file is None:
        tmpdir = tempfile.mkdtemp(prefix="nmf-mesh-")
        init_file = os.path.join(tmpdir, "store")
    try:
        for start in range(_STARTS):
            store = init_file if start == 0 else f"{init_file}.{start}"
            out, failure, connect = _start_grid(
                fn, world, backend, device, store, tuple(args), timeout,
                threads)
            if not connect:
                break
    finally:
        if tmpdir is not None and not os.listdir(tmpdir):
            os.rmdir(tmpdir)
    if failure is not None:
        raise RuntimeError(f"spawn_mesh "
                           f"{'x'.join(map(str, _shape_name(rows, cols, pods)))}"
                           f" ({backend}): "
                           f"{failure}")
    return [out[r] for r in range(world)]
