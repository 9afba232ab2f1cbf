"""The NMF device grid over ``torch.distributed`` (port of
``repro.launch.mesh.make_nmf_mesh``).

One process (rank) holds one (i, j) block of the ``rows x cols`` grid,
row-major as the reference's ``devices.reshape(rows, cols)``:
``(i, j) = divmod(rank, cols)``.  The reference's mesh axes become process
groups:

* ``"data"`` — the ranks of column j (they differ in i): U's and A's row
  blocks are sharded over it, and ``psum`` over it is an ``all_reduce`` on
  :attr:`NMFMesh.row_group`;
* ``"model"`` — the ranks of row i (they differ in j): V's and A's column
  blocks, :attr:`NMFMesh.col_group`.

Every reduction goes through :meth:`NMFMesh.all_reduce`, which counts its
calls and bytes (:func:`collective_counts`) and is the identity over an
axis of one rank.  A 1x1 mesh with no process group initialized has no
groups at all and runs anywhere, the reference's "1x1 runs anywhere": the
same code, no collective.  Only ``all_reduce`` is used: gloo takes no
collective on CUDA tensors but ``all_reduce`` and ``broadcast``.

The collective backend (``nccl`` or ``gloo``) is the caller's choice, made
when the process group is initialized; nothing here picks another when one
fails.  :func:`spawn_mesh` starts a grid of ranks on one host for tests and
measurements.
"""
from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["NMFMesh", "make_nmf_mesh", "spawn_mesh", "collective_counts",
           "reset_collective_counts", "AXES"]

#: the reference's axis names: U's rows shard over "data", V's over "model"
AXES = ("data", "model")

_COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "bytes": 0}


def collective_counts() -> Dict[str, int]:
    """The ``all_reduce`` calls this process issued since the last reset,
    and the bytes they reduced."""
    return dict(_COLLECTIVES)


def reset_collective_counts() -> None:
    for key in _COLLECTIVES:
        _COLLECTIVES[key] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class NMFMesh:
    """This process's place in the ``rows x cols`` grid and its groups.

    ``row_group`` / ``col_group`` are ``None`` on a 1x1 mesh without a
    process group; with one, the default group spans the grid."""

    rows: int
    cols: int
    rank: int
    device: torch.device
    row_group: Any = None
    col_group: Any = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    @property
    def size(self) -> int:
        return self.rows * self.cols

    @property
    def i(self) -> int:
        """This rank's row block (its coordinate on ``"data"``)."""
        return self.rank // self.cols

    @property
    def j(self) -> int:
        """This rank's column block (its coordinate on ``"model"``)."""
        return self.rank % self.cols

    def axis_size(self, axes: Sequence[str]) -> int:
        out = 1
        for ax in axes:
            out *= self.rows if ax == "data" else self.cols
        return out

    def _group(self, axes: Sequence[str]):
        axes = tuple(axes)
        if axes == ("data",):
            return self.row_group
        if axes == ("model",):
            return self.col_group
        if sorted(axes) == ["data", "model"]:
            return None          # the default group: the whole grid
        raise ValueError(f"unknown mesh axes {axes!r}; use a subset of "
                         f"{AXES}")

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str],
                   op: str = "sum") -> torch.Tensor:
        """``x`` reduced (``"sum"``, ``"max"`` or ``"min"``) over the ranks
        that differ along ``axes``: the reference's ``psum`` / ``pmax``.
        Returns a new tensor; ``x`` is left as it was.  Over an axis of one
        rank it is ``x`` itself."""
        for ax in axes:
            if ax not in AXES:
                raise ValueError(f"unknown mesh axis {ax!r}; use {AXES}")
        if self.axis_size(axes) == 1:
            return x
        y = x.detach().clone(memory_format=torch.contiguous_format)
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(y, op=red, group=self._group(axes))
        _COLLECTIVES["all_reduce"] += 1
        _COLLECTIVES["bytes"] += y.numel() * y.element_size()
        return y

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
        """The rows of an (n, k) factor sharded over ``"data"`` that this
        rank holds."""
        n_loc = n // self.rows
        return slice(self.i * n_loc, (self.i + 1) * n_loc)

    def col_block(self, m: int) -> slice:
        """The rows of an (m, k) factor sharded over ``"model"``."""
        m_loc = m // self.cols
        return slice(self.j * m_loc, (self.j + 1) * m_loc)

    def gather(self, x: torch.Tensor, total: int, axis: str) -> torch.Tensor:
        """The whole (total, k) factor from this rank's block of rows
        (sharded over ``axis``), on every rank: the block written into a
        zero-filled buffer, then summed over the axis (only
        ``all_reduce``; a sum with zeros is exact)."""
        if self.axis_size((axis,)) == 1:
            return x
        out = torch.zeros((total,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        sl = self.row_block(total) if axis == "data" else \
            self.col_block(total)
        out[sl] = x
        return self.all_reduce(out, (axis,))


def _check_shape(rows: int, cols: int) -> Tuple[int, int]:
    rows, cols = int(rows), int(cols)
    if rows <= 0 or cols <= 0:
        raise ValueError(f"mesh_shape {(rows, cols)} must be positive")
    return rows, cols


#: one set of groups per (rows, cols) and world: ``dist.new_group`` is a
#: collective call, so every rank builds the groups once, in one order
_MESHES: Dict[tuple, NMFMesh] = {}


def make_nmf_mesh(rows: int, cols: int, device: DeviceLike = None) -> NMFMesh:
    """This process's :class:`NMFMesh` on a ``rows x cols`` grid.

    With a process group initialized its world size must be ``rows *
    cols`` (else ``ValueError``, the reference's message).  The first call
    for a grid is collective: every rank must make it, with the same shape
    (checked by an ``all_reduce``), and the groups of every row and every
    column are created then, by every rank, in one loop and one order
    (``dist.new_group`` is collective; a rank that skipped one would hang
    the grid).  Later calls return the same mesh and issue no collective,
    so they are safe from any thread.  Without a process group only 1x1 is
    possible.  ``device`` is where this rank's blocks live (the card unless
    ``"cpu"`` is asked for)."""
    rows, cols = _check_shape(rows, cols)
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if rows * cols != 1:
            raise ValueError(
                f"mesh_shape {(rows, cols)} needs {rows * cols} devices, "
                "have 1 (no torch.distributed process group is initialized;"
                " start the ranks with torch.distributed.run or spawn_mesh)")
        return NMFMesh(1, 1, 0, device)
    world = dist.get_world_size()
    if world != rows * cols:
        raise ValueError(
            f"mesh_shape {(rows, cols)} needs {rows * cols} devices, have "
            f"{world}")
    key = (rows, cols, id(dist.group.WORLD), str(device))
    mesh = _MESHES.get(key)
    if mesh is not None:
        return mesh
    # every rank names the same grid (checked before any group is made:
    # ranks that disagree would call new_group with different members),
    # and the transport works
    shape = torch.tensor([rows, cols, -rows, -cols], dtype=torch.int64,
                         device=device)
    dist.all_reduce(shape, op=dist.ReduceOp.MAX)
    _COLLECTIVES["all_reduce"] += 1
    _COLLECTIVES["bytes"] += 32
    got = shape.tolist()
    if got[0] != -got[2] or got[1] != -got[3]:
        raise ValueError(
            f"the ranks disagree on mesh_shape: this rank has {(rows, cols)}"
            f", the grid has rows in [{-got[2]}, {got[0]}] and cols in "
            f"[{-got[3]}, {got[1]}]")
    rank = dist.get_rank()
    i, j = divmod(rank, cols)
    row_group = col_group = None
    # every rank creates every group, columns first, then rows
    for jj in range(cols):
        g = dist.new_group([ii * cols + jj for ii in range(rows)])
        if jj == j:
            row_group = g
    for ii in range(rows):
        g = dist.new_group([ii * cols + jj for jj in range(cols)])
        if ii == i:
            col_group = g
    mesh = NMFMesh(rows, cols, rank, device, row_group, col_group)
    _MESHES[key] = mesh
    return mesh


# ---------------------------------------------------------------------------
# Spawning a grid of ranks on one host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, backend: str, init_method: str,
               device: str, threads: Optional[int], fn: Callable,
               args: tuple, results) -> None:
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
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn_mesh(fn: Callable, rows: int, cols: int, *, backend: str,
               device: str, init_file: Optional[str] = None,
               args: tuple = (), timeout: float = 300.0,
               threads: Optional[int] = None) -> list:
    """Run ``fn(rank, *args)`` in ``rows * cols`` new processes (the spawn
    start method), each a rank of one process group, and return their
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
    after every other rank was stopped; nothing is rerun."""
    rows, cols = _check_shape(rows, cols)
    world = rows * cols
    ctx = torch.multiprocessing.get_context("spawn")
    tmpdir = None
    if init_file is None:
        tmpdir = tempfile.mkdtemp(prefix="nmf-mesh-")
        init_file = os.path.join(tmpdir, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend,
                               f"file://{os.path.abspath(init_file)}",
                               device, threads, fn, tuple(args),
                               results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    failure = None
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
            if ok:
                out[rank] = val
            else:
                failure = f"rank {rank} failed:\n{val}"
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
        if tmpdir is not None and not os.listdir(tmpdir):
            os.rmdir(tmpdir)
    if failure is not None:
        raise RuntimeError(f"spawn_mesh {rows}x{cols} ({backend}): "
                           f"{failure}")
    return [out[r] for r in range(world)]
