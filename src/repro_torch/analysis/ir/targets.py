"""The entry-point catalog the IR passes run over (port of
``repro.analysis.ir.targets``).

Every (solver, backend) pair of the port's registries appears here,
either as an :class:`~repro_torch.analysis.ir.framework.IRTarget` run on
the ``meta`` device or as an entry of :data:`UNSUPPORTED_PAIRS` naming why
the registry rejects the combination.  The reference's backend names map
to the port's registry names (:data:`ALIASES`: ``jnp-dense`` ->
``torch-dense``, ``jnp-csr`` -> ``torch-csr``, ``pallas-bsr`` ->
``cuda-bsr``), and the port's own ``cuda-bsr-unfused`` adds the engine
targets that run ``gram`` and ``bsr_spmm`` as separate launches.  Grid
targets run the real engines of ``backend/sharded.py``
(``make_sharded_als``, ``make_sharded_online``) as rank 0 of 2x2 and 4x1
grids on a process group of 4 ranks (the CLI's ``fake`` group); kernel
targets call each kernel wrapper, whose meta branch records its launch
and runs its legality checks.

Shapes are canonical and committed (:data:`CANON`, the reference's): the
peaks go into the budget ledger, so a run must be byte-for-byte the same
on any machine.  Every backend runs the same matrix A (n x m, ``cap``
entries a row), built on the host from its own formula
(:func:`canon_matrix`) and ingested as each backend ingests it, then
moved to ``meta``; :func:`canon_operand` builds it on any device, which is
how ``chip_smoke.py`` holds a target's peak on the card against its peak
here.  Every legitimate result of a sparse backend stays under
``blowup_multiplier`` times the operand's bytes, and a dense (n, m) one
far above it.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.analysis.ir.framework import IRTarget

__all__ = ["CANON", "ALIASES", "UNSUPPORTED_PAIRS", "MESH_SHAPES",
           "default_targets", "canon_matrix", "canon_operand", "canon_u0",
           "engine_fn", "to_reference_name"]

#: canonical shapes, the reference's (``repro/analysis/ir/targets.py``):
#: part of the budget ledger's identity, a change is a deliberate
#: re-baseline (--ir --update-budgets)
CANON = dict(
    n=512, m=384, k=4, cap=8, iters=3,
    bm=128, bk=128, bcap=3,
    t_u=1024, t_v=768,
    blowup_multiplier=4.0,
)

MESH_SHAPES: List[Tuple[int, int]] = [(2, 2), (4, 1)]

#: the reference's backend names -> the port's registry names
ALIASES = {"jnp-dense": "torch-dense", "jnp-csr": "torch-csr",
           "pallas-bsr": "cuda-bsr"}

#: (solver, backend) pairs the registries reject by design (the
#: reference's three under the port's names)
UNSUPPORTED_PAIRS = {
    "sequential[cuda-bsr]":
        "solver registry rejects it: Algorithm 3's rank-k2 block updates "
        "have no BSR operand path",
    "distributed[torch-dense]":
        "grid execution requires a sharded operand format; torch-dense has "
        "no shard format (see backend.sharded.SHARD_FORMATS)",
    "streaming[mesh,torch-dense]":
        "same constraint as distributed[torch-dense]: no dense shard format",
}

LOCAL_BACKENDS = ("torch-dense", "torch-csr", "cuda-bsr", "cuda-bsr-unfused")
MESH_INNER = ("torch-csr", "cuda-bsr")


def to_reference_name(name: str) -> str:
    """A target name with the port's backend names put back to the
    reference's (``als[cuda-bsr]`` -> ``als[pallas-bsr]``)."""
    for ref, port in ALIASES.items():
        name = name.replace(f"{port}]", f"{ref}]")
    return name


# ---------------------------------------------------------------------------
# The canonical operand
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def canon_matrix():
    """A (CSR, scipy) n x m with exactly ``cap`` entries in every row: row
    i holds columns ``(7 i + 48 j) mod m`` for j < cap, every column block
    of every row-block occupied, values in (1, 2]."""
    import scipy.sparse as sp

    c = CANON
    n, m, cap = c["n"], c["m"], c["cap"]
    rows = np.repeat(np.arange(n), cap)
    cols = (7 * rows + (m // cap) * np.tile(np.arange(cap), n)) % m
    vals = 1.0 + ((rows * cap + np.tile(np.arange(cap), n)) % 13) / 13.0
    return sp.csr_matrix((vals.astype(np.float32), (rows, cols)),
                         shape=(n, m))


def canon_operand(backend: str, device="meta", chunk: bool = False):
    """The canonical A ingested by ``backend`` on ``device``: a dense
    tensor, an ``SpCSR`` of ``cap`` slots a row, or a ``BSROperand`` of
    128 x 128 tiles; with ``chunk``, the first ``m / 8`` documents at 4
    slots a row (one streamed corpus chunk, padded to a shared cap)."""
    a = canon_matrix()
    if chunk:
        from repro_torch.sparse.csr import from_scipy

        return from_scipy(a[:, :CANON["m"] // 8], cap=4).to(device)
    if backend == "torch-dense":
        if torch.device(device).type == "meta":
            return torch.empty(a.shape, dtype=torch.float32, device="meta")
        return torch.from_numpy(a.toarray()).to(device)
    if backend == "torch-csr":
        from repro_torch.sparse.csr import from_scipy

        return from_scipy(a, cap=CANON["cap"]).to(device)
    from repro_torch.kernels.bsr import bsr_operand

    return bsr_operand(a, bm=CANON["bm"], bk=CANON["bk"], device="cpu"
                       ).to(device)


def canon_u0(rows: int = None, k: int = None, device="meta"):
    """An initial factor (rows x k, n x k by default): empty on meta,
    uniform in [0, 1) from seed 0 elsewhere."""
    shape = (CANON["n"] if rows is None else rows,
             CANON["k"] if k is None else k)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    gen = torch.Generator().manual_seed(0)
    return torch.rand(shape, generator=gen).to(device)


def _sparsifiers(backend: str, c: dict):
    """The epilogue sparsifiers the local solver layer builds for
    ``backend`` (``nmf/solvers.py``): the fused relu + top-t where the
    backend owns its epilogue, the bisection top-t otherwise."""
    from repro_torch.backend import get_backend
    from repro_torch.nmf.config import Sparsity

    n, m, k = c["n"], c["m"], c["k"]
    sp = Sparsity(t_u=c["t_u"], t_v=c["t_v"])
    fused = get_backend(backend).fuse_epilogue
    return (sp.sparsifier(n, k, "u", fused=fused),
            sp.sparsifier(m, k, "v", fused=fused))


def _nbytes(tree) -> int:
    from repro_torch.launch.cost_analysis import tree_bytes

    return tree_bytes(tree)


# ---------------------------------------------------------------------------
# Local engine targets
# ---------------------------------------------------------------------------

def engine_fn(solver: str, backend: str, **sizes):
    """``fn(a, u0)`` of a local engine target: ``als`` / ``enforced``
    (``core/nmf.py::als_nmf``, ``iters`` iterations, error tracked) or
    ``streaming`` (one ``core/online.py::online_als_step`` of 2 inner
    passes from zero statistics), at :data:`CANON` but for the entries
    ``sizes`` overrides (``n``, ``m``, ``k``, ``t_u``, ``t_v``,
    ``iters``: the same target at another size)."""
    c = dict(CANON, **sizes)
    k = c["k"]
    sp_u, sp_v = (_sparsifiers(backend, c) if solver != "als"
                  else (None, None))
    if solver in ("als", "enforced"):
        from repro_torch.core.nmf import als_nmf

        def fn(a, u0):
            return als_nmf(a, u0, iters=c["iters"], sparsify_u=sp_u,
                           sparsify_v=sp_v, track_error=True,
                           backend=backend)
        return fn
    from repro_torch.core.online import OnlineStats, online_als_step

    def step(a, u):
        stats = OnlineStats(torch.zeros_like(u),
                            torch.zeros((k, k), dtype=u.dtype,
                                        device=u.device))
        return online_als_step(a, u, stats, 1.0, iters=2, sparsify_u=sp_u,
                               sparsify_v=sp_v, backend=backend)
    return step


def _local_target(solver: str, backend: str) -> IRTarget:
    name = f"{solver}[{backend}]"

    def args():
        return canon_operand(backend), canon_u0()

    return IRTarget(name=name, kind="engine", fn=engine_fn(solver, backend),
                    args=args, operand_bytes=_nbytes(canon_operand(backend)),
                    budget_key=name)


def _streaming_corpus_target() -> IRTarget:
    """The prefetch-fed per-chunk step: the online half-step the
    out-of-core stream runs, over one corpus chunk as the prefetcher
    delivers it (chunk-wide, padded to the shared per-chunk cap)."""
    name = "streaming[corpus,torch-csr]"

    def args():
        return canon_operand("torch-csr", chunk=True), canon_u0()

    return IRTarget(name=name, kind="engine",
                    fn=engine_fn("streaming", "torch-csr"), args=args,
                    operand_bytes=_nbytes(canon_operand("torch-csr",
                                                        chunk=True)),
                    budget_key=name)


def _sequential_target(backend: str) -> IRTarget:
    c = CANON
    k2, blocks = 2, 2
    name = f"sequential[{backend}]"

    def fn(a, u0):
        from repro_torch.core.sequential import sequential_als_nmf

        return sequential_als_nmf(
            a, u0, k2=k2, blocks=blocks, iters=c["iters"],
            t_u=c["t_u"] // blocks, t_v=c["t_v"] // blocks,
            track_error=True, backend=backend)

    def args():
        return canon_operand(backend), canon_u0(k=k2)

    return IRTarget(name=name, kind="engine", fn=fn, args=args,
                    operand_bytes=_nbytes(canon_operand(backend)),
                    budget_key=name)


# ---------------------------------------------------------------------------
# Grid targets: rank 0 of the real engines on a 2x2 and a 4x1 grid
# ---------------------------------------------------------------------------

def _mesh_target(rc: Tuple[int, int], inner: str, solver: str) -> IRTarget:
    c = CANON
    rows, cols = rc
    made = {}

    def engine():
        """The grid (made on first use, inside the process group) and the
        engine on it."""
        if not made:
            from repro_torch.backend.sharded import (
                make_sharded_als, make_sharded_online,
            )
            from repro_torch.core.topk import DistTopK
            from repro_torch.launch.mesh import make_nmf_mesh

            mesh = make_nmf_mesh(rows, cols, device="meta")
            sp = dict(sparsify_u=DistTopK(c["t_u"], mesh, ("data",)),
                      sparsify_v=DistTopK(c["t_v"], mesh, ("model",)))
            if solver == "distributed":
                run = make_sharded_als(mesh, ("data",), "model",
                                       track_error=True, inner=inner, **sp)
            else:
                run = make_sharded_online(mesh, ("data",), "model",
                                          inner=inner, **sp)
            made.update(mesh=mesh, run=run)
        return made

    def args():
        # the footprint is the rank's block, made inside the process group
        block = engine()["run"].distribute(canon_matrix(), device="meta")
        target.operand_bytes = _nbytes(block)
        return block, canon_u0(rows=c["n"] // rows)

    def fn(block, u):
        run = engine()["run"]
        if solver == "distributed":
            return run(block, u, c["iters"])
        from repro_torch.core.online import OnlineStats

        stats = OnlineStats(torch.zeros_like(u),
                            torch.zeros((c["k"], c["k"]), dtype=u.dtype,
                                        device=u.device))
        return run(block, u, stats, 2)

    name = f"{solver}[{rows}x{cols},{inner}]"
    target = IRTarget(name=name, kind="mesh", fn=fn, args=args,
                      requires_devices=rows * cols, budget_key=name,
                      grid=lambda: engine()["mesh"])
    return target


# ---------------------------------------------------------------------------
# Kernel targets: each wrapper's meta branch
# ---------------------------------------------------------------------------

def _kernel_targets() -> List[IRTarget]:
    from repro_torch.kernels import autotune
    from repro_torch.kernels.bsr_spmm import bsr_spmm, check_operands, \
        resolve_kb
    from repro_torch.kernels.flash_attention import check_operands as \
        flash_check
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused import bsr_spmm_gram
    from repro_torch.kernels.gram import gram
    from repro_torch.kernels.project_mask import project_mask

    c = CANON
    bsr = canon_operand("cuda-bsr").bsr
    u = canon_u0(rows=c["m"])
    out = [
        IRTarget(name="kernel:bsr_spmm", kind="kernel", fn=bsr_spmm,
                 args=lambda: (bsr, u), operand_bytes=_nbytes((bsr, u)),
                 budget_key="kernel:bsr_spmm",
                 checks=(("bsr_spmm", lambda: check_operands(bsr, u)),),
                 smem_bytes=lambda: autotune.spmm_working_set(
                     bsr.bm, bsr.bk, resolve_kb(bsr, u, None), u.shape[1],
                     u.element_size())),
        IRTarget(name="kernel:bsr_spmm_gram", kind="kernel",
                 fn=bsr_spmm_gram, args=lambda: (bsr, u),
                 operand_bytes=_nbytes((bsr, u)),
                 budget_key="kernel:bsr_spmm_gram",
                 checks=(("bsr_spmm_gram", lambda: check_operands(bsr, u)),),
                 smem_bytes=lambda: autotune.fused_working_set(
                     bsr.bm, bsr.bk, u.shape[1], u.element_size())),
    ]
    ug = canon_u0()
    out.append(IRTarget(name="kernel:gram", kind="kernel", fn=gram,
                        args=lambda: (ug,), operand_bytes=_nbytes(ug),
                        budget_key="kernel:gram"))
    tau = torch.empty((), dtype=torch.float32, device="meta")
    out.append(IRTarget(name="kernel:project_mask", kind="kernel",
                        fn=project_mask, args=lambda: (ug, tau),
                        operand_bytes=_nbytes(ug),
                        budget_key="kernel:project_mask"))
    q = torch.empty((1, 2, 512, 64), dtype=torch.float32, device="meta")
    out.append(IRTarget(
        name="kernel:flash_attention", kind="kernel",
        fn=functools.partial(flash_attention, causal=True),
        args=lambda: (q, q, q), operand_bytes=3 * _nbytes(q),
        budget_key="kernel:flash_attention",
        checks=(("flash_attention", lambda: flash_check(q, q, q, 1)),)))
    return out


def default_targets() -> List[IRTarget]:
    targets = []
    for backend in LOCAL_BACKENDS:
        for solver in ("als", "enforced", "streaming"):
            targets.append(_local_target(solver, backend))
    targets.append(_streaming_corpus_target())
    for backend in ("torch-dense", "torch-csr"):
        targets.append(_sequential_target(backend))
    for rc in MESH_SHAPES:
        for inner in MESH_INNER:
            for solver in ("distributed", "streaming"):
                targets.append(_mesh_target(rc, inner, solver))
    targets.extend(_kernel_targets())
    return targets
