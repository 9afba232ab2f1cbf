"""NMF command line of the port (port of ``repro.launch.nmf_run``'s
``main``): a fit of a paper-sized synthetic corpus through the estimator,
on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.nmf_run --config pubmed \\
        --backend cuda-bsr --t-u 2011 --t-v 751
    PYTHONPATH=src python -m repro_torch.launch.nmf_run --config reuters \\
        --small --solver sequential --sparsity "t_u=55,t_v=2000"

Streaming (the online engine; ``--corpus-dir`` streams a ``write_corpus``
directory, spilling the synthetic corpus there first if it holds none):

    PYTHONPATH=src python -m repro_torch.launch.nmf_run --config reuters \\
        --small --stream --chunk-docs 64

A mesh (``--solver distributed``, or ``--stream`` on a grid) runs as one
process a rank under ``torch.distributed.run``, the collective transport
named by ``--dist-backend`` (``nccl``, one card a rank; ``gloo``, which
also lets several ranks share one card, or runs on the CPU):

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.nmf_run --solver distributed \
        --backend cuda-bsr --mesh 2x2 --dist-backend gloo --small

Every rank builds the same corpus and fits its block; only rank 0 prints.

A run with ``--checkpoint-dir D`` snapshots every ``--checkpoint-every``
iterations (chunks, blocks); a killed run restarted with ``--resume``
continues from the newest snapshot (on a mesh: on any mesh shape).

The pod-scale dry-run of the distributed fit (:func:`nmf_dryrun_cell`,
the paper's "large" workload on 256 / 512 ranks) runs on the ``meta``
device, with no card:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --nmf [--multi-pod]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import torch

from repro_torch.configs import NMF_CONFIGS


def nmf_input_specs(n: int, m: int, k: int, cap: int, cap_t: int,
                    r: int, c: int):
    """Shapes and dtypes of the distributed factorization's inputs, the
    reference's (``repro.launch.nmf_run.nmf_input_specs``): the padded-CSR
    blocks of the ``r x c`` grid in both orientations (values, column ids)
    and the whole ``u0``; a rank holds block (i, j) of the first four and
    its rows of ``u0``."""
    from repro_torch.models.api import TensorSpec

    f32, i32 = torch.float32, torch.int32
    n_loc, m_loc = n // r, m // c
    return (
        TensorSpec((r, c, n_loc, cap), f32),      # values
        TensorSpec((r, c, n_loc, cap), i32),      # cols
        TensorSpec((r, c, m_loc, cap_t), f32),    # values_t
        TensorSpec((r, c, m_loc, cap_t), i32),    # cols_t
        TensorSpec((n, k), f32),                  # u0
    )


def nmf_dryrun_cell(mesh, *, n: int = 4_000_000, m: int = 1_000_000,
                    k: int = 256, nnz_per_row: int = 256, iters: int = 20,
                    t_frac: float = 0.02) -> Dict:
    """Rank 0's part of the paper's Alg. 2 at production scale on ``mesh``
    (an ``NMFMesh`` of the dry-run's fake world, ``launch.dryrun``), run
    on the ``meta`` device under a ``launch.cost_analysis.CostMode``: the
    engine ``solver="distributed"`` executes (``make_sharded_als`` with
    ``DistTopK`` on both factors, no error trace, its default inner
    backend ``torch-csr``, the reference's padded-CSR leaves), on this
    rank's block.  The reference's ``nmf_dryrun_cell`` lowers the same
    engine through XLA.

    Capacity sizing is the reference's: row nonzeros spread over C column
    blocks with 2x skew margin; the transpose orientation likewise (column
    nonzeros ``n * nnz_per_row / m``)."""
    from repro_torch.backend.sharded import make_sharded_als
    from repro_torch.core.distributed import DistCSR
    from repro_torch.core.topk import DistTopK
    from repro_torch.launch.cost_analysis import CostMode, tree_bytes
    from repro_torch.sparse.csr import SpCSR

    t0 = time.perf_counter()
    rows_axes = ("pod", "data") if mesh.pods > 1 else ("data",)
    r, c = mesh.axis_size(rows_axes), mesh.axis_size("model")
    cap = max(2 * nnz_per_row // c, 4)
    col_nnz = n * nnz_per_row // m
    cap_t = max(2 * col_nnz // r, 4)
    t_u = int(n * k * t_frac)
    t_v = int(m * k * t_frac)
    run = make_sharded_als(
        mesh, rows_axes, "model",
        sparsify_u=DistTopK(t_u, mesh, rows_axes),
        sparsify_v=DistTopK(t_v, mesh, ("model",)),
        track_error=False)
    values, cols, values_t, cols_t, u0 = nmf_input_specs(n, m, k, cap, cap_t,
                                                         r, c)

    def block(spec):
        return torch.empty(spec.shape[2:], dtype=spec.dtype, device="meta")

    n_loc, m_loc = n // r, m // c
    dist_block = DistCSR(
        fwd=SpCSR(block(values), block(cols), (n_loc, m_loc)),
        tsp=SpCSR(block(values_t), block(cols_t), (m_loc, n_loc)),
        shape=(n, m), grid=(r, c), index=(mesh.index(rows_axes),
                                          mesh.index("model")))
    u0_rows = torch.empty((n_loc, k), dtype=u0.dtype, device="meta")
    mode = CostMode()
    with mode:
        args = mode.track(dist_block.fwd.values, dist_block.fwd.cols,
                          dist_block.tsp.values, dist_block.tsp.cols, u0_rows)
        res = run(dist_block, u0_rows, iters)
        out = tree_bytes(tuple(res))
    costs = mode.costs
    rec = {
        "arch": "nmf-large-synthetic",
        "shape": f"n{n}_m{m}_k{k}_iters{iters}",
        "mesh": "x".join(map(str, mesh.shape)),
        "status": "ok",
        "flops": costs.flops,
        "bytes_accessed": costs.hbm_bytes,
        "argument_bytes": args,
        "temp_bytes": max(mode.peak_bytes - args - out, 0),
        "output_bytes": out,
        "alias_bytes": 0,
        "bytes_per_device": mode.peak_bytes,
        "collectives": costs.collectives(),
        "launches": dict(costs.launches),
        "wall_s": round(time.perf_counter() - t0, 2),
    }
    return rec


def main(argv=None):
    from repro_torch.nmf import available_solvers

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="reuters",
                    choices=list(NMF_CONFIGS.keys()))
    ap.add_argument("--solver", default="enforced",
                    choices=available_solvers())
    ap.add_argument("--sparsity", default=None,
                    help="Sparsity spec, e.g. 't_u=5000,t_v=2000,mode=exact' "
                         "or 'frac_u=0.02' (overrides --t-u/--t-v)")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--t-u", type=int, default=None)
    ap.add_argument("--t-v", type=int, default=None)
    ap.add_argument("--tol", type=float, default=0.0,
                    help="early-stop tolerance on the relative residual")
    ap.add_argument("--backend", default=None,
                    help="matmul backend of the ALS hot path (cuda-bsr / "
                         "cuda-bsr-unfused / torch-csr / torch-dense; "
                         "default: by input)")
    ap.add_argument("--stream", action="store_true",
                    help="stream the corpus through the online engine in "
                         "document chunks (implies --solver streaming)")
    ap.add_argument("--chunk-docs", type=int, default=None,
                    help="documents per streaming chunk (default: 8 chunks)")
    ap.add_argument("--corpus-dir", default=None, metavar="PATH",
                    help="stream an out-of-core corpus from this "
                         "write_corpus directory (implies --solver "
                         "streaming); if PATH holds no corpus yet, the "
                         "synthetic corpus is spilled there first")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="pack chunks inline instead of on the prefetch "
                         "worker (the results are bitwise the same)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="chunks the prefetcher packs ahead of the online "
                         "step")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="rank grid of the distributed solver and of "
                         "streaming on a mesh (default 1x1); more than one "
                         "rank runs under python -m torch.distributed.run")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="collective transport of a mesh run: nccl (one "
                         "card a rank) or gloo (ranks may share a card, or "
                         "run on the CPU)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="PATH",
                    help="periodic atomic fit snapshots land here; a "
                         "killed run restarted with --resume continues from "
                         "the newest one")
    ap.add_argument("--checkpoint-every", type=int, default=10,
                    help="snapshot cadence: iterations (als / enforced), "
                         "chunks (streaming) or blocks (sequential)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest snapshot in "
                         "--checkpoint-dir (fingerprint-checked)")
    ap.add_argument("--small", action="store_true", help="1/8 scale")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume needs --checkpoint-dir")
    mesh = (1, 1)
    if args.mesh:
        try:
            mesh = tuple(int(x) for x in args.mesh.lower().split("x"))
            if len(mesh) != 2:
                raise ValueError
        except ValueError:
            ap.error(f"--mesh {args.mesh}: expected RxC, e.g. 2x2")

    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.device import resolve_device
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity

    device = resolve_device(args.device)
    rank = _init_ranks(args, mesh, device)
    if rank is not None and device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = resolve_device(f"cuda:{local % torch.cuda.device_count()}")
        torch.cuda.set_device(device)
    say = print if not rank else (lambda *a, **k: None)
    solver = ("streaming" if args.stream or args.corpus_dir
              else args.solver)
    cfg = dict(NMF_CONFIGS[args.config])
    n, m, k = cfg["n_terms"], cfg["n_docs"], cfg["k"]
    iters = args.iters or cfg.get("iters", 50)
    if args.small:
        n, m = n // 8, m // 8
    chunk_docs = args.chunk_docs
    if mesh != (1, 1):
        # the mesh engines shard whole row and column blocks: trim the
        # synthetic corpus to sizes the grid divides (streaming chunks need
        # no alignment; ragged widths pad with empty documents)
        r, c = mesh
        n = max(n - n % r, r)
        m = max(m - m % c, c)
    if args.sparsity is not None:
        sparsity = Sparsity.parse(args.sparsity)
    else:
        sparsity = Sparsity(t_u=args.t_u, t_v=args.t_v)

    if args.corpus_dir is not None:
        from pathlib import Path

        from repro_torch.data.corpus import open_corpus, write_corpus

        if not rank and not (Path(args.corpus_dir) / "meta.json").exists():
            say(f"spilling {n}x{m} synthetic corpus to "
                f"{args.corpus_dir} ...", flush=True)
            a_res, _ = synthetic_journal_corpus(
                n_terms=n, n_docs=m, n_journals=cfg.get("n_journals", 5))
            write_corpus(a_res, args.corpus_dir, chunk_docs=chunk_docs)
            del a_res  # the fit streams it back memory-mapped
        if rank is not None:   # rank 0 spilled it; the others wait
            from repro_torch.launch.mesh import make_nmf_mesh

            make_nmf_mesh(*mesh, device=device).barrier()
        a = open_corpus(args.corpus_dir)
        n, m = a.shape
        chunk_docs = a.chunk_docs
        say(f"streaming {n}x{m} corpus from {args.corpus_dir} "
            f"({len(a)} mmap shards, chunk_docs={chunk_docs}, "
            f"prefetch={'off' if args.no_prefetch else 'on'})",
            flush=True)
    else:
        say(f"building {n}x{m} synthetic corpus ...", flush=True)
        a, _ = synthetic_journal_corpus(
            n_terms=n, n_docs=m, n_journals=cfg.get("n_journals", 5))
    model = EnforcedNMF(NMFConfig(
        k=k, iters=iters, sparsity=sparsity, solver=solver,
        tol=args.tol, backend=args.backend, chunk_docs=chunk_docs,
        mesh_shape=mesh,
        prefetch=not args.no_prefetch, prefetch_depth=args.prefetch_depth,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume),
        device=device)
    t0 = time.time()
    model.fit(a)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    res = model.result_
    stop = " (early stop)" if res.converged else ""
    unit = "chunks" if res.error_granularity == "chunk" else "iterations"
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU")
    if rank is not None:
        where += (f", mesh {mesh[0]}x{mesh[1]} over "
                  f"{torch.distributed.get_backend()}")
    say(f"solver={solver}: {model.n_iter_} {unit}{stop} in "
        f"{dt:.1f}s on {where}; "
        f"final error {res.final_error:.6f}, "
        f"residual {res.final_residual:.2e}, "
        f"NNZ(U)={res.final_nnz_u}, NNZ(V)={res.final_nnz_v}, "
        f"max stored NNZ={int(res.max_nnz)}")
    if solver == "streaming":
        from repro_torch.nmf import default_chunk_docs

        # documents processed: tol can stop the stream mid-corpus
        w = chunk_docs or default_chunk_docs(m)
        streamed = min(res.n_iter * w, m)
        say(f"streamed {streamed} docs in {res.n_iter} chunks "
            f"({streamed / max(dt, 1e-9):.0f} docs/s)")
    if rank is not None:
        torch.distributed.destroy_process_group()


def _init_ranks(args, mesh, device):
    """This process's rank, joining the process group that
    ``torch.distributed.run`` describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) over
    ``--dist-backend``; ``None`` for a single process.  Nothing chooses
    another transport when this one fails."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and mesh == (1, 1):
        return None
    if "RANK" not in os.environ:
        raise SystemExit(
            f"--mesh {mesh[0]}x{mesh[1]} needs {mesh[0] * mesh[1]} ranks: "
            "start them with python -m torch.distributed.run "
            f"--nproc-per-node {mesh[0] * mesh[1]}")
    import torch.distributed as dist

    if args.dist_backend == "nccl" and device.type != "cuda":
        raise SystemExit("--dist-backend nccl needs the card; use gloo with "
                         "--device cpu")
    dist.init_process_group(args.dist_backend, init_method="env://")
    return dist.get_rank()


if __name__ == "__main__":
    main()
