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
continues from the newest snapshot (on a mesh: on any mesh shape).  The
reference's ``nmf_input_specs`` and ``nmf_dryrun_cell`` lower through XLA
and have no counterpart.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import NMF_CONFIGS


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
