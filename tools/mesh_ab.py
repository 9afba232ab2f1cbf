#!/usr/bin/env python3
"""Time the mesh engine's PubMed iteration on a grid of gloo ranks sharing
one card, with the port found under ``--src`` (a checkout's ``src``; this
checkout's by default), so that two checkouts can be compared in turns on
the same card:

    python3 tools/mesh_ab.py --src /path/to/other/src --label parent

Every rank runs ``make_sharded_als`` on ``cuda-bsr`` over its block of the
synthetic PubMed corpus (20,112 x 7,510, k = 5, t_u = 2011, t_v = 751), a
2-iteration warm-up, then ``--reps`` calls of ``--iters`` iterations (host
clock, ending in a synchronize).  Prints one JSON line: the card's name
and power limit, the grid, rank 0's ms an iteration (each call) and its
``all_reduce`` calls and bytes an iteration.  The times are gloo's host
round trips, not a multi-card exchange.  Exits 2 without a CUDA device.
"""
import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N_TERMS, N_DOCS, K = 20112, 7510, 5


def _rank(rank, data_dir, rows, cols, iters, reps):
    import numpy as np
    import scipy.sparse
    import torch

    from repro_torch.backend.sharded import make_sharded_als
    from repro_torch.core.topk import DistTopK
    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )

    dev = torch.device("cuda:0")
    a_sp = scipy.sparse.load_npz(Path(data_dir) / "a.npz")
    u0 = np.load(Path(data_dir) / "u0.npy")
    mesh = make_nmf_mesh(rows, cols, device=dev)
    engine = make_sharded_als(
        mesh, sparsify_u=DistTopK(N_TERMS * K // 50, mesh, ("data",)),
        sparsify_v=DistTopK(N_DOCS * K // 50, mesh, ("model",)),
        inner="cuda-bsr")
    dist = engine.distribute(a_sp)
    u = torch.from_numpy(u0).to(dev)[mesh.row_block(u0.shape[0])]
    engine(dist, u, 2)
    ms = []
    for _ in range(reps):
        mesh.barrier()
        torch.cuda.synchronize()
        reset_collective_counts()
        t0 = time.perf_counter()
        engine(dist, u, iters)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / iters)
    c = collective_counts()
    return dict(ms=ms, all_reduce=c["all_reduce"] / iters,
                bytes=c["bytes"] / iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--grid", default="2x2")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import scipy.sparse
    import torch

    if not torch.cuda.is_available():
        print("mesh_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.core.nmf import init_u0
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.sparse import to_scipy

    _build.build_all()          # once, before the ranks need the kernels

    rows, cols = (int(x) for x in args.grid.lower().split("x"))
    root = tempfile.mkdtemp(prefix="mesh-ab-")
    corpus, _ = synthetic_journal_corpus(n_terms=N_TERMS, n_docs=N_DOCS,
                                         n_journals=5)
    scipy.sparse.save_npz(Path(root) / "a.npz", to_scipy(corpus).tocsr())
    np.save(Path(root) / "u0.npy", init_u0(
        torch.Generator().manual_seed(0), N_TERMS, K, device="cpu").numpy())
    out = spawn_mesh(_rank, rows, cols, backend="gloo", device="cuda:0",
                     args=(root, rows, cols, args.iters, args.reps),
                     timeout=600.0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps(dict(label=args.label, card=card, grid=args.grid,
                          iters=args.iters, **out[0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
