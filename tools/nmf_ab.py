#!/usr/bin/env python3
"""Time the PubMed NMF iteration and its BSR kernels on one card, with the
port found under ``--src`` (a checkout's ``src``; this checkout's by
default), so that two checkouts can be compared in turns on the same card:

    python3 tools/nmf_ab.py --src /path/to/other/src --label parent

Prints one JSON line: the card's name and power limit, the 50-iteration
``cuda-bsr`` fit of the synthetic PubMed corpus (k = 5) in ms an iteration
(host clock on the ingested operand, median of ``--fits``), and
``bsr_spmm`` / ``bsr_spmm_gram`` in ms a call (CUDA events, mean of the
A @ V and A^T @ U calls).  Exits 2 without a CUDA device.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--fits", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("nmf_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.backend import get_backend
    from repro_torch.core.nmf import init_u0
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.fused import bsr_spmm_gram
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
    from repro_torch.sparse import to_scipy

    n, m, k, iters = 20112, 7510, 5, 50
    a = to_scipy(synthetic_journal_corpus(n_terms=n, n_docs=m,
                                          n_journals=5)[0])
    dev = torch.device("cuda")
    op = get_backend("cuda-bsr").prepare(a, device=dev)
    gen = torch.Generator().manual_seed(0)
    u0 = init_u0(gen, n, k, device=dev)
    cfg = NMFConfig(k=k, iters=iters, backend="cuda-bsr",
                    sparsity=Sparsity(t_u=n * k // 50, t_v=m * k // 50))
    EnforcedNMF(cfg, device=dev).fit(op, u0=u0)  # warm: builds, caches
    walls = []
    for _ in range(args.fits):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = EnforcedNMF(cfg, device=dev).fit(op, u0=u0)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0) / iters)

    def events_ms(fn, reps=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    pairs = ((op.bsr, model.v_), (op.bsr_t, model.u_))
    kern = {name: float(np.mean([events_ms(lambda: fn(b, w))
                                 for b, w in pairs]))
            for name, fn in (("bsr_spmm", bsr_spmm),
                             ("bsr_spmm_gram", bsr_spmm_gram))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps(dict(label=args.label, card=smi,
                          fit_ms_per_iter=float(np.median(walls)),
                          fit_ms_per_iter_all=walls,
                          final_error=float(model.result_.final_error),
                          **kern)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
