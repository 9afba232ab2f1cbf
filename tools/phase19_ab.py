#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 19 (the NMF mesh engines on gloo and NCCL
ranks sharing one card) alone, with the ``chip_smoke.py`` and ``src`` of
the checkout at ``ROOT``, so that two checkouts can be timed in turns on
the same card:

    python3 tools/phase19_ab.py /path/to/parent && python3 tools/phase19_ab.py .

It builds the kernels, makes the synthetic PubMed corpus, runs phase 3's
fit (the traces phase 19 is held against) and then ``run_mesh_slice``,
timed on the host clock.  Prints one line: ``PHASE19``, the checkout, the
phase's seconds and each grid's.  Exits 2 without a CUDA device.
"""
import sys
import time
from pathlib import Path

root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
sys.path.insert(0, str(root))
sys.path.insert(0, str(root / "src"))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("phase19_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.core.nmf import init_u0
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.device import configure_numerics
    from repro_torch.kernels import _build
    from repro_torch.kernels.autotune import (
        BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S,
    )
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
    from repro_torch.sparse import to_scipy

    cs.HBM_BYTES_PER_S, cs.BF16_FLOPS, cs.F32_FLOPS = (
        HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS)
    configure_numerics()
    _build.build_all()
    corpus, _ = synthetic_journal_corpus(n_terms=cs.N_TERMS,
                                         n_docs=cs.N_DOCS, n_journals=5)
    a_sp = to_scipy(corpus)
    gen = torch.Generator().manual_seed(0)
    u0 = init_u0(gen, cs.N_TERMS, cs.K, device="cuda")
    cfg = NMFConfig(k=cs.K, iters=cs.ITERS,
                    sparsity=Sparsity(t_u=cs.T_U, t_v=cs.T_V),
                    backend="cuda-bsr")
    res3 = EnforcedNMF(cfg, device="cuda").fit(a_sp, u0=u0).result_
    results, paths = {"phases": {}}, {}
    t0 = time.perf_counter()
    cs.run_mesh_slice(a_sp, res3, u0, paths, results)
    mesh = results["phases"]["mesh"]
    print("PHASE19", root, round(time.perf_counter() - t0, 1),
          {k: round(v["seconds"], 1) for k, v in mesh.items()
           if isinstance(v, dict) and "seconds" in v}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
