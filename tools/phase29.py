#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 29 (the port's examples on the card) alone,
with the ``chip_smoke.py``, ``examples`` and ``src`` of the checkout at
``ROOT`` (default: this one):

    python3 tools/phase29.py [ROOT]

It starts 29(a)'s example runs as the whole script does (the LM examples
before the build, the NMF examples with it), builds the kernels, makes
the PubMed corpus and its operand (for the coverage of A's blocks), and
runs ``run_examples_slice``.  Prints one line: ``PHASE29``, the checkout,
the phase's seconds and those of its part (b).  Exits 2 without a CUDA
device.
"""
import subprocess
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
        print("phase29: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.backend import get_backend
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.device import configure_numerics
    from repro_torch.kernels import _build
    from repro_torch.sparse import to_scipy

    configure_numerics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card_name = torch.cuda.get_device_name(0)
    lm = cs.beside(cs.example_runs, cs.LM_EXAMPLES, card_name)
    for source in _build.CSRC_DIR.glob("*.cu"):
        _build._target(source).unlink(missing_ok=True)
    nmf = cs.beside(cs.example_runs, cs.NMF_EXAMPLES, card_name)
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s on {smi}")
    for run in (lm, nmf):
        run.exception()
    cs.log(f"[build] the examples ended {time.perf_counter() - t0:.1f} s "
           "after the build started")
    dev = torch.device("cuda")
    corpus, _ = synthetic_journal_corpus(n_terms=cs.N_TERMS,
                                         n_docs=cs.N_DOCS, n_journals=5)
    a_sp = to_scipy(corpus)
    op = get_backend("cuda-bsr").prepare(a_sp, device=dev)
    full_cover = (op.bsr.uncovered_rows is not None,
                  op.bsr_t.uncovered_rows is not None)
    del op
    results, paths = {"phases": {}}, {}
    t0 = time.perf_counter()
    cs.run_examples_slice(dev, a_sp, full_cover, smi, paths, results, lm,
                          nmf)
    print("PHASE29", root, round(time.perf_counter() - t0, 1),
          round(results["examples"]["b_seconds"], 1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
