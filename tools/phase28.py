#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 28 (the paper's Wikipedia configuration:
the host ingest, the whole-batch and streamed ``cuda-bsr`` fits against
``torch-dense`` / ``torch-csr``, the command line, the kernels at this
shape) alone, with the ``chip_smoke.py`` and ``src`` of the checkout at
``ROOT`` (default: this one):

    python3 tools/phase28.py [ROOT]

It builds the kernels, then makes the Wikipedia corpus while the command
line (28(c)) runs beside it, as the whole script does beside the train
launchers, and runs ``run_wikipedia_slice``.  Prints one line:
``PHASE28``, the checkout, the phase's seconds and the corpus's.  Exits 2
without a CUDA device.
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
        print("phase28: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.device import configure_numerics
    from repro_torch.kernels import _build
    from repro_torch.kernels.autotune import (
        BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S,
    )

    cs.HBM_BYTES_PER_S, cs.BF16_FLOPS, cs.F32_FLOPS = (
        HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS)
    configure_numerics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s on {smi}")
    cli = cs.beside(cs.wikipedia_command_line, True)
    wiki = cs.wikipedia_corpus()
    cli.exception()
    rows = {"bsr_spmm": {}, "bsr_spmm_gram": {}, "gram": {},
            "project_mask": {}}
    results = {"phases": {}}
    t0 = time.perf_counter()
    cs.run_wikipedia_slice(torch.device("cuda"), wiki, cli, smi, {},
                           results, rows)
    print("PHASE28", root, round(time.perf_counter() - t0, 1),
          round(wiki["seconds"], 1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
