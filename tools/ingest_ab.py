#!/usr/bin/env python3
"""Time the host ingest of the paper's Wikipedia corpus (143,462 x 12,439,
seed 0, 5 journals; ``bsr_operand`` of its scipy CSR, both orientations at
128 x 128 tiles, on the host) in two checkouts on one host, each in a
process of its own, in the order parent, change, change, parent:

    python3 tools/ingest_ab.py PARENT_ROOT [ROOT]

``ROOT`` (default: this checkout) makes the corpus once and saves its
scipy CSR to a temporary directory; each run loads it, then reads the
ingest's seconds and its resident set's peak above the loaded input
(``VmRSS`` sampled every 20 ms, ``chip_smoke.RssPeak``).  Prints a line
``INGEST`` for each run and the host's ``MemTotal``; with a card, its name
and power limit too.  Needs no card.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BM = BK = 128


def one(src: str, npz: str) -> None:
    """One ingest with ``repro_torch`` from ``src``; prints its JSON."""
    sys.path.insert(0, src)
    import scipy.sparse

    import chip_smoke as cs
    from repro_torch.kernels.bsr import bsr_operand

    a_sp = scipy.sparse.load_npz(npz).tocsr()
    with cs.RssPeak() as rss:
        t0 = time.perf_counter()
        op = bsr_operand(a_sp, bm=BM, bk=BK, device="cpu")
        secs = time.perf_counter() - t0
    tile_bytes = sum(b.tiles.numel() * b.tiles.element_size()
                     for b in (op.bsr, op.bsr_t))
    print(json.dumps(dict(seconds=secs, rss_base=rss.base,
                          rss_peak=rss.peak, above=rss.peak - rss.base,
                          tile_bytes=tile_bytes)), flush=True)


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    root = Path(sys.argv[2] if len(sys.argv) > 2 else ".").resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import scipy.sparse

    import chip_smoke as cs

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        smi = "no card"
    wiki = cs.wikipedia_corpus()
    print(f"INGEST corpus {wiki['a_sp'].shape} nnz {wiki['a_sp'].nnz} in "
          f"{wiki['seconds']:.2f} s; host MemTotal "
          f"{cs.mem_total_bytes() / 1e9:.1f} GB, "
          f"{os.cpu_count()} cores; {smi}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        npz = str(Path(tmp) / "wikipedia.npz")
        scipy.sparse.save_npz(npz, wiki["a_sp"])
        del wiki
        env = dict(os.environ, PYTHONPATH=str(root))
        for name, tree in (("parent", parent), ("change", root),
                           ("change", root), ("parent", parent)):
            run = subprocess.run(
                [sys.executable, __file__, "--one", str(tree / "src"), npz],
                env=env, capture_output=True, text=True, timeout=900)
            if run.returncode != 0:
                print(run.stderr[-3000:], file=sys.stderr)
                return 1
            rec = json.loads(run.stdout.strip().splitlines()[-1])
            print(f"INGEST {name} {tree}: {rec['seconds']:.3f} s, RSS peak "
                  f"{rec['rss_peak'] / 1e9:.2f} GB, "
                  f"{rec['above'] / 1e9:.2f} GB above its input "
                  f"({rec['above'] / rec['tile_bytes']:.3f}x the "
                  f"{rec['tile_bytes'] / 1e9:.2f} GB of tiles)", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        one(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
