"""Tile sizes of the port's BSR kernels, resolved through a per-device ledger
and measured by a sweep on the card (port of ``repro.kernels.autotune``).

* :func:`resolve_tiles` — the lookup every call site makes: per-(shape
  bucket, device kind) entries from a JSON ledger, falling back to
  :data:`DEFAULT_TILES` when no entry matches.  The operand's ingest
  (``cuda-bsr``'s ``prepare``, the mesh's block ingest) takes ``bm`` /
  ``bk`` from it; ``bsr_spmm`` and ``bsr_spmm_gram`` take ``kb``, the
  plain kernel's column chunk, from it.
* :func:`legal_candidates` — the sweep's pre-filter, by the CUDA kernels'
  own rules: ``bm`` <= :data:`MAX_BM`, ``bk`` <= :data:`MAX_BK` with a tile
  row of whole 16-byte vectors, ``kb`` one of :data:`KB_WIDTHS`, two ring
  stages of the plain kernel in :data:`SMEM_BUDGET`, and, where the fused
  kernel can take the rank at all, its two stages and Gram partial too.
* :func:`autotune` — the sweep: ingests the operand at every candidate
  tile shape, times the fused and the plain half-step pair (``A @ V`` and
  ``A^T @ U``) with CUDA events, records each beside its bound from the
  card's peaks, and returns the winner as a ledger entry.  Off the card it
  times nothing and returns the defaults tagged ``default-fallback``.
* :func:`update_ledger` merges an entry into the ledger; it refuses an
  ``autotune`` entry keyed to a device kind that is not a CUDA card.

Ledger format (``autotune_ledger.json`` next to this module; override the
path with ``$REPRO_TORCH_AUTOTUNE_LEDGER``; the reference's
``$REPRO_AUTOTUNE_LEDGER`` is not read, so the packages never share one)::

    {"entries": {"<device-kind>/<shape-bucket>": {
        "bm": 128, "bk": 128, "kb": 8,
        "source": "autotune" | "default-fallback",
        "fused_us": ..., "spmm_us": ..., "roofline_us": ...}}}

Shape buckets are the reference's power-of-two strings (``n32768-m8192-k8``);
``k*`` buckets serve ingest, before the rank is known.

The BSR kernels (``csrc/bsr_spmm.cu``) keep a ring of stages in shared
memory, each one slot's whole (bm, bk) tile (one bulk copy) plus that slot's
(bk, w) U slab in f32, stored per quad of rows at ``4 * (w | 1)`` floats
apart; the ring holds as many stages as fit, at most eight.  The fused
kernel also keeps its k x k f32 Gram partial there, and its blocks of
column chunk 0 hold the full-rank slab (w = k); every other block holds its
column chunk.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "TileConfig", "DEFAULT_TILES", "SMEM_BUDGET", "KB_WIDTHS", "MAX_BM",
    "MAX_BK", "HBM_BYTES_PER_S", "F32_FLOPS", "BF16_FLOPS",
    "shape_bucket", "device_kind", "ledger_path", "load_ledger",
    "resolve_tiles", "legal_candidates", "ring_stage_bytes",
    "spmm_working_set", "fused_working_set", "fused_max_k", "column_chunk",
    "autotune", "update_ledger",
]

#: dynamic shared memory one block may opt in to on an H100
#: (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, 227 KB); the BSR kernels
#: opt in with ``cudaFuncSetAttribute``
SMEM_BUDGET = 227 * 1024

#: column chunks the plain BSR kernel is built for: a block computes
#: ``kb`` factor columns and the tiles are streamed once per chunk.  At
#: 8 a lane splits a tile row's dot products with its warp (a quad of
#: columns each); at 32 and 64 a lane holds a register tile of up to 5
#: whole rows by ``kb / 8`` columns.  A rank of at most 8 is one chunk of 8
#: whatever ``kb`` is.
KB_WIDTHS = (8, 32, 64)
#: tallest BSR tile the kernels take (7 consumer warps x 19 rows a lane)
MAX_BM = 128
#: widest BSR tile the kernels take (32 lanes x one quad of columns)
MAX_BK = 128

#: bytes ahead of the ring: the stage barriers and the fix-up flag
_RING_HEADER = 256

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
#: float32 FLOP/s outside the tensor cores, dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

_LEDGER_ENV = "REPRO_TORCH_AUTOTUNE_LEDGER"


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Resolved tile sizes for one (shape bucket, device) cell.

    ``bm`` / ``bk`` are the BSR tile dims (fixed at ingest); ``kb`` is the
    plain BSR kernel's column chunk (one of :data:`KB_WIDTHS`), which the
    fused kernel shares so that its product stays bitwise the plain one.
    The reference's ``gram_bm``, ``mask_bm`` and ``mask_bk`` have no
    counterpart: ``gram`` and ``relu_topk`` size their own persistent grids
    from the card's SM count, so a ledger entry that carries them still
    parses and they are ignored."""

    bm: int = 128
    bk: int = 128
    kb: int = 8


DEFAULT_TILES = TileConfig()

_FIELDS = tuple(f.name for f in dataclasses.fields(TileConfig))


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def shape_bucket(n: int, m: Optional[int] = None,
                 k: Optional[int] = None) -> str:
    """Power-of-two shape bucket, ``*`` for dims unknown at the call site
    (the factor rank during operand ingest)."""
    parts = [f"n{_pow2(n)}"]
    parts.append(f"m{_pow2(m)}" if m is not None else "m*")
    parts.append(f"k{_pow2(k)}" if k is not None else "k*")
    return "-".join(parts)


@functools.lru_cache(maxsize=None)
def _kind_of(index: Optional[int]) -> str:
    import torch

    if index is None:
        if not torch.cuda.is_available():
            return "cpu"
        index = torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    return "_".join(str(name).lower().split())


def device_kind(device=None) -> str:
    """Normalized identity of a device for the ledger key, lower-case and
    ``_``-joined (``nvidia_h100_80gb_hbm3``, ``cpu``): the card's name for a
    CUDA device, ``cpu`` for the CPU; with no ``device``, the current card,
    or ``cpu`` where there is none."""
    if device is None:
        return _kind_of(None)
    import torch

    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        return device.type
    return _kind_of(device.index if device.index is not None
                    else torch.cuda.current_device())


def is_cuda_kind(kind: str) -> bool:
    """Whether a ledger device kind names a CUDA card (the only place the
    port's timings are tuning facts)."""
    return kind.startswith("nvidia_")


_PACKAGE_LEDGER = Path(__file__).with_name("autotune_ledger.json")


def ledger_path() -> Path:
    env = os.environ.get(_LEDGER_ENV)
    if env:
        return Path(env)
    return _PACKAGE_LEDGER


#: the one cache of this module: parsed ledgers under ``("ledger", path)``
#: and resolved tiles under ``("tiles", path, device, n, m, k)``.  A ledger
#: is read once a process; :func:`update_ledger` empties the cache, and so
#: may a test.  A call site resolves at every product, and a ``stat`` of
#: the file each time would cost more than the product on a slow file
#: system, so a ledger another process rewrites is not seen.
_CACHE: Dict[tuple, object] = {}


def load_ledger(path: Optional[Path] = None) -> dict:
    """Parsed ledger (``{}`` entries when the file is absent or invalid),
    read once a process per path (again after :func:`update_ledger`, or
    once ``_CACHE`` is emptied)."""
    key = ("ledger", str(path) if path is not None else str(ledger_path()))
    data = _CACHE.get(key)
    if data is None:
        try:
            with open(key[1]) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        if not isinstance(data, dict) or not isinstance(data.get("entries"),
                                                        dict):
            data = {"entries": {}}
        data = _CACHE[key] = data
    return data


def _entry_to_tiles(entry: dict, key: str) -> TileConfig:
    tiles = dataclasses.replace(
        DEFAULT_TILES, **{f: int(entry[f]) for f in _FIELDS if f in entry})
    if tiles.kb not in KB_WIDTHS:
        raise ValueError(f"ledger entry {key}: kb={tiles.kb} is not one of "
                         f"the kernel's column chunks {KB_WIDTHS}")
    return tiles


def resolve_tiles(n: int, m: Optional[int] = None, k: Optional[int] = None,
                  device: Optional[str] = None) -> TileConfig:
    """Ledger lookup for the call-site shape: the most specific matching
    bucket wins (``n-m-k``, then ``n-m-k*``, then ``n-m*-k*``); no match
    falls back to :data:`DEFAULT_TILES`.  ``device`` is a device kind
    (:func:`device_kind`), the current card's by default.  Each shape is
    resolved once a process, from the ledger as :func:`load_ledger` read
    it."""
    dev = device if device is not None else device_kind()
    key = ("tiles", str(ledger_path()), dev, n, m, k)
    tiles = _CACHE.get(key)
    if tiles is None:
        tiles = _CACHE[key] = _resolve(load_ledger()["entries"], n, m, k, dev)
    return tiles


def _resolve(entries: dict, n, m, k, dev: str) -> TileConfig:
    for bucket in (shape_bucket(n, m, k),
                   shape_bucket(n, m, None),
                   shape_bucket(n, None, None)):
        key = f"{dev}/{bucket}"
        entry = entries.get(key)
        if entry:
            return _entry_to_tiles(entry, key)
    return DEFAULT_TILES


# ---------------------------------------------------------------------------
# The kernels' shared-memory arithmetic, and the legality pre-filter
# ---------------------------------------------------------------------------

def _round128(x: int) -> int:
    return -(-x // 128) * 128


def column_chunk(k: int, kb: int) -> int:
    """Factor columns one block of the plain kernel computes at rank ``k``
    and chunk ``kb``: 8 for a rank of at most 8 or ``kb`` = 8, else
    ``kb``."""
    return 8 if k <= 8 or kb <= 8 else kb


def ring_stage_bytes(bm: int, bk: int, w: int, itemsize: int = 4) -> int:
    """Shared-memory bytes of one stage of the BSR kernels' ring: the
    (bm, bk) tile at the operand's item size and the (bk, w) f32 U slab,
    each rounded up to 128 bytes."""
    return (_round128(bm * bk * itemsize)
            + _round128((bk // 4) * 4 * (w | 1) * 4))


def spmm_working_set(bm: int, bk: int, kb: int, k: int,
                     itemsize: int = 4) -> int:
    """Shared-memory bytes the plain kernel needs at the least: the header
    and a two-stage ring of (tile, column-chunk slab) stages."""
    w = min(k, column_chunk(k, kb))
    return _RING_HEADER + 2 * ring_stage_bytes(bm, bk, w, itemsize)


def fused_working_set(bm: int, bk: int, k: int, itemsize: int = 4) -> int:
    """Shared-memory bytes the fused spmm + Gram kernel needs at the least:
    the header, the k x k f32 Gram partial and a two-stage ring of (tile,
    full-rank slab) stages."""
    return (_RING_HEADER + _round128(k * k * 4)
            + 2 * ring_stage_bytes(bm, bk, k, itemsize))


def fused_max_k(bm: int, bk: int, itemsize: int = 4) -> int:
    """The widest rank the fused kernel takes at these tiles (0 if none)."""
    k = 0
    while fused_working_set(bm, bk, k + 1, itemsize) <= SMEM_BUDGET:
        k += 1
    return k


_CANDIDATE_BM = (64, 128)
_CANDIDATE_BK = (32, 64, 128)


def _default_candidates(k: int) -> List[Tuple[int, int, int]]:
    """(bm, bk, kb) over the default grid; a ``kb`` whose narrower
    neighbour already covers the rank in one chunk is the same launch
    shape and is left out."""
    kbs = [kb for i, kb in enumerate(KB_WIDTHS)
           if i == 0 or KB_WIDTHS[i - 1] < k]
    return [(bm, bk, kb) for bm in _CANDIDATE_BM for bk in _CANDIDATE_BK
            for kb in kbs]


def _tile_legal(n, m, bm, bk, kb, itemsize) -> bool:
    if bm <= 0 or bk <= 0 or bm > MAX_BM or bk > MAX_BK:
        return False
    if (bk * itemsize) % 16:
        return False  # a tile row is whole 16-byte vectors, a tile 16-aligned
    if kb not in KB_WIDTHS:
        return False
    return not (bm > 2 * max(n, 1) or bk > 2 * max(m, 1))


def legal_candidates(
    n: int, m: int, k: int, itemsize: int = 4,
    candidates: Optional[Iterable[Tuple[int, int, int]]] = None,
) -> List[Tuple[int, int, int]]:
    """(bm, bk, kb) triples the CUDA kernels take:

    * ``bm`` <= :data:`MAX_BM`; ``bk`` <= :data:`MAX_BK` with ``bk *
      itemsize`` a multiple of 16 (a multiple of 4 in f32, 8 in bf16);
      ``kb`` one of :data:`KB_WIDTHS`;
    * a block no more than twice the operand (else it is all padding);
    * two stages of the plain kernel's ring fit :data:`SMEM_BUDGET`
      (:func:`spmm_working_set`) in both orientations (A^T's tiles are
      (bk, bm));
    * where the fused kernel takes rank ``k`` in both orientations at some
      of these tile shapes, its two stages and Gram partial must fit there
      too (:func:`fused_working_set`): the fused backend then runs it, so
      a tile shape where it cannot is dropped.  Where it takes ``k`` at
      none (``k`` above :func:`fused_max_k`), the backend runs the
      separate launches and the plain rule alone applies.
    """
    if candidates is None:
        candidates = _default_candidates(k)
    out = [(bm, bk, kb) for bm, bk, kb in candidates
           if _tile_legal(n, m, bm, bk, kb, itemsize)
           and max(spmm_working_set(bm, bk, kb, k, itemsize),
                   spmm_working_set(bk, bm, kb, k, itemsize)) <= SMEM_BUDGET]
    fusing = [c for c in out if _fuses(c[0], c[1], k, itemsize)]
    return fusing if fusing else out


def _fuses(bm: int, bk: int, k: int, itemsize: int) -> bool:
    """Whether the fused kernel takes rank ``k`` in both orientations."""
    return max(fused_working_set(bm, bk, k, itemsize),
               fused_working_set(bk, bm, k, itemsize)) <= SMEM_BUDGET


# ---------------------------------------------------------------------------
# The sweep (on the card only)
# ---------------------------------------------------------------------------

def _timed_us(fn, repeats: int = 3, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in microseconds: CUDA events around
    ``repeats`` calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats * 1e3


def _roofline_us(op, k: int, fused: bool) -> float:
    """The least time of the f32 half-step pair (``A @ V`` and ``A^T @ U``)
    on this card: the occupied tiles, the factors and the products moved
    once at the HBM rate, or the multiply-adds (and the Gram's, fused) at
    the f32 peak, whichever is longer."""
    total = 0.0
    for b in (op.bsr, op.bsr_t):
        tiles = int((b.tiles != 0).flatten(2).any(-1).sum())
        nbytes = 4 * (tiles * b.bm * b.bk + (b.shape[0] + b.shape[1]) * k
                      + b.nrb * b.bcap)
        flops = 2.0 * tiles * b.bm * b.bk * k
        if fused:
            nbytes += 4 * k * k
            flops += 2.0 * int((b.gram_flags != 0).sum()) * b.bk * k * k
        total += max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    return total * 1e6


def _synthetic(n: int, m: int, density: float, seed: int):
    import scipy.sparse

    return scipy.sparse.random(n, m, density=density, format="csr",
                               dtype="float32",
                               random_state=seed)


def autotune(
    n: int, m: int, k: int, *,
    a=None,
    density: float = 0.05,
    repeats: int = 3,
    seed: int = 0,
    device=None,
    log=None,
) -> dict:
    """Sweep the legal (bm, bk, kb) candidates and return the winning
    ledger entry.

    The operand is ``a`` (scipy sparse, dense, anything ``bsr_operand``
    ingests; of shape (n, m)) or a random sparse (n, m) matrix of
    ``density``.  At each tile shape it is ingested once (f32 tiles); at
    each candidate the half-step pair
    (``A @ V`` and ``A^T @ U``) is timed with the plain ``bsr_spmm`` at
    ``kb`` and, where the fused kernel takes ``k`` in an orientation, the
    way ``cuda-bsr`` runs it (fused there, plain elsewhere; the Gram of the
    separate launches does not depend on the tiles).  The winner has the
    least time of the pair as ``cuda-bsr`` runs it.  Each candidate's record is
    passed to ``log`` if given, and the entry keeps all of them
    (``candidates``).

    Off the card (no CUDA device, or a CPU ``device``) nothing is timed:
    the defaults come back tagged ``source: default-fallback``.
    """
    import torch

    base = {f: getattr(DEFAULT_TILES, f) for f in _FIELDS}
    dev = torch.device(device) if device is not None else None
    if not torch.cuda.is_available() or (dev is not None
                                         and dev.type != "cuda"):
        return dict(base, source="default-fallback",
                    note="no CUDA device: only timings on the card are "
                         "tuning facts")
    if dev is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    from repro_torch.kernels.bsr import bsr_operand
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.fused import bsr_spmm_gram

    if a is None:
        a = _synthetic(n, m, density, seed)
    gen = torch.Generator().manual_seed(seed)
    v = torch.rand((m, k), generator=gen).to(dev)
    u = torch.rand((n, k), generator=gen).to(dev)
    legal = legal_candidates(n, m, k)
    records, best = [], None
    for bm, bk in dict.fromkeys((bm, bk) for bm, bk, _ in legal):
        op = bsr_operand(a, bm=bm, bk=bk, device=dev)
        pair = [(b, x, fused_working_set(b.bm, b.bk, k) <= SMEM_BUDGET)
                for b, x in ((op.bsr, v), (op.bsr_t, u))]
        fuses = any(f for _, _, f in pair)
        for kb in [c[2] for c in legal if c[:2] == (bm, bk)]:
            spmm_us = _timed_us(
                lambda: [bsr_spmm(b, x, kb=kb) for b, x, _ in pair], repeats)
            fused_us = (_timed_us(
                lambda: [(bsr_spmm_gram if f else bsr_spmm)(b, x, kb=kb)
                         for b, x, f in pair], repeats) if fuses else None)
            rec = {"bm": bm, "bk": bk, "kb": kb, "fused_us": fused_us,
                   "spmm_us": spmm_us,
                   "roofline_us": _roofline_us(op, k, fuses),
                   "score_us": fused_us if fuses else spmm_us}
            records.append(rec)
            if log is not None:
                log(rec)
            if best is None or rec["score_us"] < best["score_us"]:
                best = rec
        del op
    if best is None:  # no legal candidate (degenerate shape)
        return dict(base, source="default-fallback",
                    note="no legal candidate for this shape")
    return dict(base, **{f: best[f] for f in _FIELDS}, source="autotune",
                fused_us=best["fused_us"], spmm_us=best["spmm_us"],
                roofline_us=best["roofline_us"], swept=len(records),
                candidates=records)


def update_ledger(key: str, entry: dict, path: Optional[Path] = None) -> Path:
    """Merge one entry into the ledger file (created if absent).  An entry
    measured by :func:`autotune` (``source: autotune``) is refused unless
    its key's device kind is a CUDA card: the port's timings anywhere else
    are not tuning facts."""
    kind = key.split("/", 1)[0]
    if entry.get("source") == "autotune" and not is_cuda_kind(kind):
        raise ValueError(f"ledger key {key!r}: an autotune entry must be "
                         "measured on a CUDA card, not on "
                         f"{kind!r}")
    path = Path(path) if path is not None else ledger_path()
    data = {"_comment": "Autotuned tile sizes of the port's BSR kernels per "
                        "(device-kind, shape-bucket).  Regenerate on a card "
                        "with: python -m repro_torch.kernels.autotune",
            "entries": {}}
    if path.exists():
        loaded = load_ledger(path)
        data["entries"] = dict(loaded.get("entries", {}))
        if "_comment" in loaded:
            data["_comment"] = loaded["_comment"]
    data["entries"][key] = entry
    data["entries"] = dict(sorted(data["entries"].items()))
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=False)
        f.write("\n")
    _CACHE.clear()
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="sweep the BSR kernels' tile candidates on the card and "
                    "record the winner in the port's autotune ledger")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--m", type=int, default=2048)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--density", type=float, default=0.05)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="ledger path (default: the package ledger, or "
                         f"${_LEDGER_ENV})")
    args = ap.parse_args(argv)

    entry = autotune(args.n, args.m, args.k, density=args.density,
                     repeats=args.repeats,
                     log=lambda rec: print(json.dumps(rec), flush=True))
    if entry["source"] != "autotune":
        print(json.dumps({"ledger": None, "entry": entry}, indent=2))
        return 1
    dev = device_kind()
    keys = [f"{dev}/{shape_bucket(args.n, args.m, args.k)}",
            f"{dev}/{shape_bucket(args.n, args.m, None)}"]
    path = Path(args.out) if args.out else None
    for key in keys:
        path = update_ledger(key, entry, path)
    print(json.dumps({"ledger": str(path), "keys": keys,
                      "entry": {f: v for f, v in entry.items()
                                if f != "candidates"}}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
