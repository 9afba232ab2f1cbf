"""Out-of-core corpora: sharded on-disk padded CSR and double-buffered
prefetch (port of ``repro.data.corpus``).

* :func:`write_corpus` spills an ``SpCSR`` / dense / scipy matrix to a
  directory of pre-carved column chunks, one shard each: a pair of ``.npy``
  files (the padded-CSR ``values`` / ``cols`` grids) plus a ``meta.json``
  manifest with a crc32 per file.  The layout, the file names, the manifest
  keys, the dtypes and the checksums are the reference's, so a corpus that
  either package wrote fits in the other.
* :class:`MmapCorpus` opens that layout memory-mapped; ``load(i)`` copies
  shard ``i`` once out of the mapping (into pinned host memory when the
  chunk is bound for the card as it is) and checks its crc32 the first time
  the shard is read.
* :class:`ResidentChunks` / :class:`DenseChunks` give resident matrices the
  same ``ChunkSource`` face, carved by :class:`repro_torch.sparse.ColumnSlicer`
  into the same arrays :func:`write_corpus` spills.
* :class:`Prefetcher` runs the chunk *packer* on a worker thread up to
  ``depth`` chunks ahead of the consumer.  On the card the packer
  (:func:`stage_chunk`) ingests the chunk for its backend on the host and
  copies it from pinned memory on a side CUDA stream; the consumer's
  :meth:`StagedChunk.use` makes its stream wait for that copy and keeps the
  chunk's memory from reuse until its own work is done.  Prefetch on and
  off run the same packer on the same inputs, so the fits are bitwise
  equal.

Not ported here: ``PackedChunk`` (mesh streaming), the fault-injection
hooks and the skip-bad-chunks switch, which come with the fault-tolerance
layer.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
import warnings
import zlib
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import move
from repro_torch.sparse.csr import ColumnSlicer, SpCSR, from_dense, from_scipy

__all__ = [
    "CORPUS_FORMAT", "ChunkPackError", "ChunkSource", "CorpusIntegrityError",
    "DenseChunks", "MmapCorpus", "Prefetcher", "ResidentChunks",
    "StagedChunk", "as_chunk_source", "chunk_schedule", "is_corpus_input",
    "open_corpus", "stage_chunk", "write_corpus",
]

#: manifest format tag; v2 adds per-shard crc32 checksums (``crc_values`` /
#: ``crc_cols`` per chunk entry), checked at the first load of each shard
CORPUS_FORMAT = "repro-corpus-v2"
_FORMAT_V1 = "repro-corpus-v1"
_META = "meta.json"


class CorpusIntegrityError(RuntimeError):
    """A shard's bytes no longer match the checksum recorded when the
    corpus was written."""


class ChunkPackError(RuntimeError):
    """A chunk failed to pack (after its I/O retries).  Carries ``item``
    (the scheduled work item) and ``index`` (its position in the
    schedule); the original failure rides as ``__cause__``."""

    def __init__(self, message: str, item=None, index: Optional[int] = None):
        super().__init__(message)
        self.item = item
        self.index = index


def _crc_array(x) -> int:
    """crc32 of an array's raw bytes (C-contiguous view)."""
    return zlib.crc32(np.ascontiguousarray(x).view(np.uint8).reshape(-1))


def chunk_schedule(m: int, chunk_docs: int) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` column ranges of a width-``chunk_docs`` stream over
    ``m`` documents (the last chunk ragged).  Writer, resident sources and
    the manifest all derive from this one function."""
    if chunk_docs <= 0:
        raise ValueError(f"chunk_docs must be positive, got {chunk_docs}")
    return [(lo, min(lo + chunk_docs, m)) for lo in range(0, m, chunk_docs)]


# ---------------------------------------------------------------------------
# Chunk sources
# ---------------------------------------------------------------------------

class ChunkSource:
    """Protocol: a replayable chunked view of an (n, m) corpus.

    * ``shape`` — ``(n_terms, m_docs)``; ``chunk_docs`` — nominal width;
    * ``schedule`` — the ``[(lo, hi), ...]`` column ranges, in order;
    * ``load(i, pin=False)`` — chunk ``i`` on the host, columns rebased to
      ``[0, hi - lo)``; ``pin=True`` puts its arrays in pinned memory
      (for an asynchronous copy to the card).
    """

    shape: Tuple[int, int]
    chunk_docs: int

    @property
    def schedule(self) -> List[Tuple[int, int]]:
        return chunk_schedule(self.shape[1], self.chunk_docs)

    def __len__(self) -> int:
        return len(self.schedule)

    def load(self, i: int, pin: bool = False):
        raise NotImplementedError


def _pinned(t: torch.Tensor, pin: bool) -> torch.Tensor:
    return t.pin_memory() if pin and not t.is_pinned() else t


class ResidentChunks(ChunkSource):
    """A resident ``SpCSR`` corpus: one :class:`ColumnSlicer` index up
    front, then every chunk is an O(chunk nnz) carve at the schedule's one
    slot capacity (the arrays :func:`write_corpus` spills)."""

    def __init__(self, a: SpCSR, chunk_docs: int):
        self.shape = a.shape
        self.chunk_docs = int(chunk_docs)
        self._slicer = ColumnSlicer(a)
        self.cap = self._slicer.chunk_cap(self.schedule)

    def load(self, i: int, pin: bool = False) -> SpCSR:
        lo, hi = self.schedule[i]
        blk = self._slicer.block(lo, hi, cap=self.cap)
        return SpCSR(_pinned(blk.values, pin), _pinned(blk.cols, pin),
                     blk.shape)


class DenseChunks(ChunkSource):
    """A resident dense matrix (tensor or numpy) as column slices."""

    def __init__(self, a, chunk_docs: int):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a))
        self.shape = tuple(a.shape)
        self.chunk_docs = int(chunk_docs)
        self._a = a

    def load(self, i: int, pin: bool = False) -> torch.Tensor:
        lo, hi = self.schedule[i]
        x = self._a[:, lo:hi]
        return _pinned(x.contiguous(), pin) if pin else x


def _copy_out(arr: np.ndarray, pin: bool) -> torch.Tensor:
    """One copy of a (read-only, memory-mapped) array into a tensor, in
    pinned memory when asked."""
    dtype = torch.from_numpy(np.empty(0, dtype=arr.dtype)).dtype
    t = torch.empty(arr.shape, dtype=dtype, pin_memory=pin)
    np.copyto(t.numpy(), arr)
    return t


class MmapCorpus(ChunkSource):
    """A :func:`write_corpus` directory, opened memory-mapped.

    ``load(i)`` maps shard ``i``'s ``values`` / ``cols`` files and copies
    them once into tensors; opening costs O(manifest) and streaming
    O(chunk) resident bytes at a time.  v2 corpora carry a crc32 per shard
    file, checked at the first load of the shard (later loads, such as the
    fold-in pass, skip it); a mismatch raises :class:`CorpusIntegrityError`.
    v1 corpora load with a one-time warning that they carry no checksums."""

    def __init__(self, path):
        self.path = Path(path)
        try:
            meta = json.loads((self.path / _META).read_text())
        except FileNotFoundError:
            raise FileNotFoundError(
                f"{self.path} is not a corpus directory (no {_META}); "
                "write one with write_corpus") from None
        fmt = meta.get("format")
        if fmt not in (CORPUS_FORMAT, _FORMAT_V1):
            raise ValueError(
                f"{self.path / _META}: format {fmt!r} is not "
                f"{CORPUS_FORMAT!r} (or the legacy {_FORMAT_V1!r})")
        self.format = fmt
        self.shape = (int(meta["n"]), int(meta["m"]))
        self.chunk_docs = int(meta["chunk_docs"])
        self.cap = int(meta["cap"])
        self.dtype = np.dtype(meta["dtype"])
        self._chunks = meta["chunks"]
        #: per-shard [crc_values, crc_cols] pairs (None for v1 corpora)
        self.checksums = ([[c["crc_values"], c["crc_cols"]]
                           for c in self._chunks]
                          if fmt == CORPUS_FORMAT else None)
        self._validated: set = set()
        if self.checksums is None:
            warnings.warn(
                f"{self.path}: legacy {_FORMAT_V1} corpus carries no shard "
                "checksums; integrity cannot be verified (re-write it with "
                "write_corpus to upgrade)", UserWarning)
        if [(c["lo"], c["hi"]) for c in self._chunks] != self.schedule:
            raise ValueError(
                f"{self.path / _META}: shard ranges disagree with the "
                f"chunk_docs={self.chunk_docs} schedule")

    def load(self, i: int, pin: bool = False) -> SpCSR:
        c = self._chunks[i]
        values = _copy_out(np.load(self.path / c["values"], mmap_mode="r"),
                           pin)
        cols = _copy_out(np.load(self.path / c["cols"], mmap_mode="r"), pin)
        if self.checksums is not None and i not in self._validated:
            got = (_crc_array(values.numpy()), _crc_array(cols.numpy()))
            want = tuple(self.checksums[i])
            if got != want:
                raise CorpusIntegrityError(
                    f"{self.path}: shard {i} ({c['values']} / {c['cols']}) "
                    f"checksum mismatch (stored crc32 {want}, got {got}); "
                    "the corpus is corrupt: re-write it or restore it")
            self._validated.add(i)
        return SpCSR(values, cols, (self.shape[0], c["hi"] - c["lo"]))

    @property
    def chunk_nbytes(self) -> int:
        """Stored bytes of one full-width chunk."""
        itemsize = self.dtype.itemsize + np.dtype(np.int32).itemsize
        return self.shape[0] * self.cap * itemsize

    @property
    def nbytes(self) -> int:
        """Stored bytes of all shards."""
        return len(self._chunks) * self.chunk_nbytes


def _host_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_corpus(a, out_dir, chunk_docs: Optional[int] = None,
                 dtype=np.float32) -> Path:
    """Spill a matrix (``SpCSR``, dense numpy / tensor, or scipy sparse) to
    the sharded on-disk layout: ``chunk_docs``-wide column chunks (default:
    the streaming solver's 8-chunk schedule), each stored as
    ``shard-00000.values.npy`` / ``shard-00000.cols.npy`` at one shared
    slot capacity, plus ``meta.json``.  The shards are exactly the chunks a
    resident ``streaming`` fit carves, so fitting from disk reproduces the
    resident trajectory bit for bit.  Returns ``out_dir``."""
    from repro_torch.nmf.solvers import default_chunk_docs

    if hasattr(a, "tocoo"):          # scipy sparse, without a hard import
        sp = from_scipy(a)
    elif isinstance(a, SpCSR):
        sp = a
    else:                            # dense numpy / tensor
        sp = from_dense(_host_np(a))
    n, m = sp.shape
    w = int(chunk_docs) if chunk_docs is not None else default_chunk_docs(m)
    source = ResidentChunks(sp, w)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    chunks = []
    for i, (lo, hi) in enumerate(source.schedule):
        blk = source.load(i)
        vname, cname = f"shard-{i:05d}.values.npy", f"shard-{i:05d}.cols.npy"
        values = np.asarray(_host_np(blk.values), dtype=dtype)
        cols = np.asarray(_host_np(blk.cols), dtype=np.int32)
        np.save(out / vname, values)
        np.save(out / cname, cols)
        chunks.append({"lo": lo, "hi": hi, "values": vname, "cols": cname,
                       "crc_values": _crc_array(values),
                       "crc_cols": _crc_array(cols)})
    meta = {"format": CORPUS_FORMAT, "n": n, "m": m, "cap": source.cap,
            "chunk_docs": w, "dtype": np.dtype(dtype).name, "chunks": chunks}
    (out / _META).write_text(json.dumps(meta, indent=1))
    return out


def open_corpus(path) -> MmapCorpus:
    """Open a :func:`write_corpus` directory memory-mapped."""
    return MmapCorpus(path)


def is_corpus_input(a) -> bool:
    """True when ``a`` names or is an out-of-core corpus / chunk source."""
    return isinstance(a, (str, os.PathLike, ChunkSource))


def as_chunk_source(a, chunk_docs: Optional[int] = None) -> ChunkSource:
    """Any streaming-fit input as a ``ChunkSource``: paths open
    memory-mapped (``chunk_docs`` must then be unset or the width the
    corpus was written with); resident ``SpCSR`` / dense matrices are
    carved at ``chunk_docs`` (default: 8 chunks)."""
    from repro_torch.nmf.solvers import default_chunk_docs

    if isinstance(a, (str, os.PathLike)):
        a = open_corpus(a)
    if isinstance(a, ChunkSource):
        if (chunk_docs is not None and getattr(a, "chunk_docs", None)
                not in (None, int(chunk_docs))):
            raise ValueError(
                f"chunk_docs={chunk_docs} disagrees with the corpus's "
                f"stored chunk width {a.chunk_docs}; re-write the corpus "
                "or drop the override")
        return a
    w = int(chunk_docs) if chunk_docs is not None else \
        default_chunk_docs(a.shape[1])
    if isinstance(a, SpCSR):
        return ResidentChunks(a, w)
    return DenseChunks(a, w)


# ---------------------------------------------------------------------------
# Staged chunks and the double-buffered prefetcher
# ---------------------------------------------------------------------------

def _tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor of an operand (a tensor or a tree of dataclasses)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


@dataclasses.dataclass
class StagedChunk:
    """A chunk already ingested for its backend and on its way to the
    device: ``operand`` is the backend's operand on ``device``, ``ready``
    the event recorded on the side stream after its copy (``None`` on the
    CPU)."""

    operand: object
    device: torch.device
    ready: Optional[torch.cuda.Event] = None

    def use(self):
        """The operand, safe to read on the current stream: the stream
        waits for the copy, and every tensor of the operand is recorded on
        it, so that the allocator does not hand the memory to the side
        stream again before this stream's work on it is done."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.ready)
            for t in _tensors(self.operand):
                t.record_stream(stream)
            self.ready = None
        return self.operand


def stage_chunk(host, backend, device: torch.device,
                stream: Optional[torch.cuda.Stream] = None) -> StagedChunk:
    """Ingest a host chunk for ``backend`` and move it to ``device``.  On
    the card the ingest runs on the host and the copy from pinned memory on
    ``stream`` (a side stream), whose event the consumer waits on
    (:meth:`StagedChunk.use`); on the CPU it is the plain ingest."""
    if device.type != "cuda":
        return StagedChunk(backend.prepare(host, device=device), device)
    op = backend.prepare(host, device="cpu")
    with torch.cuda.stream(stream):
        if isinstance(op, torch.Tensor):
            op = move(op, device, non_blocking=True)
        else:
            op = op.to(device, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(stream)
    return StagedChunk(op, device, ready)


class Prefetcher:
    """Double-buffer host-side chunk packing against in-flight compute.

    ``Prefetcher(items, pack)`` iterates ``pack(item)`` for each item, a
    worker thread running ``pack`` up to ``depth`` items ahead of the
    consumer through a bounded queue; host memory holds at most ``depth``
    queued chunks plus the one being packed and the one being consumed.
    ``enabled=False`` calls ``pack`` inline: the same function on the same
    inputs, so prefetch on and off give the same results.  Worker
    exceptions re-raise in the consumer as :class:`ChunkPackError`;
    ``close`` (or the context manager, or an early stop breaking the loop)
    stops the worker without draining the stream.  ``OSError`` inside
    ``pack`` is retried ``retries`` times with exponential backoff
    (``retry_backoff * 2**attempt`` seconds).  A worker that dies without
    reporting is caught by a liveness check on the consumer side.

    ``stats``: ``packed`` items, ``max_queued`` high-water mark, ``pack_s``
    wall time inside ``pack``, ``stall_s`` time the consumer waited for a
    chunk (``1 - stall_s / pack_s`` is the share of packing hidden under
    compute), ``retries``.
    """

    _DONE = object()

    def __init__(self, items: Sequence, pack: Callable, depth: int = 2,
                 enabled: bool = True, retries: int = 2,
                 retry_backoff: float = 0.05):
        if depth <= 0:
            raise ValueError(f"prefetch depth must be positive, got {depth}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self._items = list(items)
        self._pack = pack
        self._enabled = bool(enabled)
        self._retries = int(retries)
        self._backoff = float(retry_backoff)
        self.stats = {"packed": 0, "max_queued": 0, "pack_s": 0.0,
                      "stall_s": 0.0, "retries": 0}
        if not self._enabled:
            return
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="repro-torch-corpus-prefetch")
        self._thread.start()

    def _pack_one(self, item, index: int):
        """``pack(item)`` with bounded retry of I/O errors."""
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                packed = self._pack(item)
            except OSError as exc:
                self.stats["pack_s"] += time.perf_counter() - t0
                if attempt < self._retries:
                    self.stats["retries"] += 1
                    time.sleep(self._backoff * (2 ** attempt))
                    attempt += 1
                    continue
                raise ChunkPackError(
                    f"chunk {item!r} (schedule position {index}) failed to "
                    f"pack after {attempt + 1} attempt(s): {exc}",
                    item=item, index=index) from exc
            except Exception as exc:
                self.stats["pack_s"] += time.perf_counter() - t0
                raise ChunkPackError(
                    f"chunk {item!r} (schedule position {index}) failed to "
                    f"pack: {exc}", item=item, index=index) from exc
            self.stats["pack_s"] += time.perf_counter() - t0
            self.stats["packed"] += 1
            return packed

    def _put(self, payload) -> bool:
        """Queue ``payload`` unless the consumer has gone away."""
        while not self._stop.is_set():
            try:
                self._q.put(payload, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for index, item in enumerate(self._items):
                if self._stop.is_set():
                    return
                if not self._put((self._pack_one(item, index), None)):
                    return
            self._put((self._DONE, None))
        except BaseException as exc:  # re-raised in the consumer
            self._put((None, exc))

    def __iter__(self):
        if not self._enabled:
            for index, item in enumerate(self._items):
                t0 = time.perf_counter()
                packed = self._pack_one(item, index)
                self.stats["stall_s"] += time.perf_counter() - t0
                yield packed
            return
        while True:
            self.stats["max_queued"] = max(self.stats["max_queued"],
                                           self._q.qsize())
            t0 = time.perf_counter()
            while True:
                try:
                    packed, exc = self._q.get(timeout=1.0)
                    break
                except queue.Empty:
                    if not self._thread.is_alive():
                        self._stop.set()
                        raise RuntimeError(
                            "prefetch worker died without reporting a "
                            "result or an error; the stream cannot "
                            "continue") from None
            self.stats["stall_s"] += time.perf_counter() - t0
            if exc is not None:
                self._stop.set()
                raise exc
            if packed is self._DONE:
                return
            yield packed

    def close(self):
        """Stop the worker (idempotent; safe mid-stream)."""
        if not self._enabled:
            return
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
