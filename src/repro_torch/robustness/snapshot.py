"""Fit checkpointing: periodic atomic snapshots and a fingerprinted resume
(port of ``repro.robustness.snapshot``).

A fit configured with ``NMFConfig(checkpoint_dir=...)`` saves a snapshot
every ``checkpoint_every`` iterations (chunks, blocks): the factor state, the
progress histories, and a *fingerprint* of the config and the input.
``resume=True`` restores the newest complete snapshot, but only once the
fingerprint matches, so a directory left by another corpus, rank or budget
refuses to resume instead of continuing the wrong run.

The fingerprint pins ``k``, the sparsity spec, the solver, the dtype, the
seed, the block size, the chunk width and the input (shape and a sampled
digest; for an on-disk corpus its manifest with every shard's checksum).  It
ignores ``iters`` (resuming with a larger budget is the point), ``tol``,
``backend``, the prefetch knobs and the checkpoint settings.  The dicts are
the reference's for the same config and the same numpy, ``SpCSR`` or corpus
input, digested over the same host bytes, so a snapshot written by one
package passes the other's check.

On a mesh (``solver="distributed"``, streaming on a grid) the snapshot
holds the *gathered* factor: rank 0 writes it, every rank keeps it in
memory for a rollback, and a resume restores it whole and takes its own
rows, so a fit may resume on another mesh shape (elastic).  The input
fingerprinted is the one every rank was given, the same on every mesh;
the ranks check by an ``all_reduce`` that they agree on it.  A rank's own
block (``DistCSR`` / ``DistBSR``) handed in directly is fingerprinted by
the digests of all the grid's blocks, gathered by an ``all_reduce``.

One input the reference cannot fingerprint (its ``np.asarray`` of a BSR
operand fails) is fingerprinted here: a :class:`BSROperand`, by its shape,
block size, stored tile counts and block-column indices of both
orientations, and a sample of its tiles strided on the device (at most 1 MiB
reaches the host; the tiles themselves, 0.6 GB an orientation at PubMed
size, never do).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.robustness import faults

__all__ = [
    "CheckpointMismatchError", "FitHealthError", "FitCheckpointer",
    "config_fingerprint", "data_fingerprint",
]

#: bytes of a sampled digest that reach the host
_SAMPLE_BYTES = 1 << 20


class CheckpointMismatchError(RuntimeError):
    """``resume=True`` found a checkpoint whose fingerprint disagrees with
    the current config or input."""


class FitHealthError(RuntimeError):
    """A fit went unhealthy (non-finite factors or an exploding residual)
    and was not recovered within the rollback budget."""


def _raw_sample(x, budget: int = _SAMPLE_BYTES) -> np.ndarray:
    """The reference's digest sample of ``x``'s raw bytes: every byte up to
    ``budget``, else every ``nbytes // budget + 1``-th byte, so both ends of
    the buffer take part.  A tensor is sampled where it lives and only the
    sample is copied to the host."""
    if isinstance(x, torch.Tensor):
        raw = x.detach().contiguous().view(torch.uint8).reshape(-1)
        if raw.numel() > budget:
            raw = raw[::raw.numel() // budget + 1]
        return raw.cpu().numpy()
    raw = np.ascontiguousarray(x).view(np.uint8).ravel()
    if raw.nbytes > budget:
        raw = np.ascontiguousarray(raw[::raw.nbytes // budget + 1])
    return raw


def _crc(x, budget: int = _SAMPLE_BYTES) -> int:
    """Sampled content digest: crc32 over at most ``budget`` bytes of
    ``x``."""
    return zlib.crc32(_raw_sample(x, budget).tobytes())


def config_fingerprint(config) -> Dict[str, Any]:
    """The run-identity slice of an ``NMFConfig``."""
    return {
        "k": int(config.k),
        "sparsity": dataclasses.asdict(config.sparsity),
        "solver": config.solver,
        "dtype": str(config.dtype),
        "seed": int(config.seed),
        "block_size": int(config.block_size),
        "chunk_docs": (None if config.chunk_docs is None
                       else int(config.chunk_docs)),
    }


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=x.dtype).numpy().dtype)
    return str(np.asarray(x).dtype)


def _bsr_fingerprint(a) -> Dict[str, Any]:
    """A ``BSROperand``'s identity: shape, block size, stored tiles and a
    crc of the block-column indices of each orientation, and a crc of a
    strided sample of each orientation's tiles (half the sample budget
    each).  ``sampled_bytes`` is what reached the host."""
    digest, copied, stored = 0, 0, []
    for b in (a.bsr, a.bsr_t):
        cols = b.block_cols.detach().cpu().numpy()
        sample = _raw_sample(b.tiles, _SAMPLE_BYTES // 2)
        digest ^= zlib.crc32(np.ascontiguousarray(cols).tobytes())
        digest = zlib.crc32(sample.tobytes(), digest)
        copied += cols.nbytes + sample.nbytes
        stored.append(int(b.nrb * b.bcap))
    return {"kind": "bsr", "shape": [int(s) for s in a.shape],
            "block": [int(a.bsr.bm), int(a.bsr.bk)], "stored_tiles": stored,
            "dtype": _dtype_name(a.bsr.tiles), "digest": int(digest),
            "sampled_bytes": int(copied)}


def _dist_fingerprint(a, mesh) -> Dict[str, Any]:
    """A ``DistCSR`` / ``DistBSR`` block's identity: every block of the
    grid digested by its rank (:func:`data_fingerprint` of its local
    operand), the digests summed into one slot each by an ``all_reduce``
    and digested together."""
    from repro_torch.core.distributed import DistBSR

    local = data_fingerprint(a.op if isinstance(a, DistBSR) else a.fwd)
    local_t = {} if isinstance(a, DistBSR) else data_fingerprint(a.tsp)
    r, c = a.grid
    i, j = a.index
    slots = np.zeros(r * c, dtype=np.int64)
    slots[i * c + j] = zlib.crc32(json.dumps([local, local_t],
                                             sort_keys=True).encode())
    if mesh is not None:
        slots = mesh.all_reduce(torch.from_numpy(slots).to(mesh.device),
                                ("data", "model")).cpu().numpy()
    kind = "dist-bsr" if isinstance(a, DistBSR) else "dist-csr"
    return {"kind": kind, "shape": [int(x) for x in a.shape],
            "grid": [int(r), int(c)],
            "digest": int(zlib.crc32(slots.tobytes()))}


def data_fingerprint(a, mesh=None) -> Dict[str, Any]:
    """Identity of the input operand: shape plus a content digest.

    * an on-disk corpus (``MmapCorpus``) — the manifest identity: shape,
      chunk width, slot cap, shard count and a digest of the manifest (which
      carries every shard's checksum, so the content is pinned without
      re-reading the shards);
    * another ``ChunkSource`` — shape, schedule and a digest of its first
      chunk;
    * ``SpCSR`` — shape and sampled digests of the values / cols grids;
    * ``BSROperand`` — see :func:`_bsr_fingerprint`;
    * one rank's ``DistCSR`` / ``DistBSR`` block — the global shape, the
      grid and a digest of every block's digest (:func:`_dist_fingerprint`,
      one ``all_reduce`` over ``mesh``);
    * dense (tensor / numpy) — shape, dtype, sampled digest.
    """
    from repro_torch.core.distributed import DistBSR, DistCSR
    from repro_torch.data.corpus import ChunkSource, MmapCorpus
    from repro_torch.kernels.bsr import BSROperand
    from repro_torch.sparse.csr import SpCSR

    if isinstance(a, MmapCorpus):
        manifest = json.dumps(
            {"shape": list(a.shape), "chunk_docs": a.chunk_docs,
             "cap": a.cap, "chunks": getattr(a, "checksums", None)
             or len(a.schedule)},
            sort_keys=True)
        return {"kind": "corpus", "shape": list(a.shape),
                "chunk_docs": int(a.chunk_docs), "cap": int(a.cap),
                "n_chunks": len(a.schedule),
                "digest": zlib.crc32(manifest.encode())}
    if isinstance(a, ChunkSource):
        first = a.load(0)
        if isinstance(first, SpCSR):
            digest = _crc(first.values) ^ _crc(first.cols)
        else:
            digest = _crc(first)
        return {"kind": "chunks", "shape": list(a.shape),
                "chunk_docs": int(a.chunk_docs),
                "n_chunks": len(a.schedule), "digest": int(digest)}
    if isinstance(a, (DistCSR, DistBSR)):
        return _dist_fingerprint(a, mesh)
    if isinstance(a, SpCSR):
        return {"kind": "spcsr", "shape": list(a.shape),
                "digest": int(_crc(a.values) ^ _crc(a.cols))}
    if isinstance(a, BSROperand):
        return _bsr_fingerprint(a)
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    return {"kind": "dense", "shape": list(a.shape),
            "dtype": _dtype_name(a), "digest": int(_crc(a))}


class FitCheckpointer:
    """Solver-side checkpoint driver for one fit.

    * ``save(done, arrays, **meta)`` — atomic snapshot after ``done``
      completed iterations (chunks, blocks).  ``arrays`` is a flat
      name -> tensor dict, copied to the host here; ``meta`` holds host
      scalars and histories.  The snapshot is also kept in memory as
      :attr:`last`, so a rollback needs no disk read.  After the commit the
      ``"kill"`` fault site fires.
    * ``resume()`` — ``(done, arrays, meta)`` of the newest complete
      snapshot, fingerprint-checked; ``None`` when the directory holds none
      (a fit with ``resume=True`` then starts over).

    On a mesh (``mesh``, an ``NMFMesh`` of several ranks) every rank calls
    :meth:`save` with the gathered arrays; rank 0 writes them, every rank
    keeps them as :attr:`last`, and the ranks wait for the commit (an
    ``all_reduce``) before the ``"kill"`` site fires on each.

    ``stats``: ``saves``, ``save_s`` (host clock inside :meth:`save`, the
    copy to the host included) and ``bytes`` (written to disk).
    """

    def __init__(self, ckpt_dir: str, every: int,
                 fingerprint: Dict[str, Any], mesh=None):
        self.ckpt_dir = str(ckpt_dir)
        self.every = int(every)
        self.fingerprint = fingerprint
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        #: (done, arrays, meta) of the latest save or resume, in memory
        self.last: Optional[Tuple[int, Dict[str, np.ndarray], dict]] = None
        self.stats = {"saves": 0, "save_s": 0.0, "bytes": 0}

    @classmethod
    def from_config(cls, config, a, mesh=None) -> Optional["FitCheckpointer"]:
        """``None`` when the config asks for no checkpointing.  On a mesh
        the ranks must agree on the fingerprint (else ``ValueError``)."""
        if config.checkpoint_dir is None:
            return None
        fp = {"config": config_fingerprint(config),
              "data": data_fingerprint(a, mesh)}
        if mesh is not None and not mesh.agree(
                zlib.crc32(json.dumps(fp, sort_keys=True).encode())):
            raise ValueError(
                "the ranks of the mesh were given different inputs or "
                f"configs (this rank's fingerprint: {fp})")
        return cls(config.checkpoint_dir, config.checkpoint_every, fp, mesh)

    def due(self, done: int, total: int) -> bool:
        """A snapshot boundary: every ``every`` steps, but not the last one
        (the fit's result supersedes it)."""
        return done % self.every == 0 and 0 < done < total

    def save(self, done: int, arrays: Dict[str, Any], **meta) -> None:
        t0 = time.perf_counter()
        # owned copies: a CPU tensor's numpy view shares its memory
        host = {k: np.array(store._host(v)) for k, v in arrays.items()}
        full_meta = dict(meta)
        full_meta["fingerprint"] = self.fingerprint
        if self.mesh is None or self.mesh.rank == 0:
            path = store.save_checkpoint(self.ckpt_dir, done, host,
                                         meta=full_meta)
            self.stats["bytes"] += sum(
                os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path))
        self.last = (done, host, full_meta)
        self.stats["saves"] += 1
        if self.mesh is not None:
            self.mesh.barrier()   # rank 0's snapshot is committed
        self.stats["save_s"] += time.perf_counter() - t0
        faults.maybe_kill("kill", done)

    def resume(self) -> Optional[Tuple[int, Dict[str, np.ndarray], dict]]:
        step = store.latest_step(self.ckpt_dir)
        if step is None:
            return None
        arrays, meta = store.load_checkpoint_arrays(self.ckpt_dir, step)
        saved = (meta or {}).get("fingerprint")
        if saved != self.fingerprint:
            raise CheckpointMismatchError(
                f"checkpoint at {self.ckpt_dir} (step {step}) was written by "
                f"a different run.\n  saved:   {saved}\n  current: "
                f"{self.fingerprint}\nDelete the checkpoint directory to "
                "start fresh, or fix the config / input to match.")
        self.last = (step, arrays, meta)
        return self.last
