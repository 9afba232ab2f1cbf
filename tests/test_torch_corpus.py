"""Port parity for the out-of-core corpus layer: the on-disk layout is the
reference's (a corpus that either package writes fits in the other, file
for file and crc32 for crc32), resident and from-disk fits are bitwise
equal, and the ``Prefetcher`` keeps the reference's order, bound,
exception, close and bad-depth semantics (``tests/test_corpus.py:182-240``).
"""
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic_journal_corpus as ref_corpus
from repro.data.corpus import open_corpus as ref_open_corpus
from repro.data.corpus import write_corpus as ref_write_corpus
from repro.nmf import EnforcedNMF as RefNMF
from repro.nmf import NMFConfig as RefConfig
from repro.nmf import Sparsity as RefSparsity
from repro.sparse import to_scipy
from repro_torch.data.corpus import (
    ChunkPackError, CorpusIntegrityError, DenseChunks, MmapCorpus,
    Prefetcher, ResidentChunks, as_chunk_source, chunk_schedule,
    is_corpus_input, open_corpus, write_corpus,
)
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
from repro_torch.sparse import from_scipy, to_dense

K, N, M, W = 4, 96, 60, 16


@pytest.fixture(scope="module")
def corpus():
    a, _ = ref_corpus(n_terms=N, n_docs=M, n_journals=4, seed=5)
    return to_scipy(a)


@pytest.fixture(scope="module")
def u0():
    return np.random.default_rng(1).random((N, K)).astype(np.float32)


def _cfgs(**kw):
    base = dict(k=K, iters=6, solver="streaming", chunk_docs=W)
    return (NMFConfig(sparsity=Sparsity(t_u=48, t_v=60), **(base | kw)),
            RefConfig(sparsity=RefSparsity(t_u=48, t_v=60), **base))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_corpus_crosses_packages(corpus, u0, tmp_path, writer):
    """Same files, manifest and crc32s from either writer; each package
    fits the other's corpus, and the trajectories match (1e-4)."""
    ours = write_corpus(corpus, tmp_path / "port", chunk_docs=W)
    theirs = ref_write_corpus(corpus, tmp_path / "ref", chunk_docs=W)
    meta = json.loads((ours / "meta.json").read_text())
    assert meta == json.loads((theirs / "meta.json").read_text())
    for c in meta["chunks"]:
        for key in ("values", "cols"):
            assert (ours / c[key]).read_bytes() == (theirs / c[key]).read_bytes()
    path = theirs if writer == "reference" else ours
    disk, rdisk = open_corpus(path), ref_open_corpus(path)
    assert disk.checksums == rdisk.checksums
    for i in range(len(disk)):
        np.testing.assert_array_equal(disk.load(i).values.numpy(),
                                      np.asarray(rdisk.load(i).values))
    cfg, rcfg = _cfgs()
    model = EnforcedNMF(cfg, device="cpu").fit(str(path), u0=u0)
    ref = RefNMF(rcfg).fit(str(path), u0=jnp.asarray(u0))
    np.testing.assert_allclose(model.result_.error.numpy(),
                               np.asarray(ref.result_.error), atol=1e-4)
    np.testing.assert_allclose(model.u_.numpy(), np.asarray(ref.u_),
                               atol=1e-4)
    np.testing.assert_allclose(model.v_.numpy(), np.asarray(ref.v_),
                               atol=1e-4)
    np.testing.assert_array_equal(model.result_.nnz_u.numpy(),
                                  np.asarray(ref.result_.nnz_u))


@pytest.mark.parametrize("backend,prefetch", [
    (None, True), (None, False), ("cuda-bsr", True), ("cuda-bsr", False)])
def test_disk_fit_matches_resident_bitwise(corpus, u0, tmp_path, backend,
                                           prefetch):
    path = write_corpus(corpus, tmp_path / "c", chunk_docs=W)
    cfg, _ = _cfgs(backend=backend)
    res = EnforcedNMF(cfg, device="cpu").fit(corpus, u0=u0)
    disk = EnforcedNMF(cfg.replace(prefetch=prefetch),
                       device="cpu").fit(path, u0=u0)
    assert torch.equal(res.u_, disk.u_) and torch.equal(res.v_, disk.v_)
    assert torch.equal(res.result_.error, disk.result_.error)
    assert torch.equal(res._av_acc, disk._av_acc)
    assert disk.v_.shape == (M, K)


def test_round_trip_sources_and_dispatch(corpus, tmp_path):
    sp = from_scipy(corpus)
    path = write_corpus(sp, tmp_path / "c", chunk_docs=W)
    disk, res = open_corpus(path), ResidentChunks(sp, W)
    assert disk.schedule == res.schedule == chunk_schedule(M, W)
    assert disk.cap == res.cap and disk.chunk_nbytes * len(disk) == disk.nbytes
    for i in range(len(disk)):
        got, want = disk.load(i), res.load(i)
        assert torch.equal(got.values, want.values)
        assert torch.equal(got.cols, want.cols)
    dense = to_dense(sp)
    assert isinstance(as_chunk_source(str(path)), MmapCorpus)
    assert isinstance(as_chunk_source(path), MmapCorpus)
    assert isinstance(as_chunk_source(sp, chunk_docs=W), ResidentChunks)
    src = as_chunk_source(dense, chunk_docs=W)
    assert isinstance(src, DenseChunks)
    assert torch.equal(src.load(1), dense[:, W:2 * W])
    assert as_chunk_source(disk) is disk
    assert is_corpus_input(str(path)) and is_corpus_input(disk)
    assert not is_corpus_input(sp) and not is_corpus_input(dense)
    with pytest.raises(ValueError, match="chunk_docs"):
        as_chunk_source(path, chunk_docs=7)
    # a hot row does not inflate every shard: the cap is per chunk
    hot = np.zeros((32, 40), dtype=np.float32)
    hot[0, :] = 1.0
    assert open_corpus(write_corpus(hot, tmp_path / "h", chunk_docs=8)
                       ).cap == 8


def test_corpus_refusals_and_integrity(corpus, tmp_path):
    path = write_corpus(corpus, tmp_path / "c", chunk_docs=W)
    with pytest.raises(FileNotFoundError, match="not a corpus directory"):
        open_corpus(tmp_path)
    with pytest.raises(ValueError, match="stream"):
        EnforcedNMF(NMFConfig(k=K), device="cpu").fit(str(path))
    # a flipped byte in a shard fails its first load
    vals = np.load(path / "shard-00001.values.npy")
    vals.view(np.uint8).reshape(-1)[0] ^= 0xFF
    np.save(path / "shard-00001.values.npy", vals)
    disk = open_corpus(path)
    disk.load(0)
    with pytest.raises(CorpusIntegrityError, match="shard 1"):
        disk.load(1)
    # a v1 manifest (no checksums) loads with a warning
    meta = json.loads((path / "meta.json").read_text())
    meta["format"] = "repro-corpus-v1"
    (path / "meta.json").write_text(json.dumps(meta))
    with pytest.warns(UserWarning, match="checksums"):
        v1 = open_corpus(path)
    assert v1.checksums is None and v1.load(1).shape == (N, W)
    meta["format"] = "somebody-elses-layout"
    (path / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format"):
        open_corpus(path)


def _bounded(depth):
    started, gate = [], threading.Event()

    def pack(i):
        started.append(i)
        gate.wait(timeout=5.0)
        return i

    pf = Prefetcher(range(10), pack, depth=depth)
    time.sleep(0.3)
    gate.set()
    try:
        assert len(started) <= depth + 1   # depth queued + one in flight
        assert list(pf) == list(range(10))
    finally:
        pf.close()


def _exception(enabled):
    def pack(i):
        if i == 3:
            raise RuntimeError("shard went missing")
        return i

    got = []
    with pytest.raises(ChunkPackError, match="shard went missing") as info:
        with Prefetcher(range(10), pack, enabled=enabled) as pf:
            for x in pf:
                got.append(x)
    assert got == [0, 1, 2] and info.value.index == 3


def _io_retry(enabled):
    calls = []

    def pack(i):
        calls.append(i)
        if i == 2 and calls.count(2) < 3:
            raise OSError("flaky mount")
        return i

    with Prefetcher(range(4), pack, enabled=enabled,
                    retry_backoff=0.0) as pf:
        assert list(pf) == [0, 1, 2, 3]
    assert pf.stats["retries"] == 2
    with pytest.raises(ChunkPackError, match="after 1 attempt"):
        list(Prefetcher([0], lambda i: (_ for _ in ()).throw(OSError("x")),
                        enabled=enabled, retries=0))


def _close():
    pf = Prefetcher(range(1000), lambda i: i, depth=2)
    it = iter(pf)
    assert next(it) == 0
    pf.close()
    assert not pf._thread.is_alive()
    pf.close()                                   # idempotent


def _bad_depth():
    with pytest.raises(ValueError, match="depth"):
        Prefetcher([1], lambda i: i, depth=0)
    with pytest.raises(ValueError, match="prefetch_depth"):
        NMFConfig(k=4, prefetch_depth=0)
    with pytest.raises(ValueError, match="retries"):
        Prefetcher([1], lambda i: i, retries=-1)


def _order(enabled):
    with Prefetcher(range(20), lambda i: i * i, depth=3,
                    enabled=enabled) as pf:
        assert list(pf) == [i * i for i in range(20)]
    assert pf.stats["packed"] == 20 and pf.stats["max_queued"] <= 3


@pytest.mark.parametrize("case", [
    "order-on", "order-off", "bound-1", "bound-2", "exception-on",
    "exception-off", "io-retry-on", "io-retry-off", "close", "bad-depth"])
def test_prefetcher(case):
    {"order-on": lambda: _order(True), "order-off": lambda: _order(False),
     "bound-1": lambda: _bounded(1), "bound-2": lambda: _bounded(2),
     "exception-on": lambda: _exception(True),
     "exception-off": lambda: _exception(False),
     "io-retry-on": lambda: _io_retry(True),
     "io-retry-off": lambda: _io_retry(False),
     "close": _close, "bad-depth": _bad_depth}[case]()
