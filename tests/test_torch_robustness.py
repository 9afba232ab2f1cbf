"""Fault tolerance of the port: the reference's chaos suite
(``tests/test_robustness.py``) run on the port with ``device="cpu"``, and the
port held against the reference package on the same inputs.

* Every case of the reference suite but the mesh resume (the mesh engines
  are not ported): the fault registry, the fingerprints, kill-then-resume
  parity engine by engine (in process, and a subprocess killed with
  ``KILL_EXIT``), NaN rollback and its budget, corpus integrity and the
  retry / skip ladder.
* Against the reference: the registries fire the same sequence and poison
  the same positions; the fingerprints are equal dicts; checkpoint and
  compressed-factor files cross-read bitwise; a snapshot written by either
  package is resumed by the other to within 1e-4 of the uninterrupted U.
* The skip hatch drops only unreadable chunks (never a CUDA error), and the
  streamed fit names chunks by their schedule index after a skip, where the
  reference's positions shift (ROADMAP queue 3).
* The NMF command line, killed and resumed.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.data.corpus import CorpusIntegrityError as RefIntegrityError
from repro.data.corpus import ResidentChunks as RefResidentChunks
from repro.data.corpus import open_corpus as ref_open_corpus
from repro.nmf import EnforcedNMF as RefNMF
from repro.nmf import NMFConfig as RefConfig
from repro.nmf import Sparsity as RefSparsity
from repro.robustness import faults as ref_faults
from repro.robustness.snapshot import config_fingerprint as ref_config_fp
from repro.robustness.snapshot import data_fingerprint as ref_data_fp
from repro.sparse import from_scipy as ref_from_scipy
from repro.sparse import to_scipy as ref_to_scipy
from repro_torch.backend import get_backend
from repro_torch.checkpoint import store
from repro_torch.data import synthetic_journal_corpus
from repro_torch.data.corpus import (
    SKIP_BAD_CHUNKS_ENV, ChunkPackError, CorpusIntegrityError, Prefetcher,
    ResidentChunks, open_corpus, write_corpus,
)
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
from repro_torch.robustness import (
    KILL_EXIT, CheckpointMismatchError, FitHealthError, faults,
)
from repro_torch.robustness.snapshot import (
    config_fingerprint, data_fingerprint,
)
from repro_torch.sparse import from_scipy

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CPU = "cpu"


class Boom(Exception):
    """In-process stand-in for a hard kill."""


def run_subprocess(code, expect=0, args=None):
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable] + (args if args is not None
                              else ["-c", textwrap.dedent(code)])
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == expect, (out.returncode, out.stderr[-3000:])
    return out.stdout


@pytest.fixture(scope="module")
def docs():
    rng = np.random.default_rng(0)
    return np.abs(rng.normal(size=(16, 48))).astype(np.float32)


@pytest.fixture(scope="module")
def u0():
    return np.random.default_rng(3).random((16, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def small_corpus():
    a_sp, _ = synthetic_journal_corpus(n_terms=48, n_docs=40, n_journals=3,
                                       seed=5)
    return a_sp


def _fit(cfg, a, **kw):
    return EnforcedNMF(cfg, device=CPU).fit(a, **kw)


# ---------------------------------------------------------------------------
# the fault registry
# ---------------------------------------------------------------------------

def test_fault_fires_exactly_times_then_disarms():
    hits = 0
    with faults.inject("chunk-load", key=2, times=2):
        for _ in range(5):
            try:
                faults.fire("chunk-load", 2)
            except OSError:
                hits += 1
    assert hits == 2
    faults.fire("chunk-load", 2)  # uninstalled: no-op


def test_fault_wildcard_key_matches_everything():
    with faults.inject("chunk-load", times=3):
        for key in ("a", 1, None):
            with pytest.raises(OSError):
                faults.fire("chunk-load", key)
    assert not faults.active()


def test_poison_sets_nans_only_when_armed():
    x = torch.ones((8, 4))
    assert faults.poison("poison-step", 0, x) is x
    with faults.inject("poison-step", key=0):
        y = faults.poison("poison-step", 0, x)
    assert torch.isnan(y).any() and y.device == x.device
    assert not torch.isnan(x).any()       # the caller's tensor is untouched


def test_injected_exception_type_is_customizable():
    with faults.inject("kill", key=1, exc=Boom):
        with pytest.raises(Boom):
            faults.maybe_kill("kill", 1)


def test_registry_fires_the_reference_sequence():
    """The same arming and the same calls fire in the same places."""
    def drive(mod):
        fired = []
        mod.clear()
        mod.install("chunk-load", key=2, times=2)
        mod.install("chunk-load", times=1)
        mod.install("poison-step", key=5, times=3)
        for site, key in [("chunk-load", 0), ("chunk-load", 2),
                          ("chunk-load", 2), ("chunk-load", 2),
                          ("poison-step", 4), ("poison-step", 5),
                          ("prefetch-worker", 1), ("poison-step", None),
                          ("poison-step", 5), ("poison-step", 5)]:
            fired.append(mod.should_fire(site, key))
        left = [(f.site, f.key, f.fired) for f in mod.active()]
        mod.clear()
        return fired, left

    assert drive(faults) == drive(ref_faults)


@pytest.mark.parametrize("shape", [(8, 4), (97, 3), (300, 5), (1, 1)])
def test_poison_marks_the_reference_positions(shape):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    with ref_faults.inject("poison-step", key=0):
        want = np.isnan(np.asarray(ref_faults.poison("poison-step", 0, x)))
    with faults.inject("poison-step", key=0):
        got = torch.isnan(faults.poison("poison-step", 0,
                                        torch.from_numpy(x))).numpy()
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def test_config_fingerprint_pins_math_not_schedule():
    base = NMFConfig(k=4, iters=10, seed=1)
    assert config_fingerprint(base) == config_fingerprint(
        base.replace(iters=50, tol=1e-3, backend="torch-csr",
                     prefetch=False))
    assert config_fingerprint(base) != config_fingerprint(base.replace(k=5))
    assert config_fingerprint(base) != config_fingerprint(base.replace(seed=2))


@pytest.mark.parametrize("kw", [
    dict(k=4, iters=10, seed=1),
    dict(k=6, solver="sequential", block_size=2, seed=3),
    dict(k=3, solver="streaming", chunk_docs=8,
         sparsity=dict(t_u=40, t_v=60)),
    dict(k=5, sparsity=dict(frac_u=0.1, mode="exact"), dtype="float64"),
])
def test_config_fingerprint_is_the_reference_dict(kw):
    kw = dict(kw)
    sp = kw.pop("sparsity", {})
    port = NMFConfig(sparsity=Sparsity(**sp), **kw)
    ref = RefConfig(sparsity=RefSparsity(**sp), **kw)
    assert config_fingerprint(port) == ref_config_fp(ref)


def _operands(kind, docs, small_corpus, tmp_path):
    """(port input, reference input) of one kind, built from one matrix."""
    if kind == "dense":
        return torch.from_numpy(docs), jnp.asarray(docs)
    if kind == "numpy":
        return docs, docs
    sp = ref_to_scipy(small_corpus)
    if kind == "spcsr":
        return from_scipy(sp), ref_from_scipy(sp)
    if kind == "chunks":
        return (ResidentChunks(from_scipy(sp), 8),
                RefResidentChunks(ref_from_scipy(sp), 8))
    path = write_corpus(small_corpus, tmp_path / "c", chunk_docs=8)
    return open_corpus(path), ref_open_corpus(path)


@pytest.mark.parametrize("kind", ["dense", "numpy", "spcsr", "chunks",
                                  "corpus"])
def test_data_fingerprint_is_the_reference_dict(kind, docs, small_corpus,
                                                tmp_path):
    port, ref = _operands(kind, docs, small_corpus, tmp_path)
    fp = data_fingerprint(port)
    assert fp == ref_data_fp(ref)
    assert json.loads(json.dumps(fp)) == fp    # survives the manifest


def test_data_fingerprint_samples_large_buffers_like_the_reference():
    """Above 1 MiB both digest every (nbytes // 2**20 + 1)-th byte; the port
    takes its sample where the tensor lives."""
    x = np.random.default_rng(2).random((700, 500)).astype(np.float32)
    assert data_fingerprint(torch.from_numpy(x)) == ref_data_fp(x)


def test_bsr_operand_fingerprint(small_corpus):
    """The branch the reference lacks: equal for the same matrix, different
    for another, its host copy bounded by the sample and the indices."""
    sp = ref_to_scipy(small_corpus)
    be = get_backend("cuda-bsr")
    op = be.prepare(sp, device=CPU)
    fp = data_fingerprint(op)
    assert fp["kind"] == "bsr" and fp["shape"] == [48, 40]
    assert fp == data_fingerprint(be.prepare(sp, device=CPU))
    other = sp.copy()
    other.data = other.data * 2.0
    assert data_fingerprint(be.prepare(other, device=CPU)) != fp
    cols = op.bsr.block_cols.numel() + op.bsr_t.block_cols.numel()
    assert fp["sampled_bytes"] <= (1 << 20) + 4 * cols
    assert json.loads(json.dumps(fp)) == fp


def test_bsr_fit_checkpoints_and_resumes(small_corpus, tmp_path):
    """The reference cannot checkpoint a fit on its BSR path
    (``np.asarray`` of its operand fails); the port's ``cuda-bsr`` fit
    (plain versions on the CPU) is killed and resumes bitwise."""
    sp = ref_to_scipy(small_corpus)
    cfg = NMFConfig(k=3, iters=12, seed=1, backend="cuda-bsr",
                    sparsity=Sparsity(t_u=40, t_v=30),
                    checkpoint_dir=str(tmp_path), checkpoint_every=4)
    ref = _fit(cfg.replace(checkpoint_dir=None), sp)
    with faults.inject("kill", key=8, exc=Boom):
        with pytest.raises(Boom):
            _fit(cfg, sp)
    res = _fit(cfg, sp, resume=True)
    assert torch.equal(res.u_, ref.u_) and torch.equal(res.v_, ref.v_)
    assert torch.equal(res.result_.error, ref.result_.error)


def test_resume_refuses_mismatched_config(docs, tmp_path):
    cfg = NMFConfig(k=3, iters=12, seed=1,
                    checkpoint_dir=str(tmp_path), checkpoint_every=4)
    _fit(cfg, docs)
    with pytest.raises(CheckpointMismatchError):
        _fit(cfg.replace(seed=9), docs, resume=True)


def test_resume_refuses_different_data(docs, tmp_path):
    cfg = NMFConfig(k=3, iters=12, seed=1,
                    checkpoint_dir=str(tmp_path), checkpoint_every=4)
    _fit(cfg, docs)
    with pytest.raises(CheckpointMismatchError):
        _fit(cfg, docs + 1.0, resume=True)


# ---------------------------------------------------------------------------
# kill-then-resume parity, engine by engine
# ---------------------------------------------------------------------------

def _kill_resume_parity(a, cfg, kill_key):
    """Fit uninterrupted; fit again killed mid-run; resume; the resumed
    factors match the uninterrupted ones (bitwise on the CPU: every engine
    here is deterministic, and a snapshot is an exact copy)."""
    ref = _fit(cfg.replace(checkpoint_dir=None, resume=False), a)
    with faults.inject("kill", key=kill_key, exc=Boom):
        with pytest.raises(Boom):
            _fit(cfg, a)
    res = _fit(cfg, a, resume=True)
    np.testing.assert_allclose(ref.u_.numpy(), res.u_.numpy(), atol=1e-5)
    assert torch.equal(ref.u_, res.u_)
    assert torch.equal(ref.result_.residual, res.result_.residual)
    assert res.result_.n_iter == ref.result_.n_iter
    return ref, res


def test_batch_kill_resume_parity(docs, tmp_path):
    cfg = NMFConfig(k=3, iters=20, seed=1,
                    checkpoint_dir=str(tmp_path), checkpoint_every=5)
    _, res = _kill_resume_parity(docs, cfg, kill_key=10)
    assert res.result_.checkpoint_stats["saves"] == 1   # at 15, not at 20


def test_sequential_kill_resume_parity(docs, tmp_path):
    cfg = NMFConfig(k=6, iters=8, seed=1, solver="sequential",
                    checkpoint_dir=str(tmp_path), checkpoint_every=2)
    ref, res = _kill_resume_parity(docs, cfg, kill_key=4)
    assert res.result_.residual.shape == ref.result_.residual.shape
    assert torch.equal(res.result_.error, ref.result_.error)


def test_streaming_resident_kill_resume_parity(docs, tmp_path):
    cfg = NMFConfig(k=3, iters=6, seed=1, solver="streaming", chunk_docs=8,
                    checkpoint_dir=str(tmp_path), checkpoint_every=2)
    ref, res = _kill_resume_parity(docs, cfg, kill_key=4)
    assert torch.equal(ref.v_, res.v_)
    assert torch.equal(ref._av_acc, res._av_acc)


def test_streaming_corpus_kill_resume_parity(small_corpus, tmp_path):
    corpus = write_corpus(small_corpus, tmp_path / "corpus", chunk_docs=8)
    cfg = NMFConfig(k=3, iters=6, seed=1, solver="streaming", chunk_docs=8,
                    checkpoint_dir=str(tmp_path / "ckpt"),
                    checkpoint_every=2)
    _kill_resume_parity(str(corpus), cfg, kill_key=2)


def test_resume_with_exhausted_checkpoint_raises(docs, tmp_path):
    cfg = NMFConfig(k=3, iters=10, seed=1,
                    checkpoint_dir=str(tmp_path), checkpoint_every=5)
    _fit(cfg, docs)
    with pytest.raises(ValueError, match="raise iters"):
        _fit(cfg.replace(iters=5), docs, resume=True)


def test_resume_with_no_checkpoint_starts_fresh(docs, tmp_path):
    cfg = NMFConfig(k=3, iters=10, seed=1,
                    checkpoint_dir=str(tmp_path / "empty"))
    fresh = _fit(cfg, docs, resume=True)
    assert torch.equal(fresh.u_, _fit(cfg.replace(checkpoint_dir=None),
                                      docs).u_)


# ---------------------------------------------------------------------------
# against the reference: files and snapshots cross
# ---------------------------------------------------------------------------

def test_checkpoint_files_cross_read(tmp_path):
    rng = np.random.default_rng(4)
    arrays = {"u": rng.random((7, 3)).astype(np.float32),
              "av": rng.random((7, 3)).astype(np.float32),
              "gv": rng.random((3, 3)).astype(np.float32)}
    meta = {"history": {"residual": [0.5, 0.25]}, "n_docs_seen": 9}
    store.save_checkpoint(str(tmp_path / "p"), 4,
                          {k: torch.from_numpy(v) for k, v in arrays.items()},
                          meta=meta)
    ref_store.save_checkpoint(str(tmp_path / "r"), 4,
                              {k: jnp.asarray(v) for k, v in arrays.items()},
                              meta=meta)
    for d in ("p", "r"):
        assert store.latest_step(str(tmp_path / d)) == 4
        for load in (store.load_checkpoint_arrays,
                     ref_store.load_checkpoint_arrays):
            got, got_meta = load(str(tmp_path / d), 4)
            assert got_meta == meta and set(got) == set(arrays)
            for k, v in arrays.items():
                assert np.array_equal(np.asarray(got[k]), v)
    for d in ("p", "r"):
        with open(tmp_path / d / "step_4" / "manifest.json") as f:
            assert json.load(f)["names"] == ["av", "gv", "u"]


def test_sparse_factor_files_cross_read_bitwise(tmp_path):
    rng = np.random.default_rng(5)
    u = rng.random((30, 5)).astype(np.float32)
    v = rng.random((20, 5)).astype(np.float32)
    u[u < 0.8] = 0
    v[v < 0.7] = 0
    nbytes = store.save_nmf_factors_sparse(str(tmp_path / "p.npz"),
                                           torch.from_numpy(u),
                                           torch.from_numpy(v))
    ref_store.save_nmf_factors_sparse(str(tmp_path / "r.npz"),
                                      jnp.asarray(u), jnp.asarray(v))
    assert nbytes["u_val"] == 4 * int((u != 0).sum())
    for name in ("p.npz", "r.npz"):
        pu, pv = store.restore_nmf_factors_sparse(str(tmp_path / name),
                                                  device=CPU)
        ru, rv = ref_store.restore_nmf_factors_sparse(str(tmp_path / name))
        for got in (pu.numpy(), np.asarray(ru)):
            assert np.array_equal(got.view(np.int32), u.view(np.int32))
        for got in (pv.numpy(), np.asarray(rv)):
            assert np.array_equal(got.view(np.int32), v.view(np.int32))


def _ref_cfg(d):
    return RefConfig(k=3, iters=20, seed=1, checkpoint_dir=str(d),
                     checkpoint_every=5)


def _port_cfg(d):
    return NMFConfig(k=3, iters=20, seed=1, checkpoint_dir=str(d),
                     checkpoint_every=5)


def test_port_resumes_a_reference_snapshot(docs, u0, tmp_path):
    """A reference dense fit killed at iteration 10 of 20; the port resumes
    its snapshot and ends within 1e-4 of the reference's uninterrupted U."""
    with ref_faults.inject("kill", key=10, exc=Boom):
        with pytest.raises(Boom):
            RefNMF(_ref_cfg(tmp_path)).fit(docs, u0=jnp.asarray(u0))
    full = RefNMF(_ref_cfg(tmp_path).replace(checkpoint_dir=None)).fit(
        docs, u0=jnp.asarray(u0))
    res = _fit(_port_cfg(tmp_path), docs, u0=u0, resume=True)
    np.testing.assert_allclose(res.u_.numpy(), np.asarray(full.u_),
                               atol=1e-4)
    assert res.result_.n_iter == 20
    np.testing.assert_allclose(res.result_.error.numpy(),
                               np.asarray(full.result_.error), atol=1e-4)


def test_reference_resumes_a_port_snapshot(docs, u0, tmp_path):
    with faults.inject("kill", key=10, exc=Boom):
        with pytest.raises(Boom):
            _fit(_port_cfg(tmp_path), docs, u0=u0)
    full = _fit(_port_cfg(tmp_path).replace(checkpoint_dir=None), docs,
                u0=u0)
    res = RefNMF(_ref_cfg(tmp_path)).fit(docs, u0=jnp.asarray(u0),
                                         resume=True)
    np.testing.assert_allclose(np.asarray(res.u_), full.u_.numpy(),
                               atol=1e-4)
    assert res.result_.n_iter == 20


# ---------------------------------------------------------------------------
# fit health: NaN injection -> rollback (or raise)
# ---------------------------------------------------------------------------

def _warned(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w]


def test_batch_nan_rollback_recovers(docs, tmp_path):
    cfg = NMFConfig(k=3, iters=20, seed=1,
                    checkpoint_dir=str(tmp_path), checkpoint_every=5)
    with faults.inject("poison-step", key=10):
        model, msgs = _warned(lambda: _fit(cfg, docs))
    assert torch.isfinite(model.u_).all()
    assert sum("rolling back" in m for m in msgs) == 1
    assert "at iteration 10" in msgs[0]
    assert model.result_.n_iter == 20


def test_rollback_without_a_snapshot_restarts_from_u0(docs):
    cfg = NMFConfig(k=3, iters=12, seed=1, tol=1e-9)   # tol: 10-step chunks
    with faults.inject("poison-step", key=10):
        model, msgs = _warned(lambda: _fit(cfg, docs))
    assert "rolling back to iteration 0" in msgs[0]
    assert torch.isfinite(model.u_).all() and model.result_.n_iter == 12


def test_streaming_nan_rollback_recovers(docs, tmp_path):
    cfg = NMFConfig(k=3, iters=6, seed=1, solver="streaming", chunk_docs=8,
                    checkpoint_dir=str(tmp_path), checkpoint_every=2)
    with faults.inject("poison-step", key=3):
        model, msgs = _warned(lambda: _fit(cfg, docs))
    assert torch.isfinite(model.u_).all()
    assert any("rolling back to chunk 2" in m for m in msgs)
    assert model.result_.n_iter == 6 and int(model.result_.health) == -1


def test_streaming_poison_under_a_budget_rolls_back(small_corpus, tmp_path):
    """A deviation from the reference, recorded in ROADMAP queue 3: under a
    top-t budget a NaN-poisoned U gives an all-NaN V, which the epilogue
    masks to zero, and the step stays finite; the reference's health index
    never sees it (no rollback), the port's also reads U's Gram and rolls
    back."""
    sp = ref_to_scipy(small_corpus)
    kw = dict(k=3, iters=4, seed=1, solver="streaming", chunk_docs=8,
              checkpoint_every=2)
    with ref_faults.inject("poison-step", key=3) as fault:
        _, ref_msgs = _warned(lambda: RefNMF(RefConfig(
            **kw, sparsity=RefSparsity(t_u=40, t_v=30),
            checkpoint_dir=str(tmp_path / "r"))).fit(sp))
    assert fault.fired == 1 and not any("rolling" in m for m in ref_msgs)
    with faults.inject("poison-step", key=3):
        model, msgs = _warned(lambda: _fit(NMFConfig(
            **kw, sparsity=Sparsity(t_u=40, t_v=30),
            checkpoint_dir=str(tmp_path / "p")), sp))
    assert any("at chunk 3" in m and "rolling back to chunk 2" in m
               for m in msgs)
    assert torch.isfinite(model.u_).all() and model.result_.n_iter == 5


@pytest.mark.parametrize("mode", ["raise", "rollback"])
def test_streaming_tol_stop_reads_the_health_index(small_corpus, mode):
    """A tolerance met on a poisoned stream is no convergence: under a top-t
    budget the poisoned step stays finite, and the stop reads the health
    index first (it raises, or rolls back and replays)."""
    cfg = NMFConfig(k=3, iters=4, seed=1, solver="streaming", chunk_docs=8,
                    tol=1e3, sparsity=Sparsity(t_u=40, t_v=30),
                    on_unhealthy=mode)
    sp = ref_to_scipy(small_corpus)
    with faults.inject("poison-step", key=0):
        if mode == "raise":
            with pytest.raises(FitHealthError, match="at chunk 0"):
                _fit(cfg, sp)
            return
        model, msgs = _warned(lambda: _fit(cfg, sp))
    assert sum("rolling back to chunk 0" in m for m in msgs) == 1
    assert model.result_.converged and int(model.result_.health) == -1
    assert torch.isfinite(model.u_).all()


def test_on_unhealthy_raise_surfaces_the_failure(docs, tmp_path):
    cfg = NMFConfig(k=3, iters=20, seed=1, on_unhealthy="raise",
                    checkpoint_dir=str(tmp_path), checkpoint_every=5)
    with faults.inject("poison-step", key=10):
        with pytest.raises(FitHealthError):
            _fit(cfg, docs)


def test_rollback_budget_exhaustion_raises(docs, tmp_path):
    # the poison fires again on every replay, so rollbacks never win
    cfg = NMFConfig(k=3, iters=20, seed=1, max_rollbacks=2,
                    checkpoint_dir=str(tmp_path), checkpoint_every=5)
    with faults.inject("poison-step", key=10, times=10):
        with pytest.raises(FitHealthError, match="gave up"):
            _fit(cfg, docs)


def test_health_monitor_reports_without_checkpointing(docs):
    cfg = NMFConfig(k=3, iters=20, seed=1, on_unhealthy="raise")
    with faults.inject("poison-step", key=0):
        with pytest.raises(FitHealthError):
            _fit(cfg, docs)


def test_reseed_perturbation_is_seeded_and_keeps_zeros():
    from repro_torch.nmf.solvers import _reseed_perturb

    u = torch.tensor([[0.0, 2.0], [3.0, 0.0]])
    a = _reseed_perturb(u, 7, 1, torch.device(CPU))
    assert torch.equal(a, _reseed_perturb(u.numpy(), 7, 1,
                                          torch.device(CPU)))
    assert not torch.equal(a, _reseed_perturb(u, 7, 2, torch.device(CPU)))
    assert torch.equal(a == 0, u == 0)
    ratio = a[u != 0] / u[u != 0]
    assert bool(((ratio >= 0.9) & (ratio < 1.1)).all())


# ---------------------------------------------------------------------------
# corpus integrity and the retry / skip ladder
# ---------------------------------------------------------------------------

def test_corrupted_shard_detected_on_load(small_corpus, tmp_path):
    out = write_corpus(small_corpus, tmp_path / "c", chunk_docs=8)
    shard = out / "shard-00001.values.npy"
    raw = bytearray(shard.read_bytes())
    raw[-1] ^= 0xFF
    shard.write_bytes(bytes(raw))
    corpus = open_corpus(out)
    corpus.load(0)  # an intact shard loads
    with pytest.raises(CorpusIntegrityError, match="shard 1"):
        corpus.load(1)


def test_injected_shard_corruption_fails_the_fit(small_corpus, tmp_path):
    out = write_corpus(small_corpus, tmp_path / "c", chunk_docs=8)
    cfg = NMFConfig(k=3, iters=4, seed=1, solver="streaming", chunk_docs=8)
    with faults.inject("corrupt-shard", key=1):
        with pytest.raises(ChunkPackError) as ei:
            _fit(cfg, str(out))
    assert isinstance(ei.value.__cause__, CorpusIntegrityError)


def test_skip_hatch_survives_a_corrupt_shard(small_corpus, tmp_path,
                                             monkeypatch):
    out = write_corpus(small_corpus, tmp_path / "c", chunk_docs=8)
    monkeypatch.setenv(SKIP_BAD_CHUNKS_ENV, "1")
    cfg = NMFConfig(k=3, iters=4, seed=1, solver="streaming", chunk_docs=8)
    with faults.inject("corrupt-shard", key=1):
        model, msgs = _warned(lambda: _fit(cfg, str(out)))
    assert torch.isfinite(model.u_).all()
    assert any("skipping" in m for m in msgs)
    assert model.result_.stream_stats["fit"]["skipped"] == 1


def test_skip_hatch_keeps_schedule_positions(small_corpus, tmp_path,
                                             monkeypatch):
    """A deviation from the reference, recorded in ROADMAP queue 3: after a
    skipped chunk the reference zips schedule positions with the shorter
    stream, so the poison hook (and the snapshot counts and the end-of-
    stream health read) name the wrong chunk, and a shard that stays
    unreadable fails its statistics' seed.  The port's staged chunks carry
    their schedule index: chunk 4 is poisoned as chunk 4, the fit survives
    a shard that is unreadable on every load, and the skipped documents get
    zero loadings in a V of m rows."""
    out = write_corpus(small_corpus, tmp_path / "c", chunk_docs=8)
    monkeypatch.setenv(SKIP_BAD_CHUNKS_ENV, "1")
    kw = dict(k=3, iters=4, seed=1, solver="streaming", chunk_docs=8,
              on_unhealthy="raise", sparsity={})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with ref_faults.inject("corrupt-shard", key=1):
            with ref_faults.inject("poison-step", key=4) as ref_poison:
                RefNMF(RefConfig(**kw | {"sparsity": RefSparsity()})).fit(
                    str(out))
        assert ref_poison.fired == 0      # the reference's shifted positions
        with ref_faults.inject("corrupt-shard", key=1, times=100):
            with pytest.raises(RefIntegrityError):
                RefNMF(RefConfig(**kw | {"sparsity": RefSparsity()})).fit(
                    str(out))
        port_kw = kw | {"sparsity": Sparsity()}
        with faults.inject("corrupt-shard", key=1):
            with faults.inject("poison-step", key=4):
                with pytest.raises(FitHealthError, match="at chunk 4"):
                    _fit(NMFConfig(**port_kw), str(out))
        with faults.inject("corrupt-shard", key=1, times=100):
            model = _fit(NMFConfig(**port_kw), str(out))
    assert model.result_.n_iter == 4 and model.v_.shape == (40, 3)
    assert not model.v_[8:16].any() and model.v_[:8].any()
    assert torch.isfinite(model.u_).all()


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    ValueError("bad chunk"),
])
def test_skip_hatch_never_swallows_other_errors(exc, monkeypatch):
    """Only an unreadable chunk is skipped; a CUDA error (or any other
    failure) raises even with the hatch open, where the reference's hatch
    skips every exception."""
    monkeypatch.setenv(SKIP_BAD_CHUNKS_ENV, "1")

    def pack(i):
        if i == 1:
            raise exc
        return i

    for enabled in (True, False):
        with pytest.raises(ChunkPackError) as ei:
            list(Prefetcher(range(3), pack, enabled=enabled, retries=0))
        assert ei.value.__cause__ is exc and ei.value.index == 1


def test_skip_hatch_skips_exhausted_io_errors(monkeypatch):
    monkeypatch.setenv(SKIP_BAD_CHUNKS_ENV, "1")

    def pack(i):
        if i == 1:
            raise OSError("mount gone")
        return i

    pf = Prefetcher(range(4), pack, retries=1, retry_backoff=0.001)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert list(pf) == [0, 2, 3]
    assert pf.stats["skipped"] == 1 and pf.stats["retries"] == 1


def test_transient_io_error_is_retried_to_success(small_corpus, tmp_path):
    out = write_corpus(small_corpus, tmp_path / "c", chunk_docs=8)
    cfg = NMFConfig(k=3, iters=4, seed=1, solver="streaming", chunk_docs=8)
    ref = _fit(cfg, str(out))
    # chunk 2 fails twice (within the default retry budget), then loads
    with faults.inject("chunk-load", key=2, times=2):
        model = _fit(cfg, str(out))
    assert torch.equal(ref.u_, model.u_)
    assert model.result_.stream_stats["fit"]["retries"] == 2


def test_chunk_pack_error_carries_context():
    def pack(i):
        raise OSError("mount gone")
    pf = Prefetcher([7, 8], pack, retries=1, retry_backoff=0.001)
    with pytest.raises(ChunkPackError) as ei:
        list(pf)
    assert ei.value.item == 7 and ei.value.index == 0
    assert isinstance(ei.value.__cause__, OSError)
    assert pf.stats["retries"] == 1


def test_prefetch_worker_silent_death_watchdog():
    with faults.inject("prefetch-worker", key=1):
        pf = Prefetcher([0, 1, 2], lambda i: i, depth=2)
        it = iter(pf)
        assert next(it) == 0
        with pytest.raises(RuntimeError, match="died without reporting"):
            list(it)


def test_consumer_raise_stops_the_worker():
    def pack(i):
        if i == 1:
            raise ValueError("bad chunk")
        return i
    pf = Prefetcher(range(10), pack, retries=0)
    with pytest.raises(ChunkPackError):
        list(pf)
    assert pf._stop.is_set()
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# process-kill realism: os._exit after a checkpoint commit, then resume
# ---------------------------------------------------------------------------

_KILL_FIT = """
import numpy as np
from repro_torch.nmf import EnforcedNMF, NMFConfig
from repro_torch.robustness import faults

rng = np.random.default_rng(0)
a = np.abs(rng.normal(size=(16, 48))).astype(np.float32)
cfg = NMFConfig(k=3, iters=20, seed=1, checkpoint_dir={d!r},
                checkpoint_every=5)
with faults.inject("kill", key=10):
    EnforcedNMF(cfg, device="cpu").fit(a)
raise SystemExit("kill fault never fired")
"""

_RESUME_FIT = """
import numpy as np
import torch
from repro_torch.nmf import EnforcedNMF, NMFConfig

rng = np.random.default_rng(0)
a = np.abs(rng.normal(size=(16, 48))).astype(np.float32)
cfg = NMFConfig(k=3, iters=20, seed=1, checkpoint_dir={d!r},
                checkpoint_every=5)
model = EnforcedNMF(cfg, device="cpu").fit(a, resume=True)
ref = EnforcedNMF(NMFConfig(k=3, iters=20, seed=1), device="cpu").fit(a)
assert torch.equal(ref.u_, model.u_), "resumed factors diverged"
print("PARITY-OK")
"""


def test_subprocess_kill_exits_with_kill_code_and_resumes(tmp_path):
    d = str(tmp_path)
    run_subprocess(_KILL_FIT.format(d=d), expect=KILL_EXIT)
    assert "PARITY-OK" in run_subprocess(_RESUME_FIT.format(d=d))


# ---------------------------------------------------------------------------
# the NMF command line
# ---------------------------------------------------------------------------

_CLI = ["--config", "reuters", "--small", "--device", "cpu"]


def _numbers(out):
    """The fit's printed numbers (everything after the wall time)."""
    line = [ln for ln in out.splitlines() if "final error" in ln][-1]
    return line[line.index("final error"):]


def test_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import nmf_run

    nmf_run.main(_CLI + ["--iters", "5"])
    out = capsys.readouterr().out
    assert "building 803x248 synthetic corpus" in out
    assert "solver=enforced: 5 iterations" in out and "NNZ(U)=" in out


def test_cli_refuses_a_mesh_and_a_bare_resume(capsys):
    from repro_torch.launch import nmf_run

    # a mesh needs its ranks: a single process is refused, not run on one
    # device
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        nmf_run.main(_CLI + ["--mesh", "2x2"])
    with pytest.raises(SystemExit):
        nmf_run.main(_CLI + ["--resume"])
    assert "--resume needs --checkpoint-dir" in capsys.readouterr().err


def test_cli_killed_then_resumed_prints_the_uninterrupted_numbers(
        tmp_path, capsys):
    from repro_torch.launch import nmf_run

    d = str(tmp_path / "ckpt")
    argv = _CLI + ["--iters", "6", "--t-u", "400", "--checkpoint-dir", d,
                   "--checkpoint-every", "3"]
    run_subprocess(f"""
        from repro_torch.launch import nmf_run
        from repro_torch.robustness import faults
        faults.install("kill", key=3)
        nmf_run.main({argv!r})
        raise SystemExit("kill fault never fired")
        """, expect=KILL_EXIT)
    resumed = run_subprocess(None, args=["-m", "repro_torch.launch.nmf_run"]
                             + argv + ["--resume"])
    nmf_run.main(_CLI + ["--iters", "6", "--t-u", "400"])
    assert _numbers(resumed) == _numbers(capsys.readouterr().out)
