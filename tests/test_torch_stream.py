"""Port parity for the streaming engine: ``online_als_step``, a
``partial_fit`` stream and the ``streaming`` solver, against the reference
(``repro.core.online``, ``repro.nmf``) on the same numpy inputs.

Tolerances only (1e-4 on factors and traces, the end-to-end bar of
``tests/test_backends.py:365-380``; equal nnz): the reference's own
bit-exactness test of its streaming loop fails.  The port's ``cuda-bsr``
runs its kernels' plain versions on the CPU; the reference's
``pallas-bsr`` runs in interpret mode, so it gets one small case."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.online import OnlineStats as RefStats
from repro.core.online import online_als_step as ref_step
from repro.data import synthetic_journal_corpus as ref_corpus
from repro.backend import get_backend as ref_get_backend
from repro.nmf import EnforcedNMF as RefNMF
from repro.nmf import NMFConfig as RefConfig
from repro.nmf import Sparsity as RefSparsity
from repro.sparse import to_scipy
from repro_torch.backend import get_backend
from repro_torch.core.online import (
    OnlineStats, init_online_stats, online_als_step,
)
from repro_torch.data.corpus import StagedChunk, stage_chunk
from repro_torch.kernels import _build
from repro_torch.nmf import EnforcedNMF, FitHealthError, NMFConfig, Sparsity

K, N, M = 4, 192, 120
T_U, T_V = 48, 240


@pytest.fixture(scope="module")
def corpus():
    a, _ = ref_corpus(n_terms=N, n_docs=M, n_journals=4, seed=11)
    return to_scipy(a)


@pytest.fixture(scope="module")
def u0():
    return np.random.default_rng(2).random((N, K)).astype(np.float32)


def _pair(corpus, backend, ref_backend, lo=0, hi=M):
    chunk = corpus[:, lo:hi].tocsr()
    return (get_backend(backend).prepare(chunk, dtype=torch.float32,
                                         device="cpu"),
            ref_get_backend(ref_backend).prepare(chunk, dtype=jnp.float32))


@pytest.mark.parametrize("backend,ref_backend,forget", [
    ("torch-csr", "jnp-csr", 1.0), ("torch-csr", "jnp-csr", 0.7),
    ("torch-dense", "jnp-dense", 1.0), ("cuda-bsr", "pallas-bsr", 1.0)])
def test_online_step_matches_reference(corpus, u0, backend, ref_backend,
                                       forget):
    """One step from seeded statistics, 3 inner passes, both factors
    enforced; the fused epilogue of the port's dense and BSR backends gives
    the reference's unfused factors."""
    op, rop = _pair(corpus, backend, ref_backend, 30, 90)
    rng = np.random.default_rng(5)
    av = rng.random((N, K)).astype(np.float32)
    g = rng.random((K + 3, K)).astype(np.float32)
    gv = g.T @ g
    be = get_backend(backend)
    sp, rsp = Sparsity(t_u=T_U, t_v=120), RefSparsity(t_u=T_U, t_v=120)
    res = online_als_step(
        op, torch.from_numpy(u0),
        OnlineStats(torch.from_numpy(av), torch.from_numpy(gv)), forget,
        iters=3, sparsify_u=sp.sparsifier(N, K, "u", be.fuse_epilogue),
        sparsify_v=sp.sparsifier(60, K, "v", be.fuse_epilogue),
        backend=backend)
    ref = ref_step(rop, jnp.asarray(u0), RefStats(jnp.asarray(av),
                                                  jnp.asarray(gv)),
                   forget, iters=3, sparsify_u=rsp.sparsifier(N, K, "u"),
                   sparsify_v=rsp.sparsifier(60, K, "v"),
                   backend=ref_backend)
    np.testing.assert_allclose(res.u.numpy(), np.asarray(ref.u), atol=1e-4)
    np.testing.assert_allclose(res.v.numpy(), np.asarray(ref.v), atol=1e-4)
    np.testing.assert_array_equal(res.u.numpy() != 0,
                                  np.asarray(ref.u) != 0)
    np.testing.assert_allclose(res.stats.av.numpy(), np.asarray(ref.stats.av),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(res.stats.gv.numpy(), np.asarray(ref.stats.gv),
                               rtol=1e-5, atol=1e-4)
    assert int(res.health) == int(ref.health) == -1
    assert res.health.dtype == torch.int32


def test_online_step_health_and_fresh_stats(corpus, u0):
    op, _ = _pair(corpus, "torch-csr", "jnp-csr", 0, 40)
    stats = init_online_stats(N, K, device="cpu")
    assert float(stats.av.abs().sum()) == 0 and stats.gv.shape == (K, K)
    bad = torch.from_numpy(u0).clone()
    bad[0, 0] = float("nan")
    res = online_als_step(op, bad, stats, iters=2)
    assert int(res.health) == 0
    ok = online_als_step(op, torch.from_numpy(u0), stats,
                         torch.tensor(1.0), iters=2)
    assert int(ok.health) == -1


@pytest.mark.parametrize("backend,ref_backend", [
    ("torch-csr", "jnp-csr"), ("cuda-bsr", "jnp-csr")])
def test_partial_fit_stream_matches_reference(corpus, u0, backend,
                                              ref_backend):
    """A 3-chunk ``partial_fit`` stream from one explicit first U; the
    per-chunk ``t_v`` is the reference's rescaled budget."""
    cfg = NMFConfig(k=K, iters=6, backend=backend,
                    sparsity=Sparsity(t_u=T_U, t_v=T_V))
    rcfg = RefConfig(k=K, iters=6, backend=ref_backend,
                     sparsity=RefSparsity(t_u=T_U, t_v=T_V))
    model = EnforcedNMF(cfg, device="cpu")
    ref = RefNMF(rcfg)
    model.u_, ref.u_ = torch.from_numpy(u0), jnp.asarray(u0)
    model.n_features_ = ref.n_features_ = N
    model._m_ref = ref._m_ref = M
    _build.reset_launch_counts()
    for lo, hi in ((0, 40), (40, 80), (80, 120)):
        chunk = corpus[:, lo:hi].tocsr()
        model.partial_fit(chunk)
        ref.partial_fit(chunk)
        np.testing.assert_allclose(model.u_.numpy(), np.asarray(ref.u_),
                                   atol=1e-4)
        np.testing.assert_allclose(model.v_.numpy(), np.asarray(ref.v_),
                                   atol=1e-4)
        assert int((model.v_ != 0).sum()) == int(np.sum(np.asarray(ref.v_)
                                                        != 0))
        assert int(model.health_) == int(ref.health_) == -1
    np.testing.assert_allclose(model._gv_acc.numpy(), np.asarray(ref._gv_acc),
                               rtol=1e-5, atol=1e-4)
    assert model.n_docs_seen_ == ref.n_docs_seen_ == M
    assert sum(_build.launch_counts().values()) == 0  # CPU: plain versions


def test_partial_fit_continues_a_fit(corpus, u0):
    """After a batch fit the statistics continue: gv grows by V_c^T V_c."""
    cfg = NMFConfig(k=K, iters=5, backend="cuda-bsr",
                    sparsity=Sparsity(t_u=T_U, t_v=T_V))
    model = EnforcedNMF(cfg, device="cpu").fit(corpus[:, :90], u0=u0)
    gv0 = model._gv_acc.clone()
    model.partial_fit(corpus[:, 90:])
    want = gv0 + model.v_.T @ model.v_
    np.testing.assert_allclose(model._gv_acc.numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert model.v_.shape == (30, K) and int(model.health_) == -1
    assert int((model.v_ != 0).sum()) <= round(T_V * 30 / 90) + 5
    with pytest.raises(ValueError, match="forget"):
        model.partial_fit(corpus[:, 90:], forget=0.0)
    with pytest.raises(ValueError, match="terms"):
        model.partial_fit(corpus[:50, 90:])


def _stream_cfgs(backend, ref_backend, **kw):
    base = dict(k=K, iters=4, solver="streaming", chunk_docs=30)
    return (NMFConfig(backend=backend, sparsity=Sparsity(t_u=T_U, t_v=T_V),
                      **(base | kw)),
            RefConfig(backend=ref_backend,
                      sparsity=RefSparsity(t_u=T_U, t_v=T_V), **base))


@pytest.mark.parametrize("backend,ref_backend,prefetch", [
    (None, None, True), ("torch-csr", "jnp-csr", False),
    ("cuda-bsr", "pallas-bsr", True)])
def test_streaming_solver_matches_reference(corpus, u0, backend, ref_backend,
                                            prefetch):
    cfg, rcfg = _stream_cfgs(backend, ref_backend, prefetch=prefetch)
    model = EnforcedNMF(cfg, device="cpu").fit(corpus, u0=u0)
    ref = RefNMF(rcfg).fit(corpus, u0=jnp.asarray(u0))
    res, rres = model.result_, ref.result_
    assert res.error_granularity == rres.error_granularity == "chunk"
    assert res.n_iter == rres.n_iter == 4
    np.testing.assert_allclose(res.residual.numpy(),
                               np.asarray(rres.residual), atol=1e-4)
    np.testing.assert_allclose(res.error.numpy(), np.asarray(rres.error),
                               atol=1e-4)
    np.testing.assert_array_equal(res.nnz_u.numpy(), np.asarray(rres.nnz_u))
    np.testing.assert_array_equal(res.nnz_v.numpy(), np.asarray(rres.nnz_v))
    assert int(res.max_nnz) == int(rres.max_nnz)
    np.testing.assert_allclose(model.u_.numpy(), np.asarray(ref.u_),
                               atol=1e-4)
    np.testing.assert_allclose(model.v_.numpy(), np.asarray(ref.v_),
                               atol=1e-4)
    np.testing.assert_allclose(model._av_acc.numpy(),
                               np.asarray(ref._av_acc), atol=1e-4)
    assert res.stream_stats["fit"]["packed"] == 4
    assert res.stream_stats["fold_in"]["packed"] == 4
    assert int(res.health) == -1


def test_streaming_per_document_nnz_matches_batch(corpus, u0):
    """``t_v`` resolves against the whole corpus and is rescaled per chunk,
    so per-document V sparsity matches a batch fit (the reference's rule,
    ``tests/test_streaming.py:161``)."""
    sp = Sparsity(t_u=T_U, t_v=T_V)
    batch = EnforcedNMF(NMFConfig(k=K, iters=30, sparsity=sp,
                                  backend="torch-csr"),
                        device="cpu").fit(corpus, u0=u0)
    stream = EnforcedNMF(NMFConfig(k=K, iters=30, solver="streaming",
                                   chunk_docs=30, sparsity=sp),
                         device="cpu").fit(corpus, u0=u0)
    nnz_b = int((batch.v_ != 0).sum())
    nnz_s = int((stream.v_ != 0).sum())
    assert nnz_s <= T_V + 5
    assert abs(nnz_s - nnz_b) <= 0.1 * T_V


def test_streaming_tol_health_and_refusals(corpus, u0):
    cfg, _ = _stream_cfgs(None, None, tol=0.5, iters=10)
    model = EnforcedNMF(cfg, device="cpu").fit(corpus, u0=u0)
    assert model.result_.converged and model.n_iter_ < 4
    assert model.v_.shape == (M, K)   # the fold-in covers the whole corpus
    bad = u0.copy()
    bad[0, 0] = np.nan
    # with no sparsity the NaN reaches the factors (a top-t mask drops it)
    dense_cfg = cfg.replace(tol=0.0, sparsity=Sparsity())
    with pytest.raises(FitHealthError, match="chunk 0"):
        EnforcedNMF(dense_cfg, device="cpu").fit(corpus, u0=bad)
    kept = EnforcedNMF(dense_cfg.replace(on_unhealthy="ignore"),
                       device="cpu").fit(corpus, u0=bad)
    assert int(kept.result_.health) == 0
    op = get_backend("cuda-bsr").prepare(corpus, device="cpu")
    with pytest.raises(TypeError, match="BSR operands"):
        EnforcedNMF(cfg, device="cpu").fit(op, u0=u0)


def test_staged_chunk_on_the_cpu(corpus):
    """On the CPU the pack is the plain ingest, and ``use`` returns it."""
    from repro_torch.sparse import from_scipy

    host = from_scipy(corpus[:, :30])
    staged = stage_chunk(host, get_backend("torch-csr"), torch.device("cpu"))
    assert isinstance(staged, StagedChunk) and staged.ready is None
    assert staged.use().values.data_ptr() == host.values.data_ptr()
    bsr = stage_chunk(host, get_backend("cuda-bsr"), torch.device("cpu"))
    assert bsr.use().shape == (N, 30)
