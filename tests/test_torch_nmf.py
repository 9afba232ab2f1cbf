"""Port parity for the slice end to end: the ALS engine, the estimator's
``fit`` / ``transform`` / ``score``, backends and configuration.

The reference runs ``pallas-bsr`` with its Pallas kernels in interpret mode;
the port runs ``cuda-bsr`` on ``device="cpu"`` (plain versions).  Both get
the same numpy ``u0``.  Residual and error traces agree within 1e-4
(``tests/test_backends.py``'s end-to-end bar); nnz traces and the health
index are equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import get_backend as ref_get_backend
from repro.core.nmf import als_nmf as ref_als_nmf
from repro.core.nmf import solve_gram as ref_solve_gram
from repro.nmf import EnforcedNMF as RefNMF
from repro.nmf import NMFConfig as RefConfig
from repro.nmf import Sparsity as RefSparsity
from repro.sparse import to_scipy
from repro_torch.backend import (
    available_backends, default_backend_name, get_backend, resolve_backend,
    select_backend,
)
from repro_torch.convert import estimator_from_reference
from repro_torch.core.nmf import als_nmf, init_u0, solve_gram
from repro_torch.kernels import _build
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity, available_solvers
from repro_torch.nmf.solvers import FitHealthError

K, T_U, T_V = 5, 55, 600


@pytest.fixture(scope="module")
def corpus():
    from repro.data import synthetic_journal_corpus

    a, _ = synthetic_journal_corpus(n_terms=300, n_docs=200, n_journals=5,
                                    seed=1)
    return to_scipy(a)


@pytest.fixture(scope="module")
def unseen():
    from repro.data import synthetic_journal_corpus

    a, _ = synthetic_journal_corpus(n_terms=300, n_docs=40, n_journals=5,
                                    seed=2)
    return to_scipy(a)


@pytest.fixture(scope="module")
def u0():
    return np.random.default_rng(0).random((300, K)).astype(np.float32)


@pytest.fixture(scope="module")
def ref_fit(corpus, u0):
    cfg = RefConfig(k=K, iters=8, solver="enforced", backend="pallas-bsr",
                    sparsity=RefSparsity(t_u=T_U, t_v=T_V))
    return RefNMF(cfg).fit(corpus, u0=jnp.asarray(u0))


def _port_cfg(**kw):
    base = dict(k=K, iters=8, solver="enforced",
                sparsity=Sparsity(t_u=T_U, t_v=T_V), backend="cuda-bsr")
    base.update(kw)
    return NMFConfig(**base)


def test_solve_gram_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.random((50, 4)).astype(np.float32)
    g = x.T @ x
    rhs = rng.standard_normal((70, 4)).astype(np.float32)
    got = solve_gram(torch.from_numpy(g), torch.from_numpy(rhs))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_solve_gram(
        jnp.asarray(g), jnp.asarray(rhs))), rtol=1e-4, atol=1e-5)
    bad = solve_gram(torch.full((4, 4), float("nan")), torch.from_numpy(rhs))
    assert not torch.isfinite(bad).any()


def test_estimator_fit_matches_reference(corpus, u0, ref_fit):
    """Acceptance: the slice end to end at 300 x 200, k=5, 8 iterations."""
    _build.reset_launch_counts()
    model = EnforcedNMF(_port_cfg(), device="cpu").fit(corpus, u0=u0)
    res, ref = model.result_, ref_fit.result_
    np.testing.assert_allclose(res.residual.numpy(), np.asarray(ref.residual),
                               atol=1e-4)
    np.testing.assert_allclose(res.error.numpy(), np.asarray(ref.error),
                               atol=1e-4)
    np.testing.assert_array_equal(res.nnz_u.numpy(), np.asarray(ref.nnz_u))
    np.testing.assert_array_equal(res.nnz_v.numpy(), np.asarray(ref.nnz_v))
    assert int(res.max_nnz) == int(ref.max_nnz)
    assert int(res.health) == -1 and res.n_iter == ref.n_iter == 8
    np.testing.assert_allclose(model.u_.numpy(), np.asarray(ref_fit.u_),
                               atol=1e-4)
    np.testing.assert_allclose(model._av_acc.numpy(),
                               np.asarray(ref_fit._av_acc), atol=1e-4)
    np.testing.assert_allclose(model._gv_acc.numpy(),
                               np.asarray(ref_fit._gv_acc), rtol=1e-5,
                               atol=1e-4)
    # CPU tensors run the plain versions: no kernel was launched
    assert sum(_build.launch_counts().values()) == 0


@pytest.mark.parametrize("backend,ref_backend", [
    ("cuda-bsr", "pallas-bsr"), ("cuda-bsr-unfused", "pallas-bsr-unfused"),
    ("torch-dense", "jnp-dense")])
def test_engine_matches_reference_with_health(corpus, u0, backend,
                                              ref_backend):
    be = get_backend(backend)
    op = be.prepare(corpus, dtype=torch.float32, device="cpu")
    ref_be = ref_get_backend(ref_backend)
    ref_op = ref_be.prepare(corpus, dtype=jnp.float32)
    sp = Sparsity(t_u=T_U, t_v=T_V)
    rsp = RefSparsity(t_u=T_U, t_v=T_V)
    res = als_nmf(op, torch.from_numpy(u0), iters=6,
                  sparsify_u=sp.sparsifier(300, K, "u", be.fuse_epilogue),
                  sparsify_v=sp.sparsifier(200, K, "v", be.fuse_epilogue),
                  backend=backend)
    ref = ref_als_nmf(
        ref_op, jnp.asarray(u0), iters=6,
        sparsify_u=rsp.sparsifier(300, K, "u", ref_be.fuse_epilogue),
        sparsify_v=rsp.sparsifier(200, K, "v", ref_be.fuse_epilogue),
        backend=ref_backend)
    np.testing.assert_allclose(res.residual.numpy(), np.asarray(ref.residual),
                               atol=1e-4)
    np.testing.assert_allclose(res.error.numpy(), np.asarray(ref.error),
                               atol=1e-4)
    np.testing.assert_array_equal(res.nnz_u.numpy(), np.asarray(ref.nnz_u))
    np.testing.assert_array_equal(res.nnz_v.numpy(), np.asarray(ref.nnz_v))
    assert int(res.health) == int(ref.health) == -1


def test_transform_and_score_match_reference(corpus, unseen, ref_fit):
    """``transform`` of unseen documents through a port estimator built from
    the reference model's factors."""
    model = estimator_from_reference(np.asarray(ref_fit.u_),
                                     np.asarray(ref_fit.v_), 200, _port_cfg(),
                                     device="cpu")
    v_new = model.transform(unseen)
    want = np.asarray(ref_fit.transform(unseen))
    assert v_new.shape == (40, K)
    np.testing.assert_allclose(v_new.numpy(), want, atol=1e-4)
    np.testing.assert_array_equal(v_new.numpy() != 0, want != 0)
    assert model.score(unseen) == pytest.approx(ref_fit.score(unseen),
                                                abs=1e-4)
    assert model.score(corpus) == pytest.approx(ref_fit.score(corpus),
                                                abs=1e-4)


def test_fit_transform_tol_and_dense_input(corpus, u0):
    model = EnforcedNMF(_port_cfg(iters=40, tol=5e-2), device="cpu")
    v = model.fit_transform(corpus, u0=u0)
    assert v.shape == (200, K) and model.result_.converged
    assert model.n_iter_ < 40 and model.n_iter_ % 10 == 0
    assert model.result_.residual.shape == (model.n_iter_,)
    ref = RefNMF(RefConfig(k=K, iters=40, tol=5e-2, backend="pallas-bsr",
                           sparsity=RefSparsity(t_u=T_U, t_v=T_V))).fit(
        corpus, u0=jnp.asarray(u0))
    assert model.n_iter_ == ref.n_iter_
    dense = corpus.toarray()
    m_dense = EnforcedNMF(_port_cfg(backend=None), device="cpu").fit(
        dense, u0=u0)
    m_bsr = EnforcedNMF(_port_cfg(), device="cpu").fit(corpus, u0=u0)
    np.testing.assert_allclose(m_dense.result_.error.numpy(),
                               m_bsr.result_.error.numpy(), atol=1e-4)


def test_default_init_and_sparse_default_backend(corpus):
    model = EnforcedNMF(_port_cfg(backend=None, iters=3), device="cpu")
    model.fit(corpus)
    assert model.u_.shape == (300, K) and model.v_.shape == (200, K)
    assert resolve_backend(model._coerce(corpus)).name == "cuda-bsr"
    gen = torch.Generator().manual_seed(0)
    u = init_u0(gen, 30, 4, device="cpu")
    assert u.shape == (30, 4) and float(u.min()) >= 0 and float(u.max()) < 1
    assert int((init_u0(torch.Generator().manual_seed(1), 30, 4, nnz=9,
                        device="cpu") != 0).sum()) == 9


def test_unhealthy_fit_raises_and_ignore_keeps_going(corpus, u0):
    bad = u0.copy()
    bad[0, 0] = np.nan
    with pytest.raises(FitHealthError, match="iteration 0"):
        EnforcedNMF(_port_cfg(iters=3), device="cpu").fit(corpus, u0=bad)
    model = EnforcedNMF(_port_cfg(iters=3, on_unhealthy="ignore"),
                        device="cpu").fit(corpus, u0=bad)
    assert int(model.result_.health) == 0


def test_config_and_registry():
    assert {"cuda-bsr", "cuda-bsr-unfused", "torch-dense", "pallas-bsr",
            "pallas-bsr-unfused", "jnp-dense"} <= set(available_backends())
    assert get_backend("pallas-bsr") is get_backend("cuda-bsr")
    assert get_backend("jnp-dense").name == "torch-dense"
    assert not get_backend("pallas-bsr-unfused").fuse_halfstep
    with pytest.raises(ValueError, match="unknown backend"):
        NMFConfig(backend="bogus")
    # the reference's validation of the fault-tolerance fields
    assert NMFConfig().on_unhealthy == "rollback"
    assert NMFConfig(checkpoint_dir="/nowhere").checkpoint_every == 10
    with pytest.raises(ValueError, match="checkpoint_every"):
        NMFConfig(checkpoint_every=0)
    with pytest.raises(ValueError, match="needs checkpoint_dir"):
        NMFConfig(resume=True)
    with pytest.raises(ValueError, match="max_rollbacks"):
        NMFConfig(max_rollbacks=-1)
    with pytest.raises(ValueError, match="on_unhealthy"):
        NMFConfig(on_unhealthy="retry")
    # the sequential solver refuses the BSR backend, and a corpus
    # directory needs the streaming solver
    with pytest.raises(ValueError, match="not supported by the sequential"):
        NMFConfig(solver="sequential", backend="cuda-bsr")
    with pytest.raises(ValueError, match="solver='streaming'"):
        EnforcedNMF(NMFConfig(solver="enforced"), device="cpu").fit(
            "/nowhere/corpus")
    with pytest.raises(ValueError, match="unknown solver"):
        EnforcedNMF(NMFConfig(solver="bogus"), device="cpu").fit(
            np.ones((4, 3), np.float32))
    assert "distributed" in available_solvers()
    assert select_backend(torch.ones(2, 2)).name == "torch-dense"
    with pytest.raises(TypeError, match="cannot consume"):
        resolve_backend(torch.ones(2, 2), "cuda-bsr")
    import scipy.sparse as sps

    assert default_backend_name(sps.eye(3, format="csr")) == "cuda-bsr"
    sp = Sparsity(frac_u=0.02, mode="columnwise")
    assert sp.resolve(100, 5, "u") == 2 and sp.resolve(100, 5, "v") is None
    assert Sparsity(t_v=10).sparsifier(20, 2, "v", fused=True).fuses_relu
