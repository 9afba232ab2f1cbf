"""Port parity for the sequential solver (paper Alg. 3) and the legacy
Alg. 2 front door, against the reference (``repro.core.sequential``,
``repro.core.enforced``, ``solver="sequential"``) on the same numpy inputs:
residual and error traces and factors within 1e-4, nnz equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.enforced import enforced_sparsity_nmf as ref_enforced
from repro.data import synthetic_journal_corpus as ref_corpus
from repro.nmf import EnforcedNMF as RefNMF
from repro.nmf import NMFConfig as RefConfig
from repro.nmf import Sparsity as RefSparsity
from repro.sparse import to_scipy
from repro_torch.backend import get_backend
from repro_torch.core.enforced import (
    columnwise_topt, enforced_sparsity_nmf, global_topt, global_topt_exact,
)
from repro_torch.core.sequential import sequential_als_nmf
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
from repro_torch.nmf.solvers import solve_sequential

K, N, M = 4, 160, 120


@pytest.fixture(scope="module")
def corpus():
    a, _ = ref_corpus(n_terms=N, n_docs=M, n_journals=4, seed=7)
    return to_scipy(a)


@pytest.fixture(scope="module")
def u0():
    return np.random.default_rng(4).random((N, K)).astype(np.float32)


@pytest.mark.parametrize("block_size,backend,ref_backend,u0_cols", [
    (1, None, None, K), (2, "torch-csr", "jnp-csr", 2),
    (1, "torch-dense", "jnp-dense", 1), (4, "jnp-csr", "jnp-csr", K)])
def test_sequential_solver_matches_reference(corpus, u0, block_size,
                                             backend, ref_backend, u0_cols):
    sp = dict(t_u=60, t_v=40)
    cfg = NMFConfig(k=K, iters=5, solver="sequential", block_size=block_size,
                    backend=backend, sparsity=Sparsity(**sp))
    rcfg = RefConfig(k=K, iters=5, solver="sequential",
                     block_size=block_size, backend=ref_backend,
                     sparsity=RefSparsity(**sp))
    model = EnforcedNMF(cfg, device="cpu").fit(corpus, u0=u0[:, :u0_cols])
    ref = RefNMF(rcfg).fit(corpus, u0=jnp.asarray(u0[:, :u0_cols]))
    res, rres = model.result_, ref.result_
    assert res.error_granularity == rres.error_granularity == "block"
    assert res.n_iter == rres.n_iter == 5 * (K // block_size)
    np.testing.assert_allclose(res.residual.numpy(),
                               np.asarray(rres.residual), atol=1e-4)
    np.testing.assert_allclose(res.error.numpy(), np.asarray(rres.error),
                               atol=1e-4)
    np.testing.assert_allclose(model.u_.numpy(), np.asarray(ref.u_),
                               atol=1e-4)
    np.testing.assert_allclose(model.v_.numpy(), np.asarray(ref.v_),
                               atol=1e-4)
    assert int(res.max_nnz) == int(rres.max_nnz)
    assert res.final_nnz_u == rres.final_nnz_u


def test_sequential_groups_resume_one_long_run(corpus, u0):
    """``total_blocks`` / ``carry_u`` / ``carry_v`` / ``start_block``: two
    groups of blocks are the one long run."""
    a = get_backend("torch-csr").prepare(corpus, device="cpu")
    first = torch.from_numpy(u0[:, :1])
    whole = sequential_als_nmf(a, first, k2=1, blocks=K, iters=4, t_u=60)
    g1 = sequential_als_nmf(a, first, k2=1, blocks=2, iters=4, t_u=60,
                            total_blocks=K)
    g2 = sequential_als_nmf(a, first, k2=1, blocks=2, iters=4, t_u=60,
                            total_blocks=K, carry_u=g1.u, carry_v=g1.v,
                            start_block=2)
    assert torch.equal(g2.u, whole.u) and torch.equal(g2.v, whole.v)
    assert torch.equal(torch.cat([g1.residual, g2.residual]), whole.residual)
    assert torch.equal(g1.u[:, 2:], torch.zeros((N, 2)))  # carried, not cut
    no_err = sequential_als_nmf(a, first, blocks=2, iters=2,
                                track_error=False)
    assert float(no_err.error.abs().sum()) == 0.0


def test_sequential_refusals(corpus, u0):
    with pytest.raises(ValueError, match="not supported by the sequential"):
        NMFConfig(k=K, solver="sequential", backend="cuda-bsr")
    with pytest.raises(ValueError, match="not supported by the sequential"):
        NMFConfig(k=K, solver="sequential", backend="pallas-bsr")
    with pytest.raises(ValueError, match="must divide"):
        NMFConfig(k=K, solver="sequential", block_size=3)
    op = get_backend("cuda-bsr").prepare(corpus, device="cpu")
    with pytest.raises(TypeError, match="BSR operands"):
        solve_sequential(op, NMFConfig(k=K, solver="sequential"),
                         torch.from_numpy(u0))
    with pytest.raises(ValueError, match="columns"):
        EnforcedNMF(NMFConfig(k=K, solver="sequential", block_size=2),
                    device="cpu").fit(corpus, u0=u0[:, :3])
    # the default initial guess is one block wide
    m = EnforcedNMF(NMFConfig(k=K, iters=2, solver="sequential"),
                    device="cpu").fit(corpus)
    assert m.u_.shape == (N, K) and m.result_.n_iter == 2 * K


@pytest.mark.parametrize("kw", [dict(t_u=60, t_v=300),
                                dict(t_u=60, exact=True),
                                dict(t_v=20, columnwise=True),
                                dict()])
def test_enforced_front_door_matches_reference(corpus, u0, kw):
    dense = corpus.toarray()
    res = enforced_sparsity_nmf(torch.from_numpy(dense),
                                torch.from_numpy(u0), iters=6, **kw)
    ref = ref_enforced(jnp.asarray(dense), jnp.asarray(u0), iters=6, **kw)
    np.testing.assert_allclose(res.error.numpy(), np.asarray(ref.error),
                               atol=1e-4)
    np.testing.assert_allclose(res.u.numpy(), np.asarray(ref.u), atol=1e-4)
    np.testing.assert_array_equal(res.nnz_u.numpy(), np.asarray(ref.nnz_u))
    np.testing.assert_array_equal(res.nnz_v.numpy(), np.asarray(ref.nnz_v))
    x = torch.tensor([[3.0, -1.0], [0.5, 2.0], [-4.0, 0.1]])
    assert int((global_topt(2)(x) != 0).sum()) == 2
    assert int((global_topt_exact(3)(x) != 0).sum()) == 3
    assert (columnwise_topt(1)(x) != 0).sum(0).tolist() == [1, 1]
