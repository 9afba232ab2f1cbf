"""Port parity: synthetic corpus, padded-CSR ingest and its products.

The same numpy inputs go through the reference package and the port;
corpora and the ``values`` / ``cols`` arrays must be bitwise equal, the
products agree to 1e-5 (``tests/test_backends.py``'s csr bar)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from repro.data import synthetic_journal_corpus as ref_corpus
from repro.sparse import csr as ref_csr
from repro_torch.data import synthetic_journal_corpus, synthetic_corpus_matrix
from repro_torch.data.textpipe import normalize_rows_by_nnz
from repro_torch.sparse import csr


@pytest.mark.parametrize("n_terms,n_docs,seed", [(300, 200, 1), (257, 61, 7)])
def test_synthetic_corpus_bitwise(n_terms, n_docs, seed):
    a, dj = synthetic_journal_corpus(n_terms=n_terms, n_docs=n_docs,
                                     seed=seed)
    b, dj_ref = ref_corpus(n_terms=n_terms, n_docs=n_docs, seed=seed)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.values.numpy(), np.asarray(b.values))
    np.testing.assert_array_equal(a.cols.numpy(), np.asarray(b.cols))
    np.testing.assert_array_equal(dj, dj_ref)
    assert a.values.dtype == torch.float32 and a.cols.dtype == torch.int32


def test_corpus_matrix_and_cap_truncation_bitwise():
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        a = synthetic_corpus_matrix(n_terms=200, n_docs=90, cap=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b, _ = ref_corpus(n_terms=200, n_docs=90, n_journals=5, cap=5)
    assert any("cap=5" in str(w.message) for w in got)
    np.testing.assert_array_equal(a.values.numpy(), np.asarray(b.values))
    np.testing.assert_array_equal(a.cols.numpy(), np.asarray(b.cols))


@pytest.mark.parametrize("cap", [None, 3])
def test_from_scipy_and_from_coo_bitwise(cap):
    rng = np.random.default_rng(4)
    m = sps.random(40, 30, density=0.2, random_state=5, format="csr",
                   dtype=np.float32)
    m.data -= 0.5  # signed values: the cap keeps the largest magnitudes
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = csr.from_scipy(m, cap=cap)
        b = ref_csr.from_scipy(m, cap=cap)
    np.testing.assert_array_equal(a.values.numpy(), np.asarray(b.values))
    np.testing.assert_array_equal(a.cols.numpy(), np.asarray(b.cols))
    rows = rng.integers(0, 20, 80)
    cols = rng.integers(0, 15, 80)
    vals = rng.standard_normal(80).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        c = csr.from_coo(rows, cols, vals, (20, 15), cap=cap)
        d = ref_csr.from_coo(rows, cols, vals, (20, 15), cap=cap)
    np.testing.assert_array_equal(c.values.numpy(), np.asarray(d.values))
    np.testing.assert_array_equal(c.cols.numpy(), np.asarray(d.cols))


def test_to_scipy_to_dense_roundtrip():
    a, _ = synthetic_journal_corpus(n_terms=120, n_docs=50, seed=3)
    sp = csr.to_scipy(a)
    np.testing.assert_array_equal(csr.to_dense(a).numpy(), sp.toarray())
    back = csr.from_scipy(sp)
    np.testing.assert_array_equal(back.values.numpy(), a.values.numpy())
    assert float(a.sqnorm()) == pytest.approx(float((sp.data ** 2).sum()),
                                              rel=1e-6)
    assert int(a.nnz()) == sp.nnz


def test_normalize_rows_by_nnz_bitwise():
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 30, 200)
    cols = rng.integers(0, 25, 200)
    vals = rng.integers(1, 5, 200).astype(np.float32)
    a = normalize_rows_by_nnz(csr.from_coo(rows, cols, vals, (30, 25)))
    b = ref_csr.from_coo(rows, cols, vals, (30, 25))
    from repro.data.textpipe import normalize_rows_by_nnz as ref_norm

    np.testing.assert_array_equal(a.values.numpy(),
                                  np.asarray(ref_norm(b).values))


def test_csr_spmm_products_match_reference():
    a, _ = synthetic_journal_corpus(n_terms=150, n_docs=80, seed=9)
    b, _ = ref_corpus(n_terms=150, n_docs=80, seed=9)
    rng = np.random.default_rng(0)
    v = rng.standard_normal((80, 5)).astype(np.float32)
    u = rng.standard_normal((150, 5)).astype(np.float32)
    np.testing.assert_allclose(
        csr.spmm(a, torch.from_numpy(v)).numpy(),
        np.asarray(ref_csr.spmm(b, jnp.asarray(v))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        csr.spmm_t(a, torch.from_numpy(u)).numpy(),
        np.asarray(ref_csr.spmm_t(b, jnp.asarray(u))), rtol=1e-5, atol=1e-5)
