"""Port parity for the padded-CSR operand and the ``torch-csr`` backend:
``from_dense``, the chunked products, ``ColumnSlicer`` / ``column_block``,
the text pipeline and the selection rules, against the reference
(``repro.sparse``, ``jnp-csr``, ``repro.data.textpipe``).

Products are held to 1e-4 (``tests/test_backends.py:98-109``); host
packing and carving to bitwise equality."""
from contextlib import nullcontext

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from repro.backend import get_backend as ref_get_backend
from repro.backend import jnp_backends as ref_jnp_backends
from repro.data import synthetic_journal_corpus as ref_corpus
from repro.data.textpipe import build_term_document_matrix as ref_build
from repro.data.textpipe import tokenize as ref_tokenize
from repro.sparse import ColumnSlicer as RefSlicer
from repro.sparse import column_block as ref_column_block
from repro.sparse import from_dense as ref_from_dense
from repro.sparse import to_scipy as ref_to_scipy
from repro_torch.backend import (
    default_backend_name, get_backend, resolve_backend, select_backend,
)
from repro_torch.backend import csr as csr_backend
from repro_torch.data import build_term_document_matrix, tokenize
from repro_torch.nmf import EnforcedNMF, NMFConfig
from repro_torch.sparse import (
    ColumnSlicer, SpCSR, column_block, from_dense, from_scipy, spmm,
    spmm_chunked, spmm_t, spmm_t_chunked,
)
from repro_torch.sparse.csr import _cap_chunking


@pytest.fixture(scope="module")
def scipy_corpus():
    a, _ = ref_corpus(n_terms=240, n_docs=160, n_journals=4, seed=3)
    return ref_to_scipy(a)


@pytest.fixture(scope="module")
def pair(scipy_corpus):
    """(port SpCSR, reference SpCSR) of one corpus, on the CPU."""
    return (get_backend("torch-csr").prepare(scipy_corpus, device="cpu"),
            ref_get_backend("jnp-csr").prepare(scipy_corpus))


def _factors(n, m, k=5, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.random((m, k)).astype(np.float32),
            rng.random((n, k)).astype(np.float32))


@pytest.mark.parametrize("case", ["plain", "chunked", "chunked-prime",
                                  "bf16"])
def test_csr_products_match_reference(monkeypatch, pair, case):
    """``torch-csr`` A @ V and A^T @ U against ``jnp-csr`` at 1e-4, with the
    size trigger monkeypatched low on both sides for the chunked cases, and
    bf16 gathering at the reference's own bf16 bar."""
    a, ra = pair
    x, u = _factors(a.n, a.m)
    be, rbe = get_backend("torch-csr"), ref_get_backend("jnp-csr")
    if case != "plain":
        width = {"chunked": 4, "chunked-prime": 7, "bf16": 4}[case]
        for mod in (csr_backend, ref_jnp_backends):
            monkeypatch.setattr(mod, "SPMM_CHUNK_ELEMS", 1)
            monkeypatch.setattr(mod, "SPMM_CHUNK_WIDTH", width)
            monkeypatch.setattr(mod, "SPMM_BF16", case == "bf16")
        assert csr_backend._chunked_spmm_config(a, 5)[0]
    got = be.matmul(a, torch.from_numpy(x))
    got_t = be.matmul_t(a, torch.from_numpy(u))
    want = np.asarray(rbe.matmul(ra, jnp.asarray(x)))
    want_t = np.asarray(rbe.matmul_t(ra, jnp.asarray(u)))
    assert got.dtype == torch.float32 and got_t.dtype == torch.float32
    tol = dict(rtol=2e-2, atol=2e-2 * want.max()) if case == "bf16" else \
        dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    tol_t = dict(rtol=2e-2, atol=2e-2 * want_t.max()) if case == "bf16" else \
        dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_t.numpy(), want_t, **tol_t)
    # and against the port's own one-shot products
    if case != "bf16":
        np.testing.assert_allclose(
            got.numpy(), spmm(a, torch.from_numpy(x)).numpy(),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got_t.numpy(), spmm_t(a, torch.from_numpy(u)).numpy(),
            rtol=1e-5, atol=1e-5)


def test_cap_chunking_and_default_trigger(pair):
    a, _ = pair
    assert _cap_chunking(13, 4) == (3, 4, 1)
    assert _cap_chunking(127, 64) == (1, 64, 63)
    assert csr_backend._chunked_spmm_config(a, 5) == (False, None)
    x, _ = _factors(a.n, a.m)
    xt = torch.from_numpy(x)
    for chunk in (1, 3, a.cap, 10 * a.cap):
        np.testing.assert_allclose(spmm_chunked(a, xt, chunk).numpy(),
                                   spmm(a, xt).numpy(), rtol=1e-5, atol=1e-5)
    u = torch.from_numpy(_factors(a.n, a.m)[1])
    np.testing.assert_allclose(
        spmm_t_chunked(a, u, 4, compute_dtype=torch.bfloat16).numpy(),
        spmm_t(a, u).numpy(), rtol=2e-2,
        atol=2e-2 * float(spmm_t(a, u).max()))


@pytest.mark.parametrize("cap", [None, 3, 13, 40])
def test_from_dense_is_bitwise_the_reference(cap):
    """Slots in descending magnitude, ties by column, padded past m."""
    rng = np.random.default_rng(8)
    dense = rng.integers(-3, 4, size=(40, 30)).astype(np.float32)
    dense[rng.random((40, 30)) > 0.4] = 0
    got = from_dense(dense, cap=cap)
    want = ref_from_dense(jnp.asarray(dense), cap=cap)
    assert got.shape == want.shape and got.cap == want.cap
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    assert got.cols.dtype == torch.int32


@pytest.mark.parametrize("ranges", [[(0, 160)], [(0, 40), (40, 80),
                                                 (80, 120), (120, 160)],
                                    [(17, 18), (100, 159)]])
def test_column_slicer_is_bitwise_the_reference(scipy_corpus, ranges):
    a = from_scipy(scipy_corpus)
    ra = ref_get_backend("jnp-csr").prepare(scipy_corpus)
    sl, rsl = ColumnSlicer(a), RefSlicer(ra)
    assert sl.chunk_cap(ranges) == rsl.chunk_cap(ranges)
    cap = sl.chunk_cap(ranges)
    for lo, hi in ranges:
        assert sl.max_row_nnz(lo, hi) == rsl.max_row_nnz(lo, hi)
        for got, want in ((sl.block(lo, hi, cap=cap),
                           rsl.block(lo, hi, cap=cap)),
                          (column_block(a, lo, hi),
                           ref_column_block(ra, lo, hi))):
            assert got.shape == want.shape and got.device.type == "cpu"
            np.testing.assert_array_equal(got.values.numpy(),
                                          np.asarray(want.values))
            np.testing.assert_array_equal(got.cols.numpy(),
                                          np.asarray(want.cols))
    with pytest.raises(ValueError, match="bad column range"):
        sl.block(5, 5)


_DOCS = [
    "The quick brown fox jumps over the lazy dog; the dog sleeps.",
    "A lazy afternoon: the fox and the dog's nap, then a quick run.",
    "Markets rally as rates fall; brokers say the rally may fade.",
    "Rates rise again and markets fall, said the brokers' report.",
    "Mr. Fox's well-known run-in with the dog was quick.",
]


@pytest.mark.parametrize("min_count,cap", [(2, None), (1, None), (2, 2)])
def test_text_pipeline_is_identical_to_the_reference(min_count, cap):
    for d in _DOCS:
        assert tokenize(d) == ref_tokenize(d)
    with pytest.warns(UserWarning) if cap == 2 else nullcontext():
        a, vocab = build_term_document_matrix(_DOCS, min_count=min_count,
                                              cap=cap)
    ra, rvocab = ref_build(_DOCS, min_count=min_count, cap=cap)
    assert vocab == rvocab
    np.testing.assert_array_equal(a.values.numpy(), np.asarray(ra.values))
    np.testing.assert_array_equal(a.cols.numpy(), np.asarray(ra.cols))


def test_selection_rules(scipy_corpus):
    """``SpCSR`` picks ``torch-csr`` and passes through unconverted; scipy
    still defaults to ``cuda-bsr``, except for the sequential and streaming
    solvers, which keep it as ``torch-csr``; ``chunkable`` keeps a
    ``cuda-bsr`` target column-sliceable on the host."""
    a = from_scipy(scipy_corpus)
    assert select_backend(a).name == "torch-csr"
    assert default_backend_name(a) == "torch-csr"
    assert default_backend_name(scipy_corpus) == "cuda-bsr"
    assert get_backend("jnp-csr") is get_backend("torch-csr")
    assert not get_backend("torch-csr").fuse_epilogue
    model = EnforcedNMF(NMFConfig(k=3), device="cpu")
    coerced = model._coerce(a)
    assert isinstance(coerced, SpCSR)
    assert coerced.values.data_ptr() == a.values.data_ptr()
    assert resolve_backend(model._coerce(scipy_corpus)).name == "cuda-bsr"
    for solver in ("sequential", "streaming"):
        m = EnforcedNMF(NMFConfig(k=3, solver=solver), device="cpu")
        assert isinstance(m._coerce(scipy_corpus), SpCSR)
    m = EnforcedNMF(NMFConfig(k=3, solver="streaming", backend="pallas-bsr"),
                    device="cpu")
    kept = m._coerce(scipy_corpus, chunkable=True)
    assert isinstance(kept, SpCSR) and kept.device.type == "cpu"
    dense = get_backend("torch-csr").prepare(scipy_corpus.toarray(),
                                             device="cpu")
    np.testing.assert_array_equal(dense.values.numpy(), a.values.numpy())
    assert isinstance(get_backend("torch-csr").prepare(
        sps.eye(3, format="csr"), device="cpu"), SpCSR)
