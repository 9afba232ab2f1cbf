"""Port parity: BSR host ingest (both orientations, ``bcap`` truncation), the
Gram coverage fixed at ingest, and the tile-wise helpers — held bitwise
against the reference's arrays."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from repro.kernels import bsr as ref_bsr
from repro.kernels.fused import _coverage
from repro_torch.convert import bsr_from_reference
from repro_torch.kernels import bsr


def _rand_sparse(rng, n, m, density=0.05):
    a = rng.random((n, m)).astype(np.float32)
    a[rng.random((n, m)) > density] = 0
    return a


def _same(port, reference):
    np.testing.assert_array_equal(port.tiles.numpy(),
                                  np.asarray(reference.tiles))
    np.testing.assert_array_equal(port.block_cols.numpy(),
                                  np.asarray(reference.block_cols))
    assert port.shape == reference.shape


@pytest.mark.parametrize("n,m,bm,bk", [(257, 129, 32, 32), (100, 70, 32, 32),
                                       (128, 256, 64, 64), (64, 512, 32, 16)])
def test_bsr_operand_dense_ingest_bitwise(n, m, bm, bk):
    rng = np.random.default_rng(n + m)
    a = _rand_sparse(rng, n, m)
    a[: min(40, n)] = 0
    port = bsr.bsr_operand(a, bm=bm, bk=bk)
    reference = ref_bsr.bsr_operand(a, bm=bm, bk=bk)
    _same(port.bsr, reference.bsr)
    _same(port.bsr_t, reference.bsr_t)
    assert port.shape == reference.shape


def test_bsr_operand_scipy_ingest_bitwise():
    from repro.data import synthetic_journal_corpus
    from repro.sparse import to_scipy

    a, _ = synthetic_journal_corpus(n_terms=300, n_docs=200, seed=1)
    sp = to_scipy(a)
    port = bsr.bsr_operand(sp, bm=32, bk=32)
    reference = ref_bsr.bsr_operand(sp, bm=32, bk=32)
    _same(port.bsr, reference.bsr)
    _same(port.bsr_t, reference.bsr_t)


@pytest.mark.parametrize("source", ["dense", "scipy", "transpose"])
def test_bcap_truncation_bitwise_and_warns(source):
    rng = np.random.default_rng(11)
    a = _rand_sparse(rng, 96, 160, density=0.3)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        if source == "dense":
            port = bsr.bsr_from_dense(a, bm=32, bk=32, bcap=2)
        elif source == "scipy":
            port = bsr.bsr_from_scipy(sps.csr_matrix(a), bm=32, bk=32,
                                      bcap=2)
        else:
            port = bsr.bsr_transpose(bsr.bsr_from_dense(a, bm=32, bk=32),
                                     bcap=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if source == "dense":
            reference = ref_bsr.bsr_from_dense(a, bm=32, bk=32, bcap=2)
        elif source == "scipy":
            reference = ref_bsr.bsr_from_scipy(sps.csr_matrix(a), bm=32,
                                               bk=32, bcap=2)
        else:
            reference = ref_bsr.bsr_transpose(
                ref_bsr.bsr_from_dense(a, bm=32, bk=32), bcap=2)
    assert any("bcap=2" in str(w.message) for w in got)
    _same(port, reference)


@pytest.mark.parametrize("case", ["random", "unreferenced", "all_zero"])
def test_coverage_matches_reference(case):
    rng = np.random.default_rng(4)
    if case == "random":
        a = _rand_sparse(rng, 257, 129)
    elif case == "unreferenced":
        a = np.zeros((128, 256), np.float32)
        a[:64, :64] = rng.random((64, 64))
    else:
        a = np.zeros((100, 180), np.float32)
    port = bsr.bsr_from_dense(a, bm=64, bk=64)
    reference = ref_bsr.bsr_from_dense(a, bm=64, bk=64)
    ncb = -(-a.shape[1] // 64)
    flags, covered = _coverage(reference.block_cols, ncb)
    np.testing.assert_array_equal(port.gram_flags.numpy(), np.asarray(flags))
    covered = np.asarray(covered)
    if covered.all():
        assert port.uncovered_rows is None
    else:
        rows = ~covered[np.arange(a.shape[1]) // 64]
        np.testing.assert_array_equal(port.uncovered_rows.numpy(), rows)


def test_to_dense_to_coo_and_dot_uv():
    rng = np.random.default_rng(0)
    a = _rand_sparse(rng, 200, 150)
    port = bsr.bsr_from_dense(a, bm=32, bk=32)
    reference = ref_bsr.bsr_from_dense(a, bm=32, bk=32)
    np.testing.assert_array_equal(bsr.bsr_to_dense(port).numpy(), a)
    np.testing.assert_array_equal(
        bsr.bsr_to_dense(bsr.bsr_transpose(port)).numpy(), a.T)
    for x, y in zip(bsr.bsr_to_coo(port), ref_bsr.bsr_to_coo(reference)):
        np.testing.assert_array_equal(x, y)
    u = rng.standard_normal((200, 5)).astype(np.float32)
    v = rng.standard_normal((150, 5)).astype(np.float32)
    got = float(bsr.bsr_dot_uv(port, torch.from_numpy(u), torch.from_numpy(v)))
    want = float(ref_bsr.bsr_dot_uv(reference, jnp.asarray(u),
                                    jnp.asarray(v)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-4)
    assert float(port.sqnorm()) == pytest.approx(float(reference.sqnorm()),
                                                 rel=1e-6)


def test_bsr_from_reference_roundtrip():
    rng = np.random.default_rng(6)
    a = _rand_sparse(rng, 130, 90)
    reference = ref_bsr.bsr_from_dense(a, bm=32, bk=32)
    port = bsr_from_reference(np.asarray(reference.tiles),
                              np.asarray(reference.block_cols),
                              reference.shape, device="cpu")
    _same(port, reference)
    native = bsr.bsr_from_dense(a, bm=32, bk=32)
    np.testing.assert_array_equal(port.gram_flags.numpy(),
                                  native.gram_flags.numpy())


def test_operand_moves_to_device_once():
    rng = np.random.default_rng(1)
    op = bsr.bsr_operand(_rand_sparse(rng, 70, 50), bm=32, bk=32,
                         device="cpu")
    assert op.device == torch.device("cpu")
    assert op.to("cpu").bsr.tiles.data_ptr() == op.bsr.tiles.data_ptr()
