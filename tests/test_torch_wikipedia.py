"""Port parity at the paper's Wikipedia configuration (143,462 terms x
12,439 pages, k = 5, 50 iterations; ``NMF_CONFIGS["wikipedia"]``), cut for
the CPU to 1/16 of each side with the same Zipf skew.

* the lean host ingest (``kernels/bsr.py``: tile norms and kept-tile moves a
  slab at a time) bitwise the reference's ``bsr_operand``, both
  orientations, at 32 x 32 and 128 x 128 tiles, over several slabs, with a
  ``bcap`` truncation, and from dense input;
* its ``tracemalloc`` peak within 1.15x the two orientations' tile bytes
  (plus a small constant): the ingest it replaced held a float64 copy of a
  whole tile volume, ~2.5-2.8x at these shapes;
* the whole-batch and streamed ``cuda-bsr`` fits (plain versions on the
  CPU) against the reference's ``EnforcedNMF`` on ``jnp-csr`` /
  ``jnp-dense`` from the same numpy ``u0``, at the reference's end-to-end
  bar of 1e-4 (``tests/test_backends.py:365-380``), and the fold-in;
* the command line, ``--config wikipedia --small --device cpu --backend
  cuda-bsr`` with and without ``--stream``: exit 0, NNZ within the budgets.
"""
import os
import re
import subprocess
import sys
import tracemalloc
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import NMF_CONFIGS as REF_NMF_CONFIGS
from repro.data import synthetic_journal_corpus as ref_corpus
from repro.kernels import bsr as ref_bsr
from repro.nmf import EnforcedNMF as RefNMF
from repro.nmf import NMFConfig as RefConfig
from repro.nmf import Sparsity as RefSparsity
from repro.sparse import to_scipy
from repro_torch.configs import NMF_CONFIGS
from repro_torch.kernels import bsr
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WIKI = NMF_CONFIGS["wikipedia"]
N, M = WIKI["n_terms"] // 16, WIKI["n_docs"] // 16       # 8966 x 777
K = WIKI["k"]
#: 2% of each dense factor, as the card's Wikipedia phase keeps
T_U, T_V = N * K // 50, M * K // 50
ITERS = WIKI["iters"]


@pytest.fixture(scope="module")
def corpus():
    a, _ = ref_corpus(n_terms=N, n_docs=M, n_journals=5)
    return to_scipy(a)


@pytest.fixture(scope="module")
def u0():
    return np.random.default_rng(0).random((N, K)).astype(np.float32)


def _same(port, reference):
    want = np.asarray(reference.tiles)
    # the reference's arrays are jax's, float32 where its input was float64
    # (jax's default); the layout is what is held here
    np.testing.assert_array_equal(port.tiles.numpy().astype(want.dtype),
                                  want)
    np.testing.assert_array_equal(port.block_cols.numpy(),
                                  np.asarray(reference.block_cols))
    assert port.shape == reference.shape
    # the occupied-tile count read off the norms is the one a scan of the
    # tiles gives
    assert port.occupied == bsr._occupied(port.tiles)


def test_the_configuration_is_the_references():
    assert WIKI == REF_NMF_CONFIGS["wikipedia"]
    assert (WIKI["n_terms"], WIKI["n_docs"], K) == (143462, 12439, 5)


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("slab", ["one tile", "several", "default"])
def test_lean_ingest_is_bitwise_the_references(corpus, monkeypatch, tile,
                                               slab):
    per_tile = 2 * 8 * tile * tile
    budget = {"one tile": 1, "several": 5 * per_tile,
              "default": bsr.SLAB_BYTES}[slab]
    monkeypatch.setattr(bsr, "SLAB_BYTES", budget)
    port = bsr.bsr_operand(corpus, bm=tile, bk=tile)
    reference = ref_bsr.bsr_operand(corpus, bm=tile, bk=tile)
    _same(port.bsr, reference.bsr)
    _same(port.bsr_t, reference.bsr_t)
    if slab != "default":
        # the slab really cuts the volume: more row-blocks than one slab
        assert port.bsr.nrb > max(1, budget // (per_tile * port.bsr.bcap))


@pytest.mark.parametrize("tile", [32, 128])
def test_lean_ingest_truncates_bcap_as_the_reference(corpus, monkeypatch,
                                                     tile):
    monkeypatch.setattr(bsr, "SLAB_BYTES", 3 * 2 * 8 * tile * tile)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        port = bsr.bsr_operand(corpus, bm=tile, bk=tile, bcap=3)
        port_t = bsr.bsr_transpose(port.bsr, bcap=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        reference = ref_bsr.bsr_operand(corpus, bm=tile, bk=tile, bcap=3)
        reference_t = ref_bsr.bsr_transpose(reference.bsr, bcap=2)
    _same(port.bsr, reference.bsr)
    _same(port.bsr_t, reference.bsr_t)
    _same(port_t, reference_t)
    text = " ".join(str(w.message) for w in got)
    assert "exceed bcap=3" in text and "exceed bcap=2" in text


@pytest.mark.parametrize("tile", [32, 128])
def test_lean_ingest_of_dense_input_is_bitwise(corpus, monkeypatch, tile):
    dense = corpus[:, : M // 2].toarray()
    monkeypatch.setattr(bsr, "SLAB_BYTES", 2 * 2 * 8 * tile * tile)
    port = bsr.bsr_operand(dense, bm=tile, bk=tile)
    reference = ref_bsr.bsr_operand(dense, bm=tile, bk=tile)
    _same(port.bsr, reference.bsr)
    _same(port.bsr_t, reference.bsr_t)


def _edge_matrix(dtype):
    """A sparse-looking matrix whose tiles test the occupancy rule: a
    NaN in an otherwise nonzero tile, a tile of only -0.0, a float64 tile
    of entries whose squares underflow, an infinite entry."""
    rng = np.random.default_rng(7)
    a = np.zeros((96, 130), dtype)
    keep = rng.random(a.shape) < 0.04
    a[keep] = rng.random(int(keep.sum())) + 0.5
    a[3, 5] = np.nan              # tile (0, 0): a NaN among entries
    a[40, 70] = -0.0              # tile (1, 2) holds only -0.0 ...
    a[40:48, 64:96] = 0.0
    a[40, 70] = -0.0
    if dtype == np.float64:
        a[70:80, 100:128] = 0.0   # tile (2, 3): squares underflow
        a[71, 101] = 1e-170
    a[90, 10] = np.inf            # tile (2, 0): an infinite entry
    return a


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("source", ["dense", "scipy", "scipy cast", "bsr"])
def test_lean_ingest_keeps_the_references_tiles_at_edge_values(dtype,
                                                               source):
    """Which tiles each orientation keeps follows the reference's float64
    norms exactly (a NaN drops a tile from the transpose, an underflowing
    float64 square too) and ``occupied`` stays a scan's count."""
    import scipy.sparse as sps

    a = _edge_matrix(dtype)
    kw = dict(bm=32, bk=32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if source == "dense":
            port, reference = (bsr.bsr_operand(a, **kw),
                               ref_bsr.bsr_operand(a, **kw))
        elif source == "bsr":
            port = bsr.bsr_operand(bsr.bsr_from_dense(a, **kw))
            reference = ref_bsr.bsr_operand(ref_bsr.bsr_from_dense(a, **kw))
        else:
            sp = sps.csr_matrix(np.nan_to_num(a, nan=7.0))
            sp.data[sp.data == 7.0] = np.nan
            if source == "scipy cast":
                # float64 entries that become float32 zeros on the way in
                sp = sp.astype(np.float64)
                sp.data[:3] = 1e-60
                kw["dtype"] = np.float32
            port = bsr.bsr_operand(sp, **kw)
            reference = ref_bsr.bsr_operand(sp, **kw)
    _same(port.bsr, reference.bsr)
    _same(port.bsr_t, reference.bsr_t)


@pytest.mark.parametrize("tile", [32, 128])
def test_lean_ingest_peaks_at_the_tile_volume(corpus, monkeypatch, tile):
    """Host bytes ``bsr_operand`` allocates above its scipy input, at a slab
    well below the tile volume (as 256 MiB is at Wikipedia size): within
    1.15x the two orientations' tiles plus 4 MiB (the COO and slot arrays,
    nnz-proportional, and one slab's temporaries)."""
    monkeypatch.setattr(bsr, "SLAB_BYTES", 1 << 20)
    bsr.bsr_operand(corpus, bm=tile, bk=tile)   # imports and caches warm
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        op = bsr.bsr_operand(corpus, bm=tile, bk=tile)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    volume = sum(b.tiles.numel() * b.tiles.element_size()
                 for b in (op.bsr, op.bsr_t))
    assert volume > 40 << 20
    assert peak <= 1.15 * volume + (4 << 20), (peak, volume, peak / volume)


def _ref_cfg(backend, **kw):
    return RefConfig(k=K, iters=ITERS, backend=backend,
                     sparsity=RefSparsity(t_u=T_U, t_v=T_V), **kw)


def _port_cfg(**kw):
    return NMFConfig(k=K, iters=ITERS, backend="cuda-bsr",
                     sparsity=Sparsity(t_u=T_U, t_v=T_V), **kw)


def _traces_agree(res, rres):
    np.testing.assert_allclose(res.error.numpy(), np.asarray(rres.error),
                               atol=1e-4)
    np.testing.assert_allclose(res.residual.numpy(),
                               np.asarray(rres.residual), atol=1e-4)
    assert int(res.health) == -1


def _factors_agree(model, ref):
    """U within 1e-4 of its largest entry (U is not normalized: its
    entries reach ~40 here), V within 1e-4."""
    scale = float(np.abs(np.asarray(ref.u_)).max())
    np.testing.assert_allclose(model.u_.numpy(), np.asarray(ref.u_),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(model.v_.numpy(), np.asarray(ref.v_),
                               atol=1e-4)


@pytest.mark.parametrize("ref_backend", ["jnp-csr", "jnp-dense"])
def test_whole_batch_fit_matches_the_reference(corpus, u0, ref_backend):
    model = EnforcedNMF(_port_cfg(), device="cpu").fit(corpus, u0=u0)
    ref = RefNMF(_ref_cfg(ref_backend)).fit(corpus, u0=jnp.asarray(u0))
    res, rres = model.result_, ref.result_
    _traces_agree(res, rres)
    _factors_agree(model, ref)
    for nnz, t in ((res.final_nnz_u, T_U), (res.final_nnz_v, T_V)):
        assert t <= nnz <= t + max(2, t // 100)
    # the fold-in of the corpus: the reference's loadings
    np.testing.assert_allclose(model.transform(corpus).numpy(),
                               np.asarray(ref.transform(corpus)), atol=1e-4)


def test_streamed_fit_matches_the_reference(corpus, u0):
    """The default 8-chunk schedule, prefetch on, resident chunks."""
    model = EnforcedNMF(_port_cfg(solver="streaming"),
                        device="cpu").fit(corpus, u0=u0)
    ref = RefNMF(_ref_cfg("jnp-csr", solver="streaming")).fit(
        corpus, u0=jnp.asarray(u0))
    res, rres = model.result_, ref.result_
    assert res.n_iter == rres.n_iter == 8
    _traces_agree(res, rres)
    np.testing.assert_array_equal(res.nnz_u.numpy(), np.asarray(rres.nnz_u))
    np.testing.assert_array_equal(res.nnz_v.numpy(), np.asarray(rres.nnz_v))
    _factors_agree(model, ref)
    # each of the three passes ingests every chunk
    assert [res.stream_stats[p]["packed"]
            for p in ("fit", "fold_in", "seed")] == [8, 8, 8]


@pytest.mark.parametrize("stream", [False, True], ids=["batch", "stream"])
def test_command_line_fits_the_small_wikipedia_config(stream):
    cmd = [sys.executable, "-m", "repro_torch.launch.nmf_run", "--config",
           "wikipedia", "--small", "--iters", "2", "--device", "cpu",
           "--backend", "cuda-bsr", "--sparsity", "frac_u=0.02,frac_v=0.02"]
    out = subprocess.run(cmd + (["--stream"] if stream else []),
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    n, m = WIKI["n_terms"] // 8, WIKI["n_docs"] // 8
    assert f"building {n}x{m} synthetic corpus" in out.stdout
    got = re.search(r"final error (\S+), residual \S+, NNZ\(U\)=(\d+), "
                    r"NNZ\(V\)=(\d+)", out.stdout)
    assert got, out.stdout
    err, nnz_u, nnz_v = float(got[1]), int(got[2]), int(got[3])
    assert np.isfinite(err) and 0.0 < err < 1.0
    t_u, t_v = int(n * K * 0.02), int(m * K * 0.02)
    assert 0 < nnz_u <= t_u + max(2, t_u // 100)
    # a streamed fit's V is the fold-in's, whose budget is rescaled per
    # chunk (the reference's per-document rule)
    assert 0 < nnz_v <= t_v + (8 * 5 if stream else max(2, t_v // 100))
