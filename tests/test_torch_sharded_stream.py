"""The port's streaming engine on a mesh and the mesh solver's elastic
resume, on 2x2 and 4x1 grids of gloo ranks (spawned on the CPU, a
``file://`` store in ``tmp_path``), held against the reference's on the
same grid (a subprocess with ``--xla_force_host_platform_device_count=4``)
on the same numpy inputs and ``u0``.

* ``partial_fit`` over three chunks, and over ragged chunks (0, 31) /
  (31, 64) whose widths the grid does not divide (``v_`` is the last
  chunk's 33 documents): U within 1e-4 relative of the reference's.
* A streamed ``fit`` (``PackedChunk`` blocks through the prefetcher):
  bitwise equal with prefetch on and off, U and V within 1e-4 relative and
  the per-chunk traces within 1e-4 of the reference's.
* Elastic resume (the reference's ``tests/test_robustness.py:347`` bar,
  with ``solver="distributed"``, which the reference's own test leaves
  unset): killed on 2x2 at the snapshot of iteration 10, resumed on 4x1
  within 1e-5 of the uninterrupted 4x1 fit; resumed on 2x2, bitwise the
  uninterrupted 2x2 fit.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.data import synthetic_journal_corpus as ref_corpus
from repro.sparse import to_dense as ref_to_dense
from repro_torch.launch.mesh import spawn_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
N, M, K = 256, 128, 5
CHUNKS = [(0, 48), (48, 96), (96, 128)]
RAGGED = [(0, 31), (31, 64)]
SPARSITY = dict(t_u=55, t_v=120)
FIT_KW = dict(k=K, iters=10, solver="streaming", chunk_docs=32,
              sparsity=SPARSITY)


def run_reference(code, *args):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          *map(str, args)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_REF_CODE = """
    import json, sys
    import jax.numpy as jnp, numpy as np, scipy.sparse as sp
    from repro.nmf import EnforcedNMF, NMFConfig, Sparsity
    d = np.load(sys.argv[1])
    a, u0 = jnp.asarray(d["a"]), jnp.asarray(d["u0"])
    def stream(shape, chunks, sparsity):
        m = EnforcedNMF(NMFConfig(k=%(k)d, iters=10, solver="streaming",
                                  mesh_shape=shape, backend="jnp-csr",
                                  sparsity=sparsity))
        m.u_, m.n_features_ = u0, u0.shape[0]
        for lo, hi in chunks:
            m.partial_fit(a[:, lo:hi])
        return m
    out = {}
    for shape in [(2, 2), (4, 1)]:
        key = "%%dx%%d" %% shape
        m = stream(shape, %(chunks)r, Sparsity(**%(sp)r))
        out[key] = {"u": np.asarray(m.u_).tolist()}
        m = stream(shape, %(ragged)r, Sparsity())
        out[key + " ragged"] = {"u": np.asarray(m.u_).tolist(),
                                "v_shape": list(m.v_.shape)}
    m = EnforcedNMF(NMFConfig(mesh_shape=(2, 2), backend="jnp-csr",
                              sparsity=Sparsity(**%(sp)r), **%(fit)r))
    m.fit(sp.csr_matrix(d["a"]), u0=u0)
    r = m.result_
    out["fit"] = {"u": np.asarray(m.u_).tolist(),
                  "v": np.asarray(m.v_).tolist(),
                  "err": np.asarray(r.error).tolist(),
                  "res": np.asarray(r.residual).tolist()}
    print(json.dumps(out))
""" % dict(k=K, chunks=CHUNKS, ragged=RAGGED, sp=SPARSITY,
           fit={k: v for k, v in FIT_KW.items() if k != "sparsity"})


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    a_sp, _ = ref_corpus(n_terms=N, n_docs=M, n_journals=5, seed=7)
    path = tmp_path_factory.mktemp("stream") / "data.npz"
    np.savez(path, a=np.asarray(ref_to_dense(a_sp)),
             u0=np.random.default_rng(3).random((N, K)).astype(np.float32))
    return path


@pytest.fixture(scope="module")
def reference(data):
    return run_reference(_REF_CODE, data)


def _cases(shape):
    base = dict(k=K, iters=10, solver="streaming", mesh_shape=shape)
    cases = [("bsr", dict(base, backend="cuda-bsr", sparsity=SPARSITY),
              CHUNKS, "dense"),
             ("csr", dict(base, backend="torch-csr", sparsity=SPARSITY),
              CHUNKS, "scipy"),
             ("ragged", dict(base, backend="cuda-bsr"), RAGGED, "dense")]
    if shape == (2, 2):
        fit = dict(FIT_KW, mesh_shape=shape, backend="cuda-bsr")
        cases += [("fit", fit, None, "scipy"),
                  ("fit_no_prefetch", dict(fit, prefetch=False), None,
                   "scipy")]
    return cases


@pytest.fixture(scope="module")
def port(data, tmp_path_factory):
    out = {}
    for shape in [(2, 2), (4, 1)]:
        store = tmp_path_factory.mktemp("store") / "file"
        out["%dx%d" % shape] = spawn_mesh(
            ranks.stream_cases, *shape, backend="gloo", device="cpu",
            init_file=str(store), args=(str(data), _cases(shape)),
            timeout=120.0, threads=1)
    return out


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("grid", ["2x2", "4x1"])
@pytest.mark.parametrize("inner", ["bsr", "csr"])
def test_partial_fit_stream_matches_reference(port, reference, grid, inner):
    got = port[grid][0][inner]
    assert _rel(got["u"], reference[grid]["u"]) < 1e-4
    assert got["n_docs"] == M
    for rec in port[grid]:
        np.testing.assert_array_equal(rec[inner]["u"], got["u"])


@pytest.mark.parametrize("grid", ["2x2", "4x1"])
def test_ragged_chunks_pad_to_the_grid(port, reference, grid):
    got = port[grid][0]["ragged"]
    want = reference[grid + " ragged"]
    assert list(got["v"].shape) == want["v_shape"] == [33, K]
    assert _rel(got["u"], want["u"]) < 1e-4


def test_streamed_fit_on_2x2_matches_reference(port, reference):
    got, want = port["2x2"][0]["fit"], reference["fit"]
    assert got["u"].shape == (N, K) and got["v"].shape == (M, K)
    assert _rel(got["u"], want["u"]) < 1e-4
    assert _rel(got["v"], want["v"]) < 1e-4
    np.testing.assert_allclose(got["err"], want["err"], atol=1e-4)
    np.testing.assert_allclose(got["res"], want["res"], atol=1e-4)
    assert got["health"] == -1


def test_streamed_fit_prefetch_on_and_off_bitwise(port):
    for rec in port["2x2"]:
        on, off = rec["fit"], rec["fit_no_prefetch"]
        for key in ("u", "v", "err", "res", "av", "gv"):
            np.testing.assert_array_equal(on[key], off[key], err_msg=key)
        np.testing.assert_array_equal(on["u"], port["2x2"][0]["fit"]["u"])


def test_a_slow_prefetch_worker_keeps_the_grid_in_step(data, tmp_path):
    """Rank 1's chunk packer is held back 0.2 s before every chunk, so its
    prefetch worker runs far behind the main threads' collectives: the
    worker issues none, and the fit is bitwise the one run in step."""
    kw = dict(FIT_KW, mesh_shape=(2, 2), backend="cuda-bsr")
    out = _spawn(ranks.slow_packer_stream, (2, 2), tmp_path, "slow",
                 str(data), kw, 1, 0.2)
    for rec in out:
        for key in ("u", "v", "err", "res", "av", "gv"):
            np.testing.assert_array_equal(rec["slowed"][key],
                                          rec["plain"][key], err_msg=key)
        assert rec["slowed"]["health"] == -1


def test_skip_hatch_is_refused_on_a_mesh(data, monkeypatch):
    """A chunk the hatch dropped on one rank only would put the ranks out
    of step, so a mesh stream refuses ``REPRO_STREAM_SKIP_BAD_CHUNKS=1``
    before it makes the grid."""
    from repro_torch.data.corpus import SKIP_BAD_CHUNKS_ENV
    from repro_torch.nmf import EnforcedNMF

    monkeypatch.setenv(SKIP_BAD_CHUNKS_ENV, "1")
    d = np.load(data)
    model = EnforcedNMF(ranks._cfg(dict(FIT_KW, mesh_shape=(2, 2))),
                        device="cpu")
    with pytest.raises(ValueError, match="cannot stream on a mesh"):
        model.fit(d["a"], u0=d["u0"])


# ---------------------------------------------------------------------------
# elastic resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("docs") / "docs.npz"
    np.savez(path, a=np.abs(rng.normal(size=(16, 48))).astype(np.float32),
             u0=np.random.default_rng(1).random((16, 3)).astype(np.float32))
    return path


def _kw(ckpt, shape):
    return dict(k=3, iters=20, seed=1, solver="distributed",
                mesh_shape=shape, checkpoint_dir=str(ckpt),
                checkpoint_every=5)


def _spawn(fn, shape, tmp_path, name, *args):
    return spawn_mesh(fn, *shape, backend="gloo", device="cpu",
                      init_file=str(tmp_path / name), args=args,
                      timeout=120.0, threads=1)


def test_elastic_resume_2x2_to_4x1_and_2x2(docs, tmp_path):
    ckpt = tmp_path / "ckpt"
    killed = _spawn(ranks.kill_then_report, (2, 2), tmp_path, "s1",
                    str(docs), _kw(ckpt, (2, 2)), 10)
    assert killed == ["killed"] * 4
    steps = sorted(os.listdir(ckpt))
    assert len(steps) == 2, steps  # the snapshots of iterations 5 and 10
    again = tmp_path / "again"
    shutil.copytree(ckpt, again)

    plain = lambda shape: dict(k=3, iters=20, seed=1, solver="distributed",
                               mesh_shape=shape)
    out = _spawn(ranks.resume_and_plain, (4, 1), tmp_path, "s2", str(docs),
                 dict(_kw(ckpt, (4, 1)), resume=True), plain((4, 1)))
    for rec in out:
        np.testing.assert_allclose(rec["resumed"]["u"], rec["plain"]["u"],
                                   atol=1e-5)
        assert rec["resumed"]["n_iter"] == 20
    out = _spawn(ranks.resume_and_plain, (2, 2), tmp_path, "s3", str(docs),
                 dict(_kw(again, (2, 2)), resume=True), plain((2, 2)))
    for rec in out:
        for key in ("u", "v", "err", "res"):
            np.testing.assert_array_equal(rec["resumed"][key],
                                          rec["plain"][key], err_msg=key)
