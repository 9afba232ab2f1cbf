"""The port's ``solver="distributed"`` on 2x2 and 4x1 grids of gloo ranks
(spawned on the CPU; a ``file://`` store in ``tmp_path``), held against the
reference's distributed solver on the same grid (a subprocess with
``--xla_force_host_platform_device_count=4``, as
``tests/test_bsr_sharded.py`` runs it) on the same numpy inputs and
``u0``.

Bars: against the reference on the same grid, the error and residual
traces within 1e-4, U within 1e-4 relative Frobenius and the nnz traces
equal (the reference's bar for two engines on one grid,
``tests/test_bsr_sharded.py:232-247``); the inner formats ``torch-csr`` /
``cuda-bsr`` / ``cuda-bsr-unfused`` (plain versions on the CPU) the same
bar; against the single-device ``enforced`` fit the reference's own bars
(``tests/test_sharded_engine.py:65-89``).  ``tol``, ``track_error``, the
running ``max_nnz`` and the columnwise budget behave as on one device.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.data import synthetic_journal_corpus as ref_corpus
from repro.sparse import to_dense as ref_to_dense
from repro_torch.launch.mesh import spawn_mesh
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
N, M, K, ITERS = 256, 128, 5, 15
T_U, T_V = 55, 300
GRIDS = [(2, 2), (4, 1)]
SPARSITY = dict(t_u=T_U, t_v=T_V)


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
    a, u0 = sp.csr_matrix(d["a"]), jnp.asarray(d["u0"])
    sparsity = Sparsity(t_u=%(t_u)d, t_v=%(t_v)d)
    def rec(m):
        r = m.result_
        return {"err": np.asarray(r.error).tolist(),
                "res": np.asarray(r.residual).tolist(),
                "nnz_u": np.asarray(r.nnz_u).tolist(),
                "nnz_v": np.asarray(r.nnz_v).tolist(),
                "max_nnz": int(r.max_nnz), "u": np.asarray(m.u_).tolist()}
    out = {"enforced": rec(EnforcedNMF(NMFConfig(
        k=%(k)d, iters=%(iters)d, sparsity=sparsity)).fit(a, u0=u0))}
    for shape in [(2, 2), (4, 1)]:
        out["%%dx%%d" %% shape] = rec(EnforcedNMF(NMFConfig(
            k=%(k)d, iters=%(iters)d, solver="distributed", mesh_shape=shape,
            backend="jnp-csr", sparsity=sparsity)).fit(a, u0=u0))
    print(json.dumps(out))
""" % dict(t_u=T_U, t_v=T_V, k=K, iters=ITERS)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    a_sp, _ = ref_corpus(n_terms=N, n_docs=M, n_journals=5, seed=7)
    path = tmp_path_factory.mktemp("mesh") / "data.npz"
    np.savez(path, a=np.asarray(ref_to_dense(a_sp)),
             u0=np.random.default_rng(3).random((N, K)).astype(np.float32))
    return path


@pytest.fixture(scope="module")
def reference(data):
    return run_reference(_REF_CODE, data)


def _cases(shape):
    base = dict(k=K, iters=ITERS, solver="distributed", mesh_shape=shape,
                sparsity=SPARSITY)
    cases = [("bsr", dict(base, backend="cuda-bsr"), "scipy"),
             ("csr", dict(base, backend="torch-csr"), "spcsr"),
             ("unfused", dict(base, backend="cuda-bsr-unfused"), "dense"),
             ("auto", dict(base), "bsr")]
    if shape == (2, 2):
        cases += [
            ("tol", dict(base, iters=75, tol=1e-2, backend="cuda-bsr"),
             "scipy"),
            ("no_error", dict(base, iters=5, track_error=False), "scipy"),
            ("columnwise", dict(base, iters=6, sparsity=dict(
                t_u=20, mode="columnwise")), "scipy")]
    return cases


@pytest.fixture(scope="module")
def port(data, tmp_path_factory):
    out = {}
    for shape in GRIDS:
        store = tmp_path_factory.mktemp("store") / "file"
        out["%dx%d" % shape] = spawn_mesh(
            ranks.fit_cases, *shape, backend="gloo", device="cpu",
            init_file=str(store), args=(str(data), _cases(shape)),
            timeout=120.0, threads=1)
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got["err"], want["err"], atol=1e-4,
                               err_msg=f"{what}: error trace")
    np.testing.assert_allclose(got["res"], want["res"], atol=1e-4,
                               err_msg=f"{what}: residual trace")
    np.testing.assert_array_equal(got["nnz_u"], want["nnz_u"],
                                  err_msg=f"{what}: nnz_u")
    np.testing.assert_array_equal(got["nnz_v"], want["nnz_v"],
                                  err_msg=f"{what}: nnz_v")
    u, u_ref = np.asarray(got["u"]), np.asarray(want["u"])
    rel = np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref)
    assert rel < 1e-4, (what, rel)


@pytest.mark.parametrize("grid", ["2x2", "4x1"])
def test_distributed_matches_reference_on_the_same_grid(port, reference,
                                                        grid):
    """``sharded[cuda-bsr]`` (its kernels' plain versions here) against the
    reference's ``sharded[jnp-csr]`` on the same grid."""
    _close(port[grid][0]["bsr"], reference[grid], f"{grid} cuda-bsr")
    assert port[grid][0]["bsr"]["max_nnz"] == reference[grid]["max_nnz"]


@pytest.mark.parametrize("grid", ["2x2", "4x1"])
@pytest.mark.parametrize("inner", ["csr", "unfused", "auto"])
def test_inner_formats_agree(port, grid, inner):
    """``torch-csr`` blocks, the separate launches and a ``BSROperand``
    input (``cuda-bsr`` chosen by input) track ``cuda-bsr``."""
    _close(port[grid][0][inner], port[grid][0]["bsr"], f"{grid} {inner}")


@pytest.mark.parametrize("grid", ["2x2", "4x1"])
def test_factors_and_traces_are_whole_on_every_rank(port, grid):
    """``u_`` / ``v_`` come back whole and bitwise equal on every rank, as
    do the traces and the streaming statistics."""
    recs = port[grid]
    for rec in recs:
        got = rec["bsr"]
        assert got["u"].shape == (N, K) and got["v"].shape == (M, K)
        for key in ("u", "v", "err", "res", "nnz_u", "av", "gv"):
            np.testing.assert_array_equal(got[key], recs[0]["bsr"][key])
        assert set(got["collectives"]) == {"all_reduce", "bytes"}
        assert got["collectives"]["all_reduce"] > 0


@pytest.mark.parametrize("grid", ["2x2", "4x1"])
def test_streaming_statistics_are_a_v_and_its_gram(port, data, grid):
    """The statistics a later ``partial_fit`` continues from, computed on
    the blocks: ``A V`` and ``V^T V`` of the fitted V."""
    a = np.load(data)["a"]
    d = port[grid][0]["bsr"]
    np.testing.assert_allclose(d["av"], a @ d["v"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d["gv"], d["v"].T @ d["v"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("grid", ["2x2", "4x1"])
def test_distributed_vs_single_device_enforced(port, reference, data, grid):
    """The reference's bars between its distributed and single-device
    solvers, against the port's single-device ``enforced`` fit (itself held
    to the reference's)."""
    d = np.load(data)
    import scipy.sparse as sp

    single = EnforcedNMF(NMFConfig(k=K, iters=ITERS, backend="cuda-bsr",
                                   sparsity=Sparsity(**SPARSITY)),
                         device="cpu").fit(sp.csr_matrix(d["a"]),
                                           u0=d["u0"]).result_
    ref_err = single.error.numpy()
    ref_res = single.residual.numpy()
    np.testing.assert_allclose(ref_err, reference["enforced"]["err"],
                               atol=1e-4)
    rec = port[grid][0]["bsr"]
    err, res = np.asarray(rec["err"]), np.asarray(rec["res"])
    assert err.shape == ref_err.shape
    assert np.max(np.abs(err - ref_err)) < 0.02, grid
    assert np.max(np.abs(res - ref_res)) < 0.15, grid
    assert res[-1] < max(2 * ref_res[-1], 0.15), grid
    assert all(n <= T_U + 6 for n in rec["nnz_u"]), grid
    assert all(n <= T_V + 6 for n in rec["nnz_v"]), grid
    assert rec["max_nnz"] == int(single.max_nnz) == N * K, grid


def test_tol_and_track_error_on_2x2(port):
    rec = port["2x2"][0]
    tol = rec["tol"]
    assert tol["converged"] and tol["n_iter"] < 75
    assert tol["res"][-1] <= 1e-2
    assert len(tol["res"]) == tol["n_iter"]
    assert rec["no_error"]["err"].tolist() == [0.0] * 5


def test_max_nnz_is_a_running_max_on_2x2(port):
    rec = port["2x2"][0]["bsr"]
    final = int(rec["nnz_u"][-1]) + int(rec["nnz_v"][-1])
    assert rec["max_nnz"] == N * K > final


def test_columnwise_budget_scales_to_the_whole_factor(port):
    from repro_torch.nmf.solvers import dist_budget

    assert dist_budget(Sparsity(t_u=20, mode="columnwise"), 96, 4, "u") == 80
    assert dist_budget(Sparsity(t_u=30), 96, 4, "u") == 30
    assert dist_budget(Sparsity(), 96, 4, "u") is None
    nnz_u = int((port["2x2"][0]["columnwise"]["u"] != 0).sum())
    assert 20 < nnz_u <= 20 * K + 6


def test_distributed_config_validation():
    with pytest.raises(ValueError, match="local backends"):
        NMFConfig(solver="distributed", backend="torch-dense")
    with pytest.raises(ValueError, match="local backends"):
        NMFConfig(solver="streaming", mesh_shape=(2, 2),
                  backend="torch-dense")
    with pytest.raises(ValueError, match="mesh_shape"):
        NMFConfig(mesh_shape=(0, 2))
    assert NMFConfig(mesh_shape=[2, 2]).mesh_shape == (2, 2)
    NMFConfig(solver="distributed", backend="pallas-bsr")  # an alias


def test_fingerprint_does_not_pin_the_mesh_shape():
    from repro_torch.robustness.snapshot import config_fingerprint

    base = NMFConfig(k=4, iters=10, seed=1)
    assert config_fingerprint(base) == config_fingerprint(
        base.replace(iters=50, mesh_shape=(2, 2)))
