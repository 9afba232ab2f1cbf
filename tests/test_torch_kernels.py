"""Port parity for every module that holds a kernel: the reference's Pallas
kernels (interpret mode, as its own tests run them) against the port's
wrappers, which run their plain versions on CPU tensors.

Tolerances are the reference's own: ``project_mask`` bitwise
(``tests/test_kernels.py``), the BSR products 1e-4 and the Gram 1e-4/1e-3
(``tests/test_backends.py``), the fused Gram 1e-5/1e-4 with its product
bitwise the port's own ``bsr_spmm``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bsr as ref_bsr
from repro.kernels.bsr_spmm import bsr_spmm as ref_spmm
from repro.kernels.bsr_spmm import bsr_spmm_t as ref_spmm_t
from repro.kernels.fused import bsr_spmm_gram as ref_fused
from repro.kernels.gram import gram as ref_gram
from repro.kernels.project_mask import project_mask as ref_mask
from repro_torch.kernels import _build, bsr, ops
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_t
from repro_torch.kernels.fused import bsr_spmm_gram, bsr_spmm_gram_t
from repro_torch.kernels.gram import gram
from repro_torch.kernels.project_mask import project_mask


def _rand_sparse(rng, n, m, density=0.05):
    a = rng.random((n, m)).astype(np.float32)
    a[rng.random((n, m)) > density] = 0
    return a


@pytest.mark.parametrize("shape", [(100, 37), (256, 256), (17, 512), (1, 1)])
@pytest.mark.parametrize("tau", [0.0, 0.5, 2.0])
def test_project_mask_bitwise(shape, tau):
    x = np.array(jax.random.normal(jax.random.PRNGKey(7), shape))
    want = ref_mask(jnp.asarray(x), jnp.float32(tau), interpret=True)
    got = project_mask(torch.from_numpy(x), torch.tensor(tau))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,m,k", [(128, 128, 8), (257, 129, 33),
                                   (64, 512, 96), (100, 70, 5)])
def test_bsr_spmm_and_spmm_t_match_reference(n, m, k):
    rng = np.random.default_rng(n + m)
    a = _rand_sparse(rng, n, m)
    a[: min(40, n)] = 0  # empty rows -> empty row-blocks at bm=32
    op_ref = ref_bsr.bsr_operand(a, bm=32, bk=32)
    op = bsr.bsr_operand(a, bm=32, bk=32)
    v = rng.standard_normal((m, k)).astype(np.float32)
    u = rng.standard_normal((n, k)).astype(np.float32)
    np.testing.assert_allclose(
        bsr_spmm(op.bsr, torch.from_numpy(v)).numpy(),
        np.asarray(ref_spmm(op_ref.bsr, jnp.asarray(v), interpret=True)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        bsr_spmm_t(op, torch.from_numpy(u)).numpy(),
        np.asarray(ref_spmm_t(op_ref, jnp.asarray(u), interpret=True)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,k", [(513, 40), (64, 5), (256, 33), (20112, 5)])
def test_gram_matches_reference(n, k):
    u = np.array(jax.random.normal(jax.random.PRNGKey(n + k), (n, k)))
    want = ref_gram(jnp.asarray(u), interpret=True)
    got = gram(torch.from_numpy(u))
    assert got.dtype == torch.float32 and got.shape == (k, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-3)


def _fused_case(case, rng):
    if case == "random":
        return _rand_sparse(rng, 257, 129), 5
    if case == "wide":
        return _rand_sparse(rng, 300, 200), 24
    if case == "unreferenced":
        a = np.zeros((128, 256), np.float32)
        a[:64, :64] = rng.random((64, 64))  # only column-block 0 referenced
        return a, 7
    return np.zeros((100, 180), np.float32), 4  # all zero


@pytest.mark.parametrize("case", ["random", "wide", "unreferenced",
                                  "all_zero"])
def test_fused_spmm_gram_matches_reference(case):
    rng = np.random.default_rng(4)
    a, k = _fused_case(case, rng)
    port = bsr.bsr_from_dense(a, bm=64, bk=64)
    reference = ref_bsr.bsr_from_dense(a, bm=64, bk=64)
    u = rng.standard_normal((a.shape[1], k)).astype(np.float32)
    y, g = bsr_spmm_gram(port, torch.from_numpy(u))
    y_ref, g_ref = ref_fused(reference, jnp.asarray(u), interpret=True)
    np.testing.assert_array_equal(y.numpy(),
                                  bsr_spmm(port, torch.from_numpy(u)).numpy())
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), u.T @ u, rtol=1e-5, atol=1e-4)


def test_fused_spmm_gram_t_orientation():
    rng = np.random.default_rng(11)
    a = _rand_sparse(rng, 257, 129)
    op = bsr.bsr_operand(a, bm=64, bk=64)
    u = rng.standard_normal((257, 5)).astype(np.float32)
    y, g = bsr_spmm_gram_t(op, torch.from_numpy(u))
    np.testing.assert_array_equal(
        y.numpy(), bsr_spmm_t(op, torch.from_numpy(u)).numpy())
    np.testing.assert_allclose(y.numpy(), a.T @ u, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), u.T @ u, rtol=1e-5, atol=1e-4)


def test_ops_entry_points_dispatch_to_wrappers():
    rng = np.random.default_rng(2)
    a = _rand_sparse(rng, 90, 70)
    op = ops.bsr_operand(a, bm=32, bk=32)
    v = torch.from_numpy(rng.standard_normal((70, 3)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((90, 3)).astype(np.float32))
    np.testing.assert_allclose(ops.spmm(op.bsr, v).numpy(), a @ v.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ops.spmm_t(op, u).numpy(), a.T @ u.numpy(),
                               rtol=1e-4, atol=1e-4)
    y, g = ops.spmm_gram(op.bsr, v)
    np.testing.assert_allclose(g.numpy(), v.numpy().T @ v.numpy(),
                               rtol=1e-5, atol=1e-4)
    y, g = ops.spmm_t_gram(op, u)
    np.testing.assert_allclose(y.numpy(), a.T @ u.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ops.gram_matrix(u).numpy(),
                               u.numpy().T @ u.numpy(), rtol=1e-4, atol=1e-3)
    tau = torch.tensor(0.3)
    np.testing.assert_array_equal(
        ops.fused_project_mask(u, tau).numpy(),
        np.where(np.maximum(u.numpy(), 0) >= 0.3, np.maximum(u.numpy(), 0),
                 0))


def test_cpu_wrappers_count_no_launches():
    _build.reset_launch_counts()
    u = torch.ones((8, 2))
    gram(u)
    project_mask(u, torch.tensor(0.5))
    assert _build.launch_counts() == {name: 0 for name in _build.KERNELS}


def _fake_source(tmp_path, monkeypatch):
    """A source and an empty build directory of its own; starting ``nvcc``
    raises (the CPU has none), recording whether the library's lock was
    held by the caller at that moment."""
    import fcntl

    source = tmp_path / "k.cu"
    source.write_text("// kernel\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.BUILD_DIR.mkdir()
    out = _build._target(source)
    seen = []

    def no_nvcc(*a, **k):
        with open(out.with_suffix(".lock"), "w") as probe:
            try:
                fcntl.flock(probe, fcntl.LOCK_EX | fcntl.LOCK_NB)
                seen.append("unlocked")
            except BlockingIOError:
                seen.append("locked")
        raise AssertionError("nvcc started")

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", no_nvcc)
    return source, out, seen


def test_a_build_waits_for_another_live_build(tmp_path, monkeypatch):
    """Processes that share the build directory compile a source once: a
    second caller waits while another holds the library's lock, then
    takes the library it renamed into place."""
    import fcntl
    import threading

    source, out, seen = _fake_source(tmp_path, monkeypatch)
    holder = open(out.with_suffix(".lock"), "w")
    fcntl.flock(holder, fcntl.LOCK_EX)

    def land():
        out.write_bytes(b"library")
        holder.close()

    threading.Timer(0.5, land).start()
    assert _build._start_build(source) is None
    assert out.read_bytes() == b"library" and not seen


def test_a_dead_builds_marker_is_passed_over(tmp_path, monkeypatch):
    """A process that died building leaves its lock file, but not its
    lock: the caller builds, holding the lock while ``nvcc`` starts and
    letting it go once that fails."""
    import fcntl

    source, out, seen = _fake_source(tmp_path, monkeypatch)
    out.with_suffix(".lock").write_text("")
    with pytest.raises(AssertionError, match="nvcc started"):
        _build._start_build(source)
    assert seen == ["locked"]
    with open(out.with_suffix(".lock"), "w") as probe:
        fcntl.flock(probe, fcntl.LOCK_EX | fcntl.LOCK_NB)
