"""The port's mesh layer: the grid (``launch/mesh.py``), the shard ingest
(``core/distributed.py``) and the histogram top-t (``DistTopK``), held
against the reference (``repro.launch.mesh``, ``repro.core.distributed``,
``repro.core.topk``) on the same numpy inputs.

* Each rank's block, densified, equals the reference's ``distribute_bsr`` /
  ``distribute_csr`` shard to rtol 1e-6, both orientations, from every
  input form; the ingest never densifies sparse input; a ``bcap`` below a
  row-block's occupancy warns and keeps the largest tiles; an unaligned
  shape raises.
* ``dist_topk_threshold`` on one rank gives the reference's 1x1 ``tau`` to
  rtol 1e-6 with the same kept set; on a 2x2 grid of gloo ranks (spawned
  on the CPU, a ``file://`` store in ``tmp_path``) it gives one rank's
  ``tau`` over the whole factor.
* The grid's groups (row-major ranks, a sum over each axis), and its
  refusals: a wrong world size, ranks that disagree on the shape, a rank
  that fails.
* A rank's own block fingerprints alike on every rank (an ``all_reduce``
  of every block's digest).
* The ``"pod"`` axis: eight gloo ranks as a 2x2x2 (pod, data, model)
  grid, its groups and ``all_to_all``; the reference's
  ``test_dist_als_multipod_axes`` inputs fitted with ``make_sharded_als(
  mesh, ("pod", "data"), "model", ...)`` at that test's bar, within 1e-4
  of the reference's own 2x2x2 run (on eight XLA host devices in a
  subprocess) and bitwise the same ranks' 4x2 fit; ``DistTopK(40, ("pod",
  "data"))``; compressed gradients over ``("pod", "data")`` at the
  reference's conservation bar.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core.distributed import distribute_bsr as ref_distribute_bsr
from repro.core import init_u0 as ref_init_u0
from repro.core.distributed import distribute_csr as ref_distribute_csr
from repro.data import synthetic_journal_corpus as ref_corpus
from repro.kernels.bsr import BSR as RefBSR
from repro.kernels.bsr import bsr_to_dense as ref_bsr_to_dense
from repro.sparse import to_dense as ref_to_dense
from repro_torch.core.distributed import distribute_bsr, shard_grid
from repro_torch.core.topk import DistTopK, dist_topk_threshold
from repro_torch.kernels.bsr import bsr_operand, bsr_to_dense
from repro_torch.launch.mesh import (
    collective_counts, make_nmf_mesh, reset_collective_counts, spawn_mesh,
)
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
from repro_torch.sparse import from_dense, to_dense

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 60.0
SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(scope="module")
def corpus():
    a_sp, _ = ref_corpus(n_terms=96, n_docs=64, n_journals=4, seed=9)
    return np.asarray(ref_to_dense(a_sp))


def _spawn(fn, shape, tmp_path, *args):
    return spawn_mesh(fn, *shape, backend="gloo", device="cpu",
                      init_file=str(tmp_path / "store"), args=args,
                      timeout=SPAWN_TIMEOUT, threads=1)


# ---------------------------------------------------------------------------
# the shard ingest against the reference's stacked grid
# ---------------------------------------------------------------------------

_FORMS = {
    "scipy": sp.csr_matrix,
    "spcsr": from_dense,
    "dense": lambda a: a,
    "bsr": lambda a: bsr_operand(a, bm=16, bk=16),
}


@pytest.mark.parametrize("grid", [(2, 2), (4, 1)])
@pytest.mark.parametrize("form", sorted(_FORMS))
def test_bsr_blocks_match_reference_shards(corpus, grid, form):
    """Every rank's BSR block, both orientations, densifies to the
    reference's (i, j) shard of ``distribute_bsr``."""
    a = corpus
    r, c = grid
    n_loc, m_loc = a.shape[0] // r, a.shape[1] // c
    ref = ref_distribute_bsr(a, r, c, bm=16, bk=16)
    blocks = shard_grid(_FORMS[form](a), grid, "bsr", bm=16, bk=16)
    for i in range(r):
        for j in range(c):
            blk = blocks[i][j]
            assert blk.index == (i, j) and blk.shape == a.shape
            want = np.asarray(ref_bsr_to_dense(RefBSR(
                ref.tiles[i, j], ref.block_cols[i, j], (n_loc, m_loc))))
            want_t = np.asarray(ref_bsr_to_dense(RefBSR(
                ref.tiles_t[i, j], ref.block_cols_t[i, j], (m_loc, n_loc))))
            np.testing.assert_allclose(bsr_to_dense(blk.op.bsr).numpy(),
                                       want, rtol=1e-6)
            np.testing.assert_allclose(bsr_to_dense(blk.op.bsr_t).numpy(),
                                       want_t, rtol=1e-6)
            np.testing.assert_allclose(
                want, a[i * n_loc:(i + 1) * n_loc, j * m_loc:(j + 1) * m_loc],
                rtol=1e-6)


@pytest.mark.parametrize("grid", [(2, 2), (4, 1)])
def test_csr_blocks_match_reference_shards(corpus, grid):
    """Every rank's padded-CSR block, both orientations, densifies to the
    reference's ``distribute_csr`` shard."""
    a = corpus
    r, c = grid
    n_loc, m_loc = a.shape[0] // r, a.shape[1] // c
    ref = ref_distribute_csr(a, r, c)
    blocks = shard_grid(sp.csr_matrix(a), grid, "csr")

    def ref_dense(values, cols, rows, width):
        out = np.zeros((rows, width), np.float32)
        np.add.at(out, (np.arange(rows)[:, None].repeat(values.shape[1], 1),
                        cols), values)
        return out

    for i in range(r):
        for j in range(c):
            blk = blocks[i][j]
            np.testing.assert_allclose(
                to_dense(blk.fwd).numpy(),
                ref_dense(np.asarray(ref.values[i, j]),
                          np.asarray(ref.cols[i, j]), n_loc, m_loc),
                rtol=1e-6)
            np.testing.assert_allclose(
                to_dense(blk.tsp).numpy(),
                ref_dense(np.asarray(ref.values_t[i, j]),
                          np.asarray(ref.cols_t[i, j]), m_loc, n_loc),
                rtol=1e-6)


def test_block_ingest_never_densifies(corpus, monkeypatch):
    """No dense (n, m) temporary in the shard ingest: a distributed fit on
    SpCSR and scipy input, both block formats, with every densifier
    booby-trapped."""
    import repro_torch.core.distributed as dist_mod
    import repro_torch.kernels.bsr as bsr_mod
    import repro_torch.sparse.csr as csr_mod

    def boom(*args, **kw):
        raise AssertionError("the shard ingest densified the matrix")

    monkeypatch.setattr(csr_mod, "to_dense", boom)
    monkeypatch.setattr(bsr_mod, "bsr_to_dense", boom)
    monkeypatch.setattr(dist_mod, "distribute_csr", boom)
    real_nonzero = np.nonzero

    def no_dense_nonzero(x, *args, **kw):
        if np.ndim(x) == 2 and np.shape(x) == corpus.shape:
            raise AssertionError("the shard ingest scanned a dense matrix")
        return real_nonzero(x, *args, **kw)

    monkeypatch.setattr(dist_mod.np, "nonzero", no_dense_nonzero)
    for backend in ("cuda-bsr", "torch-csr"):
        for a in (from_dense(corpus), sp.csr_matrix(corpus)):
            model = EnforcedNMF(NMFConfig(k=4, iters=3, solver="distributed",
                                          backend=backend,
                                          sparsity=Sparsity(t_u=40)),
                                device="cpu").fit(a)
            assert model.u_.shape == (96, 4)
            assert np.isfinite(model.result_.final_error)


def test_bsr_truncation_warns_and_keeps_largest():
    a = np.zeros((8, 32), np.float32)
    for j in range(4):
        a[:, j * 8:(j + 1) * 8] = j + 1.0
    with pytest.warns(UserWarning, match="largest-Frobenius-norm"):
        blk = distribute_bsr(a, (1, 1), (0, 0), bm=8, bk=8, bcap=2,
                             device="cpu")
    assert tuple(blk.op.bsr.tiles.shape) == (1, 2, 8, 8)
    np.testing.assert_array_equal(blk.op.bsr.block_cols[0].numpy(), [2, 3])
    np.testing.assert_allclose(blk.op.bsr.tiles[0, 0].numpy(), 3.0)
    np.testing.assert_allclose(blk.op.bsr.tiles[0, 1].numpy(), 4.0)
    # the transposed orientation, uncapped, kept every tile
    assert tuple(blk.op.bsr_t.tiles.shape) == (4, 1, 8, 8)


def test_unaligned_shapes_raise():
    with pytest.raises(ValueError, match="divisible"):
        distribute_bsr(np.ones((9, 8), np.float32), (2, 2), (0, 0), bm=4,
                       bk=4, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        shard_grid(np.ones((8, 9), np.float32), (2, 2), "csr")
    with pytest.raises(ValueError, match="divisible by mesh_shape"):
        EnforcedNMF(NMFConfig(k=2, iters=2, solver="distributed",
                              mesh_shape=(3, 1)),
                    device="cpu").fit(np.ones((8, 6), np.float32))


# ---------------------------------------------------------------------------
# DistTopK
# ---------------------------------------------------------------------------

def _ref_tau_1x1(x, t):
    from jax.sharding import PartitionSpec as P

    from repro.compat import SHARD_MAP_NO_CHECK, shard_map
    from repro.core.topk import DistTopK as RefDistTopK
    from repro.core.topk import dist_topk_threshold as ref_threshold

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    tau = shard_map(lambda y: ref_threshold(y, t, ("data",)), mesh=mesh,
                    in_specs=P(), out_specs=P(), **SHARD_MAP_NO_CHECK)(x)
    kept = shard_map(RefDistTopK(t, ("data",)), mesh=mesh, in_specs=P(),
                     out_specs=P(), **SHARD_MAP_NO_CHECK)(x)
    return float(tau), np.asarray(kept)


@pytest.mark.parametrize("shape,t,scale", [
    ((64, 8), 100, 1.0), ((256, 5), 55, 3.0), ((128, 5), 300, 1e-3),
    ((40, 3), 1, 1.0)])
def test_dist_topk_one_rank_matches_reference(shape, t, scale):
    """One rank (a 1x1 mesh, no process group) gives the reference's 1x1
    ``tau`` to rtol 1e-6 and keeps the same set, the same values."""
    rng = np.random.default_rng(sum(shape) + t)
    x = (rng.random(shape, dtype=np.float32) * scale).astype(np.float32)
    x[rng.random(shape) < 0.3] = 0.0
    mesh = make_nmf_mesh(1, 1, device="cpu")
    tau = float(dist_topk_threshold(torch.from_numpy(x), t, mesh,
                                    ("data",)))
    kept = DistTopK(t, mesh, ("data",))(torch.from_numpy(x)).numpy()
    ref_tau, ref_kept = _ref_tau_1x1(jnp.asarray(x), t)
    np.testing.assert_allclose(tau, ref_tau, rtol=1e-6)
    np.testing.assert_array_equal(kept != 0, ref_kept != 0)
    np.testing.assert_array_equal(kept, ref_kept)
    assert t <= int((kept != 0).sum())


def test_dist_topk_keeps_the_exact_top_t():
    from repro_torch.core.topk import topk_project_exact

    x = torch.rand((64, 8), generator=torch.Generator().manual_seed(42))
    mesh = make_nmf_mesh(1, 1, device="cpu")
    kept = DistTopK(100, mesh, ("data",))(x) != 0
    exact = topk_project_exact(x, 100) != 0
    assert bool(kept[exact].all())
    assert 100 <= int(kept.sum()) <= 105
    assert int((DistTopK(0, mesh, ("data",))(x) != 0).sum()) == 0


def test_dist_topk_on_2x2_is_one_rank_over_the_whole_factor(tmp_path):
    """Four ranks, each holding its rows of U (replicated over ``model``):
    the ``tau`` of every rank is one rank's ``tau`` over the whole factor,
    and the blocks' kept sets tile the whole factor's."""
    rng = np.random.default_rng(7)
    x = rng.random((96, 5), dtype=np.float32)
    x[rng.random(x.shape) < 0.4] = 0.0
    t = 60
    mesh = make_nmf_mesh(1, 1, device="cpu")
    tau1 = float(dist_topk_threshold(torch.from_numpy(x), t, mesh,
                                     ("data",)))
    kept1 = (DistTopK(t, mesh, ("data",))(torch.from_numpy(x)) != 0).numpy()
    out = _spawn(ranks.topk_blocks, (2, 2), tmp_path, x, t, (2, 2))
    for rec in out:
        assert rec["tau"] == tau1
        rows = slice(rec["i"] * 48, (rec["i"] + 1) * 48)
        np.testing.assert_array_equal(rec["kept"], kept1[rows])


# ---------------------------------------------------------------------------
# the grid and its refusals
# ---------------------------------------------------------------------------

def test_one_by_one_mesh_runs_without_a_process_group():
    mesh = make_nmf_mesh(1, 1, device="cpu")
    assert (mesh.i, mesh.j, mesh.rank, mesh.size) == (0, 0, 0, 1)
    assert mesh.row_group is None and mesh.col_group is None
    reset_collective_counts()
    x = torch.arange(4.0)
    assert mesh.all_reduce(x, ("data", "model")) is x
    assert mesh.gather(x, 4, "data") is x
    assert collective_counts()["all_reduce"] == 0
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_nmf_mesh(2, 2, device="cpu")


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_grid_is_row_major_with_a_group_per_axis(shape, tmp_path):
    """Rank r sits at divmod(r, cols); a sum over ``"data"`` runs over the
    ranks of its column, over ``"model"`` over the ranks of its row."""
    r, c = shape
    out = _spawn(ranks.mesh_of, shape, tmp_path, shape)
    for rank, rec in enumerate(out):
        i, j = divmod(rank, c)
        assert (rec["i"], rec["j"]) == (i, j)
        assert rec["data"] == sum(ii * c + j for ii in range(r))
        assert rec["model"] == sum(i * c + jj for jj in range(c))
        assert rec["both"] == sum(range(r * c))
        assert rec["max"] == (r - 1) * c + j


def test_a_made_mesh_is_returned_without_a_collective(tmp_path):
    """Only the first ``make_nmf_mesh`` of a grid is collective (its shape
    check), so a later call is safe off the main thread."""
    for rec in _spawn(ranks.mesh_made_twice, (2, 2), tmp_path, (2, 2)):
        assert rec == dict(made=1, again=0, same=True)


def test_wrong_world_size_and_disagreeing_ranks_raise(tmp_path):
    with pytest.raises(RuntimeError, match="needs 4 devices, have 2"):
        spawn_mesh(ranks.mesh_shape_per_rank, 1, 2, backend="gloo",
                   device="cpu", init_file=str(tmp_path / "a"),
                   args=([(2, 2), (2, 2)],), timeout=SPAWN_TIMEOUT)
    with pytest.raises(RuntimeError, match="disagree on mesh_shape"):
        spawn_mesh(ranks.mesh_shape_per_rank, 1, 2, backend="gloo",
                   device="cpu", init_file=str(tmp_path / "b"),
                   args=([(1, 2), (2, 1)],), timeout=SPAWN_TIMEOUT)


def test_a_failed_rank_fails_the_grid(tmp_path):
    with pytest.raises(RuntimeError, match="rank 2 fails on purpose"):
        _spawn(ranks.fail_on, (2, 2), tmp_path, 2)
    # the next grid meets through a store of its own, never the failed
    # grid's file
    again = tmp_path / "again"
    again.mkdir()
    assert _spawn(ranks.fail_on, (2, 2), again, -1) == [0, 1, 2, 3]


def test_block_fingerprints_agree_over_the_grid(corpus, tmp_path):
    """A rank's own block is fingerprinted by the digests of every block of
    the grid, gathered by an ``all_reduce``: every rank gets the same dict;
    another grid, or another matrix, gets another digest.  The whole input
    fingerprints alike on every rank and every grid."""
    out = _spawn(ranks.block_fingerprints, (2, 2), tmp_path, corpus, (2, 2))
    for rec in out:
        assert rec == out[0]
    assert out[0]["cuda-bsr"]["kind"] == "dist-bsr"
    assert out[0]["torch-csr"]["kind"] == "dist-csr"
    assert out[0]["cuda-bsr"]["grid"] == [2, 2]
    other = _spawn(ranks.block_fingerprints, (4, 1), tmp_path, corpus,
                   (4, 1))
    assert other[0]["whole"] == out[0]["whole"]
    assert other[0]["cuda-bsr"]["digest"] != out[0]["cuda-bsr"]["digest"]
    changed = corpus.copy()
    changed[5, 7] += 1.0
    moved = _spawn(ranks.block_fingerprints, (2, 2), tmp_path, changed,
                   (2, 2))
    assert moved[0]["cuda-bsr"]["digest"] != out[0]["cuda-bsr"]["digest"]


# ---------------------------------------------------------------------------
# the "pod" axis: eight gloo ranks as a 2x2x2 grid
# ---------------------------------------------------------------------------

_MULTIPOD_REF = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import PartitionSpec as P, NamedSharding
    from repro.compat import set_mesh
    from repro.backend.sharded import make_sharded_als
    from repro.core.distributed import distribute_csr
    from repro.core.topk import DistTopK
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    dist = distribute_csr(d["a"], 4, 2)
    with set_mesh(mesh):
        run = make_sharded_als(mesh, ("pod", "data"), "model",
                               sparsify_u=DistTopK(40, ("pod", "data")),
                               sparsify_v=DistTopK(100, ("model",)))
        a_sh = NamedSharding(mesh, P(("pod", "data"), "model", None, None))
        dist = jax.tree_util.tree_map(lambda x: jax.device_put(x, a_sh),
                                      dist)
        u0 = jax.device_put(d["u0"],
                            NamedSharding(mesh, P(("pod", "data"), None)))
        res = run(dist, u0, 10)
    print(json.dumps({"err": np.asarray(res.error).tolist(),
                      "res": np.asarray(res.residual).tolist()}))
""")


@pytest.fixture(scope="module")
def multipod(tmp_path_factory):
    """The inputs of ``tests/test_distributed.py::test_dist_als_multipod_
    axes`` (128 x 64, 4 journals, seed 2, k = 4), the eight ranks'
    results, and the reference's 2x2x2 trace (run at the same time)."""
    tmp = tmp_path_factory.mktemp("multipod")
    a_sp, _ = ref_corpus(n_terms=128, n_docs=64, n_journals=4, seed=2)
    rng = np.random.default_rng(3)
    arrays = dict(
        a=np.asarray(ref_to_dense(a_sp)),
        u0=np.asarray(ref_init_u0(jax.random.PRNGKey(2), 128, 4)),
        x=rng.standard_normal((128, 4)).astype(np.float32),
        # tests/test_distributed.py:108-141's least-squares problem
        w=np.random.default_rng(0).standard_normal((8, 4)).astype(
            np.float32),
        bx=np.random.default_rng(1).standard_normal((16, 8)).astype(
            np.float32),
        by=np.random.default_rng(2).standard_normal((16, 4)).astype(
            np.float32))
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", _MULTIPOD_REF,
                            str(tmp / "in.npz")], env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out = spawn_mesh(ranks.multipod, 2, 2, pods=2, backend="gloo",
                         device="cpu", init_file=str(tmp / "store"),
                         args=(arrays, 0.25), timeout=2 * SPAWN_TIMEOUT,
                         threads=1)
    finally:
        stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0, stderr[-3000:]
    return arrays, out, json.loads(stdout.strip().splitlines()[-1])


def test_pod_grid_is_row_major_with_a_group_per_axis_set(multipod):
    """Rank r sits at (p, i, j) with r = (p * 2 + i) * 2 + j; a sum over an
    axis set runs over the ranks that share the other coordinates."""
    _, out, _ = multipod
    coords = [divmod(r // 2, 2) + (r % 2,) for r in range(8)]
    for rank, rec in enumerate(out):
        assert rec["coords"] == coords[rank] and rec["shape"] == (2, 2, 2)
        assert rec["row_index"] == rank // 2
        for axes, got in rec["sums"].items():
            fixed = [n for n, ax in enumerate(("pod", "data", "model"))
                     if ax not in axes]
            want = sum(r for r in range(8) if all(
                coords[r][n] == coords[rank][n] for n in fixed))
            assert got == want, (rank, axes)


def test_all_to_all_over_each_pod_grid_axis_set(multipod):
    """``all_to_all`` over an axis set: rank g of the set receives part g of
    every member's tensor, in the members' order (the reference's
    ``all_to_all(..., tiled=True)`` on dim 0)."""
    _, out, _ = multipod
    coords = [divmod(r // 2, 2) + (r % 2,) for r in range(8)]
    for rank, rec in enumerate(out):
        for axes, got in rec["exchange"].items():
            fixed = [n for n, ax in enumerate(("pod", "data", "model"))
                     if ax not in axes]
            members = [r for r in range(8) if all(
                coords[r][n] == coords[rank][n] for n in fixed)]
            me = members.index(rank)
            want = np.concatenate([1000.0 * m + np.arange(2 * me, 2 * me + 2)
                                   for m in members])
            np.testing.assert_array_equal(got, want.astype(np.float32))


def test_dist_topk_over_pod_and_data_is_one_rank_over_the_whole_factor(
        multipod):
    """``DistTopK(40, ("pod", "data"))`` on the four row blocks gives the
    threshold and kept set of one rank holding the whole factor."""
    arrays, out, _ = multipod
    whole = make_nmf_mesh(1, 1, device="cpu")
    x = torch.from_numpy(arrays["x"])
    tau = float(dist_topk_threshold(x, 40, whole, ("pod", "data")))
    kept = (DistTopK(40, whole, ("pod", "data"))(x) != 0).numpy()
    for rank, rec in enumerate(out):
        assert rec["tau"] == tau
        np.testing.assert_array_equal(
            rec["kept"], kept[32 * (rank // 2):32 * (rank // 2 + 1)])


def test_multipod_fit_meets_the_reference_bars(multipod):
    """Its own bar (``tests/test_distributed.py:105``: the last error
    finite and below 1.0) and the trace bar against the reference's 2x2x2
    run (1e-4, ``tests/test_backends.py:365-380``)."""
    _, out, ref = multipod
    fit = out[0]["fit_2x2x2"]
    assert np.isfinite(fit["err"][-1]) and fit["err"][-1] < 1.0
    np.testing.assert_allclose(fit["err"], ref["err"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(fit["res"], ref["res"], rtol=0, atol=1e-4)
    for rec in out:
        np.testing.assert_array_equal(rec["fit_2x2x2"]["err"], fit["err"])


def test_multipod_fit_is_bitwise_the_4x2_fit(multipod):
    """Rows over ("pod", "data") are one group of the ranks that share a
    column: the 2x2x2 fit reduces in the 4x2 fit's order, with the same
    collectives, and its factors and traces are bitwise that fit's."""
    _, out, _ = multipod
    for rec in out:
        a, b = rec["fit_2x2x2"], rec["fit_4x2"]
        for key in ("err", "res", "u", "v"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["collectives"] == b["collectives"]
        assert a["collectives"]["all_reduce"] > 0


def test_compressed_gradients_over_pod_and_data_are_conserved(multipod):
    """``make_compressed_grad_fn`` over ("pod", "data") (four blocks of the
    batch; the model axis holds copies): the sparse mean gradient plus the
    mean error slot is the whole gradient within 1e-5
    (``tests/test_distributed.py:108-141``)."""
    arrays, out, _ = multipod
    w = torch.from_numpy(arrays["w"]).requires_grad_(True)
    loss = torch.mean((torch.from_numpy(arrays["bx"]) @ w
                       - torch.from_numpy(arrays["by"])) ** 2)
    (full,) = torch.autograd.grad(loss, w)
    loss = loss.detach()
    by_dp = {rec["row_index"]: rec["compressed"] for rec in out}
    assert sorted(by_dp) == [0, 1, 2, 3]
    recon = out[0]["compressed"]["g"] + np.mean(
        [c["err"] for c in by_dp.values()], axis=0)
    assert np.max(np.abs(recon - full.numpy())) < 1e-5
    for rec in out:
        np.testing.assert_array_equal(rec["compressed"]["g"],
                                      out[0]["compressed"]["g"])
        assert rec["compressed"]["loss"] == pytest.approx(float(loss),
                                                          rel=1e-6)


def test_a_pod_grid_needs_its_world():
    with pytest.raises(ValueError, match=r"mesh_shape \(2, 2, 2\) needs 8"):
        make_nmf_mesh(2, 2, device="cpu", pods=2)
    with pytest.raises(ValueError, match="must be positive"):
        make_nmf_mesh(2, 2, device="cpu", pods=0)
