"""The port's expert-parallel MoE body (``models/moe.py::moe_ffn_ep``) on
four gloo ranks on the CPU, held against the reference's ``moe_ffn_ep``
(its ``shard_map`` with two ``all_to_all`` over ``"model"``) on four XLA
host devices in a subprocess, as ``tests/test_distributed.py::
run_with_devices`` runs it, and against the port's plain single-process
version of the body.

Two grids of the same four ranks: (data, model) = 2x2 and (pod, data,
model) = 2x1x2.  The smoke olmoe config (d 64, 8 experts, top 2), its
router and experts from the reference's initializer, inputs from numpy;
f32, outputs within 1e-5.  ``x`` (4, 16, d) takes the expert-parallel
branch; ``x_odd`` (4, 7, d) has ``S % model != 0`` and takes the
one-group branch in both packages.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.models import moe as ref_moe
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch.mesh import spawn_mesh
from repro_torch.models import moe

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = dict(rtol=1e-5, atol=1e-5)
GRIDS = {"2x2": (1, 2, 2), "2x1x2": (2, 1, 2)}
LEAVES = ("router", "w_gate", "w_up", "w_down")

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import set_mesh
    from repro.configs import ARCHS, smoke_config
    from repro.models import moe
    d = np.load(sys.argv[1])
    cfg = smoke_config(ARCHS["olmoe-1b-7b"])
    p = {n: jnp.asarray(d[n]) for n in ("router", "w_gate", "w_up",
                                        "w_down")}
    out = {}
    for grid, shape, axes in (("2x2", (2, 2), ("data", "model")),
                              ("2x1x2", (2, 1, 2), ("pod", "data", "model"))):
        with set_mesh(jax.make_mesh(shape, axes)):
            for name in ("x", "x_odd"):
                y = moe.moe_ffn_ep(p, jnp.asarray(d[name]), cfg)
                out[grid + "/" + name] = np.asarray(y).tolist()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(inputs, the ranks' results on both grids, the reference's
    outputs); the reference's subprocess runs while the ranks do."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    cfg = ref_smoke_config(REF_ARCHS["olmoe-1b-7b"])
    p = jax.tree.map(np.array, ref_moe.init_moe_ffn(jax.random.PRNGKey(3),
                                                       cfg))
    rng = np.random.default_rng(4)
    arrays = dict(p, x=rng.standard_normal((4, 16, cfg.d_model)).astype(
        np.float32), x_odd=rng.standard_normal((4, 7, cfg.d_model)).astype(
            np.float32))
    path = tmp / "in.npz"
    np.savez(path, **arrays)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(path)],
                           env=env, text=True, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE)
    try:
        out = spawn_mesh(ranks.moe_ep, 2, 2, backend="gloo", device="cpu",
                         init_file=str(tmp / "store"),
                         args=(str(path), tuple(GRIDS.values())),
                         timeout=120.0, threads=1)
    finally:
        stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0, stderr[-3000:]
    want = {k: np.asarray(v, np.float32)
            for k, v in json.loads(stdout.strip().splitlines()[-1]).items()}
    return arrays, out, want


def _assembled(out, grid, name, shape):
    """The whole output from the ranks' blocks (each in its place)."""
    y = np.full(shape, np.nan, np.float32)
    for rec in out:
        r = rec[GRIDS[grid] + (name,)]
        b0, b1, s0, s1 = r["block"]
        y[b0:b1, s0:s1] = r["y"]
    return y


def _port_weights(arrays):
    return {n: torch.from_numpy(arrays[n]) for n in LEAVES}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_expert_parallel_body_matches_the_reference_shard_map(case, grid):
    arrays, out, want = case
    x = arrays["x"]
    for rec in out:
        r = rec[GRIDS[grid] + ("x",)]
        assert r["y"].shape == (2, 8, x.shape[-1])     # B / dp, S / model
    y = _assembled(out, grid, "x", x.shape)
    np.testing.assert_allclose(y, want[f"{grid}/x"], **TOL)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_expert_parallel_body_matches_the_plain_version(case, grid):
    """The plain body in one process (the exchange as a transpose) gives
    every rank's block; it is not the one-group ``moe_ffn``."""
    arrays, out, _ = case
    cfg = smoke_config(ARCHS["olmoe-1b-7b"])
    p, x = _port_weights(arrays), torch.from_numpy(arrays["x"])
    plain = moe.moe_ffn_ep_plain(p, x, cfg, dp=2, model=2).numpy()
    np.testing.assert_allclose(_assembled(out, grid, "x", x.shape), plain,
                               **TOL)
    one_group = moe.moe_ffn_ep(p, x, cfg).numpy()
    assert np.max(np.abs(one_group - plain)) > 1e-3


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_an_indivisible_sequence_takes_the_one_group_branch(case, grid):
    """S = 7 on a model axis of 2: every rank runs all B * S tokens as one
    group and returns the whole output, as the reference does; no
    ``all_to_all`` is issued."""
    arrays, out, want = case
    cfg = smoke_config(ARCHS["olmoe-1b-7b"])
    x = torch.from_numpy(arrays["x_odd"])
    assert not moe.ep_applies(cfg, 2, 2, *x.shape[:2])
    whole = moe.moe_ffn_ep(_port_weights(arrays), x, cfg).numpy()
    for rec in out:
        r = rec[GRIDS[grid] + ("x_odd",)]
        np.testing.assert_array_equal(r["y"], whole)
        assert "all_to_all" not in r["counts"]
    np.testing.assert_allclose(whole, want[f"{grid}/x_odd"], **TOL)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_all_to_all_calls_and_bytes_are_counted(case, grid):
    """Two exchanges a call, each this rank's (model, E / model * C, d)
    f32 buffer: C = max(ceil(2 * 8 * 2 / 8 * 1.25), 4) = 5 for its 16
    tokens; no ``all_reduce``."""
    _, out, _ = case
    cap = max(int(np.ceil(16 * 2 / 8 * 1.25)), moe.EP_MIN_CAPACITY)
    assert cap == 5
    for rec in out:
        counts = rec[GRIDS[grid] + ("x",)]["counts"]
        assert counts == {"all_reduce": 0, "bytes": 0, "all_to_all": 2,
                          "all_to_all_bytes": 2 * (2 * 4 * cap * 64 * 4)}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_all_to_all_sends_part_g_to_the_gth_rank(case, grid):
    """On both grids: over ``"model"`` (and over ``("pod", "data")``), the
    g-th rank of a group receives part g of every member's tensor in the
    members' order; an axis of one rank is not exchanged."""
    _, out, _ = case
    for rank, rec in enumerate(out):
        got = rec[GRIDS[grid] + ("exchange",)]
        model = [2 * (rank // 2), 2 * (rank // 2) + 1]
        me = model.index(rank)
        np.testing.assert_array_equal(
            got[("model",)], np.concatenate(
                [1000.0 * m + np.arange(2 * me, 2 * me + 2) for m in model]))
        rows = [rank % 2, rank % 2 + 2]
        key = ("pod",) if grid == "2x1x2" else ("data",)
        assert key in got and ("pod", "data") in got
        np.testing.assert_array_equal(got[key], got[("pod", "data")])
        np.testing.assert_array_equal(got[key], np.concatenate(
            [1000.0 * m + np.arange(2 * (rank // 2), 2 * (rank // 2) + 2)
             for m in rows]))
        if grid == "2x2":
            assert ("pod",) not in got
        else:
            assert ("data",) not in got
