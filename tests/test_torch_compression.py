"""Port parity for top-k compressed data-parallel gradients with error
feedback (``training/compression.py``).

* ``sparsify_tree`` is bitwise the reference's at f32 (the same bisection
  threshold).
* On four gloo CPU ranks (a data axis of 4): the conservation property of
  ``tests/test_distributed.py:108-141`` (compressed average + mean error
  slot == the uncompressed gradient, within 1e-5) on the first call and,
  with the slots carried, on the next; the loss, the averaged gradient and
  each rank's slot against the reference's ``shard_map`` on four XLA host
  devices.  One rank holds one slot (ROADMAP queue 3), so rank r's slot is
  row r of the reference's stacked state.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training.compression import sparsify_tree as ref_sparsify
from repro_torch.launch.mesh import spawn_mesh
from repro_torch.training import init_error_state, sparsify_tree

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _arrays():
    """The reference test's inputs (``tests/test_distributed.py:117-120``)."""
    return {"w": np.random.default_rng(0).standard_normal((8, 4))
            .astype(np.float32),
            "x": np.random.default_rng(1).standard_normal((16, 8))
            .astype(np.float32),
            "y": np.random.default_rng(2).standard_normal((16, 4))
            .astype(np.float32)}


def _full_grad(a):
    w = torch.from_numpy(a["w"]).requires_grad_()
    loss = torch.mean((torch.from_numpy(a["x"]) @ w
                       - torch.from_numpy(a["y"])) ** 2)
    return torch.autograd.grad(loss, w)[0].numpy(), float(loss.detach())


@pytest.mark.parametrize("density", [0.01, 0.1, 0.25, 0.5, 1.0])
def test_sparsify_tree_is_bitwise_the_reference(density):
    rng = np.random.default_rng(int(density * 100))
    tree = {"a": rng.standard_normal((33, 17)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "c": rng.standard_normal((4, 6, 8)).astype(np.float32)}
    want_s, want_e = ref_sparsify({k: jnp.asarray(v) for k, v in
                                   tree.items()}, density)
    got_s, got_e = sparsify_tree({k: torch.from_numpy(v) for k, v in
                                  tree.items()}, density)
    for k in tree:
        np.testing.assert_array_equal(got_s[k].numpy(), np.asarray(want_s[k]))
        np.testing.assert_array_equal(got_e[k].numpy(), np.asarray(want_e[k]))
        kept = int((got_s[k] != 0).sum())
        assert kept >= max(int(tree[k].size * density), 1)


def test_init_error_state_is_one_slot_a_rank():
    params = {"w": torch.ones((3, 2)), "b": torch.ones((2,))}
    err = init_error_state(params, 4)
    assert {k: tuple(v.shape) for k, v in err.items()} == \
        {"w": (3, 2), "b": (2,)}
    assert all(v.dtype == torch.float32 and not v.any() for v in err.values())
    with pytest.raises(ValueError, match="ndp"):
        init_error_state(params, 0)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("compress") / "store"
    return spawn_mesh(ranks.compressed_grads, 4, 1, backend="gloo",
                      device="cpu", init_file=str(path),
                      args=(_arrays(), 0.25, 2), timeout=120.0, threads=1)


@pytest.mark.parametrize("call", [0, 1])
def test_conservation_on_four_gloo_ranks(four_ranks, call):
    """mean_dp(g_sparse) + mean_dp(err_out) == full gradient +
    mean_dp(err_in): what the projections dropped is kept, every call."""
    full, loss = _full_grad(_arrays())
    outs = [r[0][call] for r in four_ranks]
    g = outs[0]["g"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["g"], g)      # one all-reduced sum
    recon = g + np.mean([o["err"] for o in outs], axis=0)
    want = full + np.mean([o["err_in"] for o in outs], axis=0)
    assert float(np.max(np.abs(recon - want))) < 1e-5
    assert np.mean(g != 0) <= 1.0
    if call == 0:
        assert outs[0]["loss"] == pytest.approx(loss, rel=1e-6)
        assert not any(o["err_in"].any() for o in outs)


def test_collectives_are_counted_one_a_leaf_and_one_for_the_loss(four_ranks):
    for _, counts in four_ranks:
        assert counts["all_reduce"] == 2 * 2        # 2 calls x (w, loss)
        assert counts["bytes"] == 2 * (8 * 4 * 4 + 4)


_REFERENCE = textwrap.dedent("""
    import jax, jax.numpy as jnp, numpy as np, json
    from repro.compat import set_mesh
    from repro.training.compression import (
        make_compressed_grad_fn, init_error_state)
    a = {arrays}
    mesh = jax.make_mesh((4,), ("data",))
    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return jnp.mean((pred - batch["y"]) ** 2)
    params = {{"w": jnp.asarray(np.asarray(a["w"], np.float32))}}
    batch = {{k: jnp.asarray(np.asarray(a[k], np.float32))
              for k in ("x", "y")}}
    out = []
    with set_mesh(mesh):
        gf = make_compressed_grad_fn(loss_fn, mesh, ("data",), density=0.25)
        err = init_error_state(params, 4)
        for _ in range(2):
            loss, g, err = gf(params, batch, err)
            out.append({{"loss": float(loss),
                         "g": np.asarray(g["w"]).tolist(),
                         "err": np.asarray(err["w"]).tolist()}})
    print(json.dumps(out))
""")


def test_four_ranks_match_the_reference_shard_map(four_ranks):
    arrays = {k: v.tolist() for k, v in _arrays().items()}
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c",
                          _REFERENCE.format(arrays=repr(arrays))], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    for call in range(2):
        want = ref[call]
        assert four_ranks[0][0][call]["loss"] == pytest.approx(
            want["loss"], rel=1e-6)
        g = four_ranks[0][0][call]["g"]
        np.testing.assert_allclose(g, np.asarray(want["g"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(g != 0, np.asarray(want["g"]) != 0)
        for r, (out, _) in enumerate(four_ranks):
            np.testing.assert_allclose(out[call]["err"],
                                       np.asarray(want["err"][r]),
                                       rtol=1e-5, atol=1e-6)
