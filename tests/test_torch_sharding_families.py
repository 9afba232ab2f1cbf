"""The sharded train step (``training/sharding.py``) for the moe, hybrid,
ssm and encdec families on gloo ranks on the CPU, held against the port's
1x1 step and the reference's unsharded loss and gradients; their
leaf-by-leaf inits; the expert exchange under autograd; a restore that
reads one leaf at a time; and the train launcher's kill and resume for
olmoe on the grid.

* Step parity: the smoke configs (4 heads, which 2 and 4 divide; zamba2's
  8 SSM heads, xlstm's 4) on 2x2 and 4x1, in f32, on the reference's
  parameters (``convert.model_from_reference``) and a numpy batch: the
  loss at the reference's bars 1e-4 / 1e-5 and every gradient, gathered
  whole, at 1e-3 / 1e-5 (``tests/test_substrate.py:33,55``).  moe against
  the reference at a capacity factor where no token is dropped (4.0 = E /
  k: an expert's capacity is every token of its group, so grouping cannot
  matter), and at the default 1.25 against the port's 1x1 step whose MoE
  groups as the grid's does (``moe_ffn_ep_plain``: 2x2's expert-parallel
  blocks; 4x1's one group).
* Bytes: each rank's parameters, mu and nu are the reference's
  per-device shard bytes under its ``param_pspecs`` on the same grid.
* Init: ``sharding.init_sharded`` (each family's ``init_leaves``) is
  bitwise ``shard_model(api.init_params(...))``'s blocks, and each
  family's ``init_params`` is bitwise its ``init_leaves``.
* The exchange's gradient: ``moe_ffn_ep`` on 2x2 with its input and
  weights requiring gradients (``NMFMesh.all_to_all``, two exchanges
  forward, two backward): the ranks' gradients summed are
  ``moe_ffn_ep_plain``'s at 1e-5, and the weights' are the same with the
  input a constant.
* ``restore_state`` asks the checkpoint for one leaf at a time (no array
  it read is alive when it reads the next) and keeps each rank's block,
  bitwise the whole leaf cut.
* The launcher under ``torch.distributed.run``: olmoe's smoke config
  stopped at 6 on 2x2 and resumed to 9, bitwise the uninterrupted run; its
  step-6 checkpoint resumed on 4x1 within 1e-4 of the same checkpoint
  resumed on 1x1.  (Not of the 2x2 run: at the default capacity a 2x2
  grid's experts take each rank's block as a group and 4x1's every token
  as one, as the reference's do, so their drops differ; 4x1 and 1x1 group
  alike.)
"""
import concurrent.futures
import functools
import pickle
import shutil
import sys
import types
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import moe as ref_moe
from repro_torch.checkpoint import latest_step, load_checkpoint_arrays
from repro_torch.checkpoint import store
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import model_from_reference
from repro_torch.launch.mesh import NMFMesh, spawn_mesh
from repro_torch.layout import reference_leaf
from repro_torch.models import api, moe
from repro_torch.training import AdamW, sharding
from repro_torch.training.optimizer import value_and_grad

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
ARCHS_HERE = ("olmoe-1b-7b", "zamba2-7b", "xlstm-125m",
              "seamless-m4t-large-v2")
GRIDS = {"2x2": (2, 2), "4x1": (4, 1)}
#: E / k of the smoke olmoe: no expert can overflow
NO_DROP = 4.0
DEFAULT_CF = 1.25


def _at(tree, path):
    for key in path:
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def _batch(cfg, rng, b=4, s=16):
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}
    if cfg.family == "encdec":
        batch["frame_embeds"] = rng.standard_normal(
            (b, 2 * s, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(cfg, model, batch, moe_fn=None):
    """The port's 1x1 f32 loss and gradients, its MoE blocks through
    ``moe_fn`` when given."""
    with pytest.MonkeyPatch.context() as mp:
        if moe_fn is not None:
            mp.setattr(moe, "moe_ffn_ep", moe_fn)
        loss, grads = value_and_grad(api.make_loss_fn(
            cfg, compute_dtype=torch.float32), model,
            {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), {n: g.numpy() for n, g in grads.items()}


def _case(arch, seed):
    """The reference's parameters (converted to the port's model) and a
    batch; a moe's capacity factor is the no-drop one."""
    rcfg, cfg = ref_smoke_config(REF_ARCHS[arch]), smoke_config(ARCHS[arch])
    params = ref_api.init_params(rcfg, jax.random.PRNGKey(seed))
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    return dict(rcfg=rcfg, cfg=cfg, ref_params=params, model=model,
                whole={n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()},
                batch=_batch(cfg, np.random.default_rng(seed)),
                cf=NO_DROP if cfg.family == "moe" else DEFAULT_CF)


def _grads(case):
    """The reference's f32 loss and gradients (a moe at the no-drop
    capacity) and the port's 1x1 ones (and a moe's at the default
    capacity, grouped as each grid groups), added to ``case``."""
    cfg, batch, cf = case["cfg"], case["batch"], case["cf"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_moe, "moe_ffn_ep", functools.partial(
            ref_moe.moe_ffn_ep, capacity_factor=cf))
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(functools.partial(
            ref_api.make_loss_fn(case["rcfg"]), compute_dtype=jnp.float32)))(
            case["ref_params"], {k: jnp.asarray(v) for k, v in batch.items()})
    case["loss"], case["grads"] = _port_grads(
        cfg, case["model"], batch, functools.partial(moe.moe_ffn_ep,
                                                     capacity_factor=cf))
    case["ref_loss"] = float(ref_loss)
    case["ref_grads"] = {n: np.asarray(_at(ref_grads, path))[index]
                         for n in case["whole"]
                         for path, index in [reference_leaf(n, cfg.family)]}
    if cfg.family == "moe":
        case["grouped"] = {
            grid: _port_grads(cfg, case["model"], batch, functools.partial(
                moe.moe_ffn_ep_plain, dp=rows, model=cols,
                capacity_factor=DEFAULT_CF))
            for grid, (rows, cols) in GRIDS.items()}


def _exchange_case(path):
    """The smoke olmoe's router and experts, an input (4, 16, d) and a
    cotangent, written to ``path``; the plain body's gradients."""
    cfg = smoke_config(ARCHS["olmoe-1b-7b"])
    rng = np.random.default_rng(11)
    arrays = {n: (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
        np.float32) for n, shape in moe.moe_shapes(cfg).items()}
    arrays["x"] = rng.standard_normal((4, 16, cfg.d_model)).astype(
        np.float32)
    arrays["u"] = rng.standard_normal((4, 16, cfg.d_model)).astype(
        np.float32)
    np.savez(path, **arrays)
    leaves = {n: torch.from_numpy(arrays[n]).requires_grad_()
              for n in ("router", "w_gate", "w_up", "w_down", "x")}
    x = leaves.pop("x")
    y = moe.moe_ffn_ep_plain(leaves, x, cfg, dp=2, model=2)
    grads = torch.autograd.grad((y * torch.from_numpy(arrays["u"])).sum(),
                                [x, *leaves.values()])
    return {n: g.numpy() for n, g in zip(["x", *leaves], grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One world of four ranks, started once: every case's step on both
    grids (the moe at the no-drop and the default capacity), every
    family's init, the exchange's gradients; the reference's and the 1x1
    gradients are taken while the ranks run."""
    cases = {arch: _case(arch, 20 + i) for i, arch in enumerate(ARCHS_HERE)}
    tmp = tmp_path_factory.mktemp("sharded-families")
    steps = [((arch, c["cf"]), arch, c["whole"], c["batch"], c["cf"])
             for arch, c in cases.items()]
    olmoe = cases["olmoe-1b-7b"]
    steps.append((("olmoe-1b-7b", DEFAULT_CF), "olmoe-1b-7b", olmoe["whole"],
                  olmoe["batch"], DEFAULT_CF))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(steps, f)
    plain = _exchange_case(tmp / "exchange.npz")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(
            spawn_mesh, ranks.family_runs, 2, 2, backend="gloo",
            device="cpu", init_file=str(tmp / "store"),
            args=(list(GRIDS.values()), str(tmp / "cases.pkl"), ARCHS_HERE,
                  str(tmp / "exchange.npz")), timeout=300.0, threads=1)
        for case in cases.values():
            _grads(case)
        out = world.result()
    return cases, out, plain


#: the blocks that run split over "model" on 2x2: (attention, MLP,
#: vocabulary), (recurrent heads, experts)
SPLIT_2X2 = {"olmoe-1b-7b": ((True, False, True), (False, True)),
             "zamba2-7b": ((True, True, True), (True, False)),
             "xlstm-125m": ((False, False, True), (True, False)),
             "seamless-m4t-large-v2": ((True, True, True), (False, False))}


def _close(got, loss, grads, ref_loss=None, ref_grads=None):
    np.testing.assert_allclose(got["loss"], loss, **LOSS_TOL)
    assert got["grads"].keys() == grads.keys()
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, grads[name], err_msg=name, **GRAD_TOL)
    if ref_loss is not None:
        np.testing.assert_allclose(got["loss"], ref_loss, **LOSS_TOL)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, ref_grads[name], err_msg=name,
                                       **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS_HERE)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_family_step_matches_1x1_and_reference(runs, grid, arch):
    cases, out, _ = runs
    case = cases[arch]
    recs = [o["steps"][(GRIDS[grid], (arch, case["cf"]))] for o in out]
    assert len({r["loss"] for r in recs}) == 1
    _close(recs[0], case["loss"], case["grads"], case["ref_loss"],
           case["ref_grads"])
    split = SPLIT_2X2[arch] if grid == "2x2" else ((False,) * 3,
                                                    (False,) * 2)
    assert (recs[0]["plan"], recs[0]["split"]) == split
    counts = recs[0]["counts"]
    assert counts["all_reduce"] > 0
    # the expert exchange: two a layer forward, again in the remat
    # recompute, and two backward
    exchanges = 6 * 2 if split[1][1] else 0
    assert counts.get("all_to_all", 0) == exchanges


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_moe_default_capacity_matches_grouped_1x1(runs, grid):
    """At 1.25 tokens may drop: the grid's groups are the 1x1 step's when
    its MoE groups as the grid does."""
    cases, out, _ = runs
    case = cases["olmoe-1b-7b"]
    recs = [o["steps"][(GRIDS[grid], ("olmoe-1b-7b", DEFAULT_CF))]
            for o in out]
    assert len({r["loss"] for r in recs}) == 1
    loss, grads = case["grouped"][grid]
    _close(recs[0], loss, grads)


def _ref_mesh(sizes):
    return types.SimpleNamespace(shape=dict(sizes))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_family_ranks_hold_the_reference_shard_bytes(runs, grid):
    cases, out, _ = runs
    rows, cols = GRIDS[grid]
    sizes = {"data": rows, "model": cols}
    for arch in ARCHS_HERE:
        rcfg = ref_smoke_config(REF_ARCHS[arch])
        params = cases[arch]["ref_params"]
        specs = ref_api.param_pspecs(rcfg, params, sharding.RULES,
                                     mesh=_ref_mesh(sizes))
        per_device = 0
        for leaf, spec in zip(jax.tree.leaves(params), jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, P))):
            parts = 1
            for ax in spec:
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    parts *= sizes.get(a, 1) if a else 1
            per_device += leaf.size * leaf.dtype.itemsize // parts
        key = (GRIDS[grid], (arch, cases[arch]["cf"]))
        assert [o["steps"][key]["bytes"] for o in out] == \
            [3 * per_device] * rows * cols, arch


@pytest.mark.parametrize("arch", ARCHS_HERE)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_family_leaf_by_leaf_init_is_bitwise_the_whole_draw_cut(runs, grid,
                                                                arch):
    _, out, _ = runs
    recs = [o["inits"][(GRIDS[grid], arch)] for o in out]
    for rank, rec in enumerate(recs):
        assert rec["differ"] == [] and rec["names"], (rank, rec["differ"])
    assert [r["state"] for r in recs] == ["kept"] + [None] * (len(recs) - 1)
    assert recs[0]["whole_differ"] == [] and recs[0]["mu_shapes_ok"]


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_init_params_is_bitwise_its_init_leaves(arch):
    cfg = smoke_config(ARCHS[arch])
    model = api.init_params(cfg, 7, device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(7)
    leaves = list(api.init_leaves(cfg, gen))
    named = dict(model.named_parameters())
    assert [n for n, _ in leaves] != [] and {n for n, _ in leaves} == \
        named.keys() and len(leaves) == len(named)
    for name, value in leaves:
        assert torch.equal(named[name], value), name
    meta = dict(api.init_leaves(cfg, None))
    assert all(t.device.type == "meta" and t.shape == named[n].shape
               for n, t in meta.items())


def test_exchange_gradient_matches_the_plain_body(runs):
    _, out, plain = runs
    for o in out:
        assert o["exchange"]["counts"]["all_to_all"] == 4
    got = out[0]["exchange"]["grads"]
    assert got.keys() == plain.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g, plain[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for o in out[1:]:
        for name, g in o["exchange"]["grads"].items():
            np.testing.assert_array_equal(g, got[name])
    for o in out:
        weights = o["exchange"]["weights_only"]
        assert weights.keys() == plain.keys() - {"x"}
        for name, g in weights.items():
            np.testing.assert_array_equal(g, got[name], err_msg=name)


# ---------------------------------------------------------------------------
# a restore, one leaf at a time
# ---------------------------------------------------------------------------

class _OneAtATime:
    """``np.load`` of an npz file that records the keys asked for and
    checks that no array it returned is alive when the next is read."""

    def __init__(self, load, keys):
        self._load, self._keys, self._alive = load, keys, []

    def __call__(self, path, *a, **k):
        self._data = self._load(path, *a, **k)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._data.close()

    def __getitem__(self, key):
        assert all(ref() is None for ref in self._alive), key
        a = self._data[key]
        self._keys.append(key)
        self._alive.append(weakref.ref(a))
        return a


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_restore_reads_one_leaf_at_a_time(arch, tmp_path, monkeypatch):
    """A 1x1 run's checkpoint (and the same state gathered as a grid's:
    dicts under the family's names) restored into each rank of a 2x2 grid
    (its blocks cut locally; no collective): bitwise the whole leaves cut,
    each key read once."""
    cfg = smoke_config(ARCHS[arch])
    model = api.init_params(cfg, 3, device="cpu")
    opt = AdamW()
    state = opt.init(model)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for t in (*state.mu.values(), *state.nu.values()):
            t.copy_(torch.rand(t.shape, generator=g))
        state.step.fill_(5)
    store.save_checkpoint(str(tmp_path / "a"), 5, (model, state))
    named = {n: p.detach() for n, p in model.named_parameters()}
    gathered = store.AsyncCheckpointer(str(tmp_path / "b"))
    gathered.save(5, (named, state), family=cfg.family)
    gathered.wait()
    whole, _ = load_checkpoint_arrays(str(tmp_path / "a"), 5)
    gathered, _ = load_checkpoint_arrays(str(tmp_path / "b"), 5)
    assert whole.keys() == gathered.keys()
    assert all(np.array_equal(whole[k], gathered[k]) for k in whole)
    for rank in range(4):
        mesh = NMFMesh(2, 2, rank, torch.device("cpu"))
        mine = api.init_params(cfg, 9, device="cpu")
        shards = sharding.shard_model(mine, mesh)
        mine_state = opt.init(mine)
        keys = []
        monkeypatch.setattr(store.np, "load", _OneAtATime(np.load, keys))
        sharding.restore_state(str(tmp_path / "a"), 5, mine, mine_state,
                               shards)
        monkeypatch.undo()
        assert sorted(keys) == sorted(f"a{i}" for i in range(len(whole)))
        assert int(mine_state.step) == 5
        for prefix, blocks in (("0/", dict(mine.named_parameters())),
                               ("1/.mu/", mine_state.mu),
                               ("1/.nu/", mine_state.nu)):
            for n, t in blocks.items():
                path, index = reference_leaf(n, cfg.family)
                want = whole[prefix + "/".join(path)][index][
                    sharding.block_index(mesh, shards.dims(n))]
                assert torch.equal(t.detach(), torch.from_numpy(
                    np.ascontiguousarray(want))), (rank, n)


# ---------------------------------------------------------------------------
# the launcher on four gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmoe_launcher(tmp_path_factory):
    """olmoe's smoke config: a 2x2 run stopped at 6 beside an
    uninterrupted 2x2 run to 9; then the stopped one resumed to 9 on 2x2
    and copies of its step-6 checkpoint on 4x1 and on 1x1."""
    root = tmp_path_factory.mktemp("olmoe-launcher")
    dirs = {k: root / k for k in ("a", "b", "4x1", "1x1")}

    def launch(key, steps, grid=(2, 2)):
        return ranks.launch_train(SRC, "olmoe-1b-7b", dirs[key], steps, grid)

    first, whole = launch("a", 6), launch("b", 9)
    outs = {"first": ranks.train_done(first),
            "whole": ranks.train_done(whole)}
    for k in ("4x1", "1x1"):
        dirs[k].mkdir()
        shutil.copytree(dirs["a"] / "step_6", dirs[k] / "step_6")
    procs = {"a": launch("a", 9), "4x1": launch("4x1", 9, (4, 1)),
             "1x1": launch("1x1", 9, (1, 1))}
    outs.update({k: ranks.train_done(p) for k, p in procs.items()})
    states = {k: load_checkpoint_arrays(str(d), 9)[0]
              for k, d in dirs.items()}
    return outs, states, dirs


def test_olmoe_launcher_resumes_bitwise_on_2x2(olmoe_launcher):
    outs, states, dirs = olmoe_launcher
    assert "resuming" not in outs["first"] and latest_step(
        str(dirs["b"])) == 9
    assert "resuming from checkpoint step 6" in outs["a"]
    assert "step     8  loss" in outs["a"] and outs["a"].endswith("done\n")
    want = states["b"]
    assert states["a"].keys() == want.keys() and "1/.step" in want
    assert "0/layers/moe/w_gate" in want
    for name in want:
        np.testing.assert_array_equal(states["a"][name], want[name],
                                      err_msg=name)


def test_olmoe_launcher_resumes_on_4x1(olmoe_launcher):
    outs, states, _ = olmoe_launcher
    assert "resuming from checkpoint step 6" in outs["4x1"]
    assert "resuming from checkpoint step 6" in outs["1x1"]
    want = states["1x1"]
    assert states["4x1"].keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(states["4x1"][name], want[name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
