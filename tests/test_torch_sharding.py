"""Parameter sharding on the grid: the port's sharding specs
(``models/api.py``: ``param_pspecs``, ``batch_axes_for``,
``batch_pspecs``, ``cache_pspecs``; ``models/common.py``:
``logical_to_mesh``) held against the reference's, and the sharded train
step (``training/sharding.py``) and launcher on gloo ranks on the CPU.

* Specs: every architecture of the registry at its full size (the
  reference's on ``jax.eval_shape``, the port's on the ``meta`` device),
  for ``{data, model}`` of 2x2, 4x1, 1x4, 16x16 and ``{pod: 2, data: 16,
  model: 16}``, under the reference launcher's rules and with FSDP over
  ``("pod", "data")``: leaf for leaf equal, the stacked axes dropped; the
  reference reads ``mesh.shape`` only, so both take the same plain
  mapping (the port also an ``NMFMesh``).
* The sharded step at smoke size in f32 on 2x2, 4x1, 1x4 and a 4x1 whose
  batch of 2 is replicated: its loss and its gradients, gathered whole,
  against the port's 1x1 step and the reference's unsharded loss and
  gradient on the same (converted) parameters and batch, at the
  reference's bars (loss 1e-4 / 1e-5, gradients 1e-3 / 1e-5,
  ``tests/test_substrate.py:33,55``); each rank's parameter, mu and nu
  bytes equal to the reference's per-device shard bytes.
* The launcher's init on 2x2 and 4x1 gloo ranks: the model drawn leaf
  by leaf into the rank's blocks (``init_sharded``) is bitwise the
  whole model's draw cut by ``shard_model``, and ``gather_state`` keeps
  the whole leaves, bitwise the whole draw's, on rank 0's host only;
  counted on meta, the init holds the blocks and one whole leaf and a
  checkpoint at most 1.5 of the largest leaf beside the state.
* The launcher under ``torch.distributed.run`` on four gloo ranks:
  stopped at 6 on 2x2 and resumed to 9, bitwise the uninterrupted 2x2 run;
  its step-6 checkpoint resumed on 4x1 and on 1x1 within 1e-4 of it.
"""
import functools
import pickle
import shutil
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro_torch.checkpoint import latest_step, load_checkpoint_arrays
from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.convert import _model, model_from_reference
from repro_torch.launch.mesh import NMFMesh, spawn_mesh
from repro_torch.layout import reference_leaf
from repro_torch.models import api, common
from repro_torch.training.optimizer import value_and_grad
from repro_torch.training.sharding import RULES

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)

MESHES = {"2x2": {"data": 2, "model": 2}, "4x1": {"data": 4, "model": 1},
          "1x4": {"data": 1, "model": 4}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULE_SETS = {"launcher": RULES,
             "pod-fsdp": {"fsdp": ("pod", "data"), "tp": "model",
                          "ep": "model"}}


def _ref_mesh(sizes):
    """What the reference reads of a mesh: ``mesh.shape``."""
    return types.SimpleNamespace(shape=dict(sizes))


def _nmf_mesh(sizes):
    return NMFMesh(sizes["data"], sizes["model"], 0, torch.device("cpu"),
                   sizes.get("pod", 1))


def _entries(spec, ndim):
    """A spec as a tuple of ``ndim`` entries (a ``PartitionSpec`` may be
    shorter; missing entries are None), a one-axis tuple as its name (as
    ``PartitionSpec`` keeps it: the same placement)."""
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)
    return spec + (None,) * (ndim - len(spec))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    return jax.eval_shape(lambda: ref_api.init_params(
        REF_ARCHS[arch], jax.random.PRNGKey(0)))


def _at(tree, path):
    for key in path:
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


# ---------------------------------------------------------------------------
# the specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rules", sorted(RULE_SETS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_pspecs_match_reference(arch, mesh, rules):
    """Leaf for leaf the reference's spec with its stacked axes dropped,
    for a mapping and for an ``NMFMesh`` of the same sizes."""
    cfg, sizes = ARCHS[arch], MESHES[mesh]
    shapes = _ref_shapes(arch)
    ref = ref_api.param_pspecs(REF_ARCHS[arch], shapes, RULE_SETS[rules],
                               mesh=_ref_mesh(sizes))
    skeleton = _model(cfg, "meta")
    got = api.param_pspecs(cfg, skeleton, RULE_SETS[rules], mesh=sizes)
    assert got == api.param_pspecs(cfg, skeleton, RULE_SETS[rules],
                                   mesh=_nmf_mesh(sizes))
    # without a mesh nothing is guarded
    free = api.param_pspecs(cfg, dict(skeleton.named_parameters()),
                            RULE_SETS[rules])
    ref_free = ref_api.param_pspecs(REF_ARCHS[arch], shapes,
                                    RULE_SETS[rules])
    assert got.keys() == dict(skeleton.named_parameters()).keys()
    for name, p in skeleton.named_parameters():
        path, index = reference_leaf(name, cfg.family)
        leaf = _at(shapes, path)
        assert tuple(leaf.shape[len(index):]) == tuple(p.shape)
        for mine, theirs in ((got, ref), (free, ref_free)):
            want = _entries(_at(theirs, path), leaf.ndim)[len(index):]
            assert mine[name] == want, name


def _flat(tree, path=()):
    """(path, spec) of every spec of a port tree (dicts, lists, tuples)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, path + (str(i),))]
    return [(path, tree)]


def _ref_flat(tree, like):
    out = []
    for keys, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        path = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in keys)
        out.append((path, _entries(spec, _at(like, path).ndim)))
    return sorted(out)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_cache_pspecs_match_reference(arch, mesh):
    """``batch_pspecs`` for every shape of the registry (and with the
    sequence over ``"model"``), ``batch_axes_for``, and ``cache_pspecs``
    of every decode shape's full-size state (the port's on ``meta``)."""
    cfg, rcfg, sizes = ARCHS[arch], REF_ARCHS[arch], MESHES[mesh]
    rmesh = _ref_mesh(sizes)
    for sname, shape in SHAPES.items():
        rshape = REF_SHAPES[sname]
        assert api.batch_axes_for(shape.global_batch, sizes,
                                  ("pod", "data")) == \
            ref_api.batch_axes_for(rshape.global_batch, rmesh,
                                   ("pod", "data"))
        for seq in (None, "model"):
            got = api.batch_pspecs(cfg, shape, sizes, seq_axis=seq)
            want = ref_api.batch_pspecs(rcfg, rshape, rmesh, seq_axis=seq)
            specs = api.input_specs(cfg, shape)
            assert got.keys() == want.keys()
            for name, spec in got.items():
                assert _entries(spec, len(spec)) == _entries(want[name],
                                        len(specs[name].shape)), name
        if shape.kind != "decode":
            continue
        cache = api.init_decode_cache(cfg, shape, device="meta")
        ref_cache = ref_api.init_decode_cache(rcfg, rshape, as_specs=True)
        got = [(p, _entries(e, len(e))) for p, e in
               _flat(api.cache_pspecs(cfg, shape, sizes, cache))]
        want = _ref_flat(ref_api.cache_pspecs(rcfg, rshape, rmesh,
                                              ref_cache), ref_cache)
        assert sorted(got) == want, sname
        assert _flat(api.cache_pspecs(cfg, shape, sizes, cache)) == _flat(
            api.cache_pspecs(cfg, shape, _nmf_mesh(sizes), cache))


@pytest.mark.parametrize("batch,candidates", [
    (256, ("pod", "data")), (2, ("pod", "data")), (6, ("data", "model")),
    (1, ("data",)), (32, ("model", "pod", "data"))])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_axes_for_matches_reference(mesh, batch, candidates):
    sizes = MESHES[mesh]
    assert api.batch_axes_for(batch, sizes, candidates) == \
        ref_api.batch_axes_for(batch, _ref_mesh(sizes), candidates)


def test_logical_to_mesh_matches_reference():
    tree = {"w": ("fsdp", "tp"), "b": (None,), "moe": {
        "w_up": ("ep", "fsdp", "tp"), "r": ("tp", "other")},
        "layers": [("fsdp", None), ()]}
    for rules in RULE_SETS.values():
        got = [s for _, s in _flat(common.logical_to_mesh(tree, rules))]
        want = jax.tree.leaves(ref_common.logical_to_mesh(tree, rules),
                               is_leaf=lambda x: isinstance(x, P))
        assert got == [tuple(s) for s in want]


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

#: (arch, global batch, seq): tied embeddings with one KV head (attention
#: gathered whole over "model"), heads that split with qkv biases and an
#: untied unembedding, and the vlm's patches
STEP_ARCHS = ("llama3.2-1b", "codeqwen1.5-7b", "internvl2-76b")
GRIDS = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}


def _case(arch, b, seed):
    """The reference's parameters and f32 loss and gradients on a numpy
    batch, the port's 1x1 ones on the converted parameters, and the case
    for the ranks."""
    rcfg, cfg = ref_smoke_config(REF_ARCHS[arch]), smoke_config(ARCHS[arch])
    params = ref_api.init_params(rcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    model = model_from_reference(tree, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, 16), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, 16), dtype=np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    ref_loss, ref_grads = jax.value_and_grad(functools.partial(
        ref_tf.lm_loss, cfg=rcfg, compute_dtype=jnp.float32))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(api.make_loss_fn(
        cfg, compute_dtype=torch.float32), model,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    whole = {n: p.detach().numpy() for n, p in model.named_parameters()}
    ref_g = {n: np.asarray(_at(ref_grads, path))[index]
             for n in whole
             for path, index in [reference_leaf(n, cfg.family)]}
    return dict(ref_loss=float(ref_loss), ref_grads=ref_g, ref_params=params,
                loss=float(loss), grads={n: g.numpy()
                                         for n, g in grads.items()},
                whole=whole, batch=batch)


#: the cases: each architecture at a batch of 4 (split over "data"), and
#: llama at a batch of 2, which a 4x1 grid replicates (2 is not a multiple
#: of 4)
CASES = [(arch, 4) for arch in STEP_ARCHS] + [("llama3.2-1b", 2)]


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """One world of four ranks, started once, runs every case on every
    grid."""
    cases = {(arch, b): _case(arch, b, STEP_ARCHS.index(arch))
             for arch, b in CASES}
    tmp = tmp_path_factory.mktemp("sharded-steps")
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump([(key, key[0], c["whole"], c["batch"])
                     for key, c in cases.items()], f)
    out = spawn_mesh(ranks.sharded_steps, 2, 2, backend="gloo",
                     device="cpu", init_file=str(tmp / "store"),
                     args=(list(GRIDS.values()), str(tmp / "cases.pkl")),
                     timeout=180.0, threads=1)
    return cases, out


@pytest.mark.parametrize("arch,batch", CASES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sharded_step_matches_1x1_and_reference(step_runs, grid, arch,
                                                batch):
    cases, out = step_runs
    case = cases[(arch, batch)]
    recs = [o[(GRIDS[grid], (arch, batch))] for o in out]
    for rec in recs:
        assert rec["loss"] == recs[0]["loss"]
    np.testing.assert_allclose(recs[0]["loss"], case["loss"], **LOSS_TOL)
    np.testing.assert_allclose(recs[0]["loss"], case["ref_loss"], **LOSS_TOL)
    grads = recs[0]["grads"]
    assert grads.keys() == case["grads"].keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, case["grads"][name], err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(g, case["ref_grads"][name], err_msg=name,
                                   **GRAD_TOL)
    cols = GRIDS[grid][1]
    # tensor parallelism where "model" splits the blocks: the smoke llama
    # and internvl2 have one KV head, so their attention runs whole
    assert recs[0]["plan"] == ((cols > 1 and arch == "codeqwen1.5-7b"),
                               cols > 1, cols > 1)
    assert recs[0]["counts"]["all_reduce"] > 0


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_each_rank_holds_the_reference_shard_bytes(step_runs, grid):
    """Parameters, mu and nu: the reference's per-device bytes under its
    ``param_pspecs`` on the same grid."""
    cases, out = step_runs
    rows, cols = GRIDS[grid]
    sizes = {"data": rows, "model": cols}
    for arch in STEP_ARCHS:
        rcfg = ref_smoke_config(REF_ARCHS[arch])
        params = cases[(arch, 4)]["ref_params"]
        specs = ref_api.param_pspecs(rcfg, params, RULES,
                                     mesh=_ref_mesh(sizes))
        per_device = 0
        for leaf, spec in zip(jax.tree.leaves(params), jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, P))):
            parts = 1
            for ax in spec:
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    parts *= sizes.get(a, 1) if a else 1
            per_device += leaf.size * leaf.dtype.itemsize // parts
        assert [o[(GRIDS[grid], (arch, 4))]["bytes"] for o in out] == \
            [3 * per_device] * rows * cols, arch


# ---------------------------------------------------------------------------
# the launcher's init: leaf by leaf into the blocks
# ---------------------------------------------------------------------------

INIT_GRIDS = {"2x2": (2, 2), "4x1": (4, 1)}


@pytest.fixture(scope="module")
def init_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded-init")
    return spawn_mesh(ranks.sharded_inits, 2, 2, backend="gloo",
                      device="cpu", init_file=str(tmp / "store"),
                      args=(list(INIT_GRIDS.values()), STEP_ARCHS),
                      timeout=180.0, threads=1)


@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("grid", sorted(INIT_GRIDS))
def test_leaf_by_leaf_init_is_bitwise_the_whole_draw_cut(init_runs, grid,
                                                         arch):
    recs = [o[(INIT_GRIDS[grid], arch)] for o in init_runs]
    for rank, rec in enumerate(recs):
        assert rec["differ"] == [], (rank, rec["differ"])
        assert rec["names"], rank
    # the checkpoint's whole leaves: rank 0's host holds them, no other
    # rank keeps anything
    assert [r["state"] for r in recs] == ["kept"] + [None] * (len(recs) - 1)
    assert recs[0]["whole_differ"] == [] and recs[0]["mu_shapes_ok"]
    assert recs[0]["devices"] == ["cpu"]


@pytest.mark.parametrize("grid", sorted(INIT_GRIDS))
def test_checkpoint_gathers_one_leaf_at_a_time(grid):
    """Counted on meta as rank 1 of a fake grid (no host copy): beside the
    rank's state, a checkpoint holds at most the leaf being gathered and,
    while its second axis is gathered, its part gathered over the first;
    the launcher's init holds the rank's blocks and one whole leaf."""
    import math

    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.cost_analysis import CostMode
    from repro_torch.training import AdamW, sharding

    rows, cols = INIT_GRIDS[grid]
    dist.init_process_group("fake", store=FakeStore(), rank=1,
                            world_size=rows * cols)
    world_id = id(dist.group.WORLD)
    try:
        mesh = mesh_mod.make_nmf_mesh(rows, cols, device="meta")
        for arch in STEP_ARCHS:
            cfg = smoke_config(ARCHS[arch])
            whole = _model(cfg, "meta")
            leaf = max(4 * math.prod(p.shape) for p in whole.parameters())
            init = CostMode(scale_loops=False)
            with init:
                model, shards = sharding.init_sharded(cfg, mesh, 0, "meta",
                                                      model=whole)
            blocks = sum(4 * p.numel() for p in model.parameters())
            assert blocks < init.peak_bytes <= blocks + leaf, arch
            state = AdamW().init(model)
            mode = CostMode(scale_loops=False)
            with mode:
                held = mode.track(model, state)
                assert sharding.gather_state(model, state, shards) is None
            assert leaf <= mode.peak_bytes - held <= 1.5 * leaf, arch
    finally:
        dist.destroy_process_group()
        for key in [k for k in mesh_mod._MESHES if k[3] == world_id]:
            del mesh_mod._MESHES[key]


# ---------------------------------------------------------------------------
# the launcher on four gloo ranks
# ---------------------------------------------------------------------------

def _launch(ckpt, steps, grid=(2, 2)):
    return ranks.launch_train(SRC, "llama3.2-1b", ckpt, steps, grid)


_done = ranks.train_done


@pytest.fixture(scope="module")
def launcher_runs(tmp_path_factory):
    """A 2x2 run stopped at 6 beside an uninterrupted 2x2 run to 9; then
    the stopped one resumed to 9 on 2x2, and copies of its step-6
    checkpoint resumed on 4x1 and on 1x1."""
    root = tmp_path_factory.mktemp("sharded-launcher")
    dirs = {k: root / k for k in ("a", "b", "4x1", "1x1")}
    first, whole = _launch(dirs["a"], 6), _launch(dirs["b"], 9)
    outs = {"first": _done(first), "whole": _done(whole)}
    for k in ("4x1", "1x1"):
        dirs[k].mkdir()
        shutil.copytree(dirs["a"] / "step_6", dirs[k] / "step_6")
    procs = {"a": _launch(dirs["a"], 9), "4x1": _launch(dirs["4x1"], 9,
                                                        (4, 1)),
             "1x1": _launch(dirs["1x1"], 9, (1, 1))}
    outs.update({k: _done(p) for k, p in procs.items()})
    states = {k: load_checkpoint_arrays(str(d), 9)[0]
              for k, d in dirs.items()}
    return outs, states, dirs


def test_sharded_launcher_resumes_bitwise(launcher_runs):
    outs, states, dirs = launcher_runs
    assert "resuming" not in outs["first"] and latest_step(
        str(dirs["b"])) == 9
    assert "resuming from checkpoint step 6" in outs["a"]
    assert "step     8  loss" in outs["a"] and outs["a"].endswith("done\n")
    # only rank 0 prints
    assert outs["whole"].count("done") == 1
    want = states["b"]
    assert states["a"].keys() == want.keys() and "1/.step" in want
    for name in want:
        np.testing.assert_array_equal(states["a"][name], want[name],
                                      err_msg=name)


@pytest.mark.parametrize("shape", ["4x1", "1x1"])
def test_sharded_checkpoint_resumes_on_another_grid(launcher_runs, shape):
    """Whole leaves under a 1x1 run's names: a 2x2 checkpoint resumes on
    4x1 and on 1x1, within 1e-4 of the uninterrupted 2x2 run (f32 LM
    quantities; the sums run in another order: on the CPU the parameters
    differ by ~1e-6, mu by up to ~8e-5 where it is largest)."""
    outs, states, _ = launcher_runs
    assert "resuming from checkpoint step 6" in outs[shape]
    want = states["b"]
    assert states[shape].keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(states[shape][name], want[name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
