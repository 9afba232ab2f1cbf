"""The sharded serving steps (``serving/sharding.py``) on gloo ranks on the
CPU, held against the port's unsharded steps and the reference's
``api.make_prefill_step`` / ``api.make_decode_step``, for every family.

* Parity: the smoke configs in f32 on 2x2 and 4x1 (and dense on 2x2x2),
  the parameters the reference's (``convert.model_from_reference``), the
  prefill batch, the decode state and the token column made with numpy
  from a seed and handed to both packages (the state through
  ``convert.cache_from_reference``).  The prefill's logits (encdec: the
  memory) of each rank's batch block against the port's 1x1 step and the
  reference's at the f32 bar 1e-4; the decode step's logits against the
  reference's at a position in the last ``"model"`` block (13 of 16 rows)
  and one in the first (3), each from the seeded state; and each rank's
  blocks of the updated state against the same blocks, cut by the
  reference's ``cache_pspecs``, of the reference's updated state.  moe at
  the capacity factor where no token drops (4.0 = E / k), on both sides.
* Storage: a rank's state bytes are the reference's per-device bytes under
  its ``cache_pspecs`` exactly; the xLSTM states the reference's catch-all
  rule splits by heads over ``"data"`` are stored so; the zero state of
  ``init_sharded_cache`` is ``api.init_decode_cache``'s cut.
* The train step keeps the plain attention path: its loss and gradients
  are bitwise the same with the flash wrapper made to raise.
"""
import concurrent.futures
import functools
import math
import pickle
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import ShapeSpec as RefShapeSpec
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import moe as ref_moe
from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.convert import model_from_reference
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch.mesh import make_nmf_mesh, spawn_mesh
from repro_torch.models import api, common, moe
from repro_torch.training import AdamW, sharding

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as ranks  # noqa: E402
from _torch_recurrent import F32_TOL  # noqa: E402

ARCHS_HERE = ("llama3.2-1b", "internvl2-76b", "olmoe-1b-7b", "zamba2-7b",
              "xlstm-125m", "seamless-m4t-large-v2")
#: (pods, data, model)
GRIDS = {"2x2": (1, 2, 2), "4x1": (1, 4, 1)}
POD_GRID, POD_ARCH = (2, 2, 2), "llama3.2-1b"
CASES = [(g, a) for g in sorted(GRIDS) for a in ARCHS_HERE] + [
    ("2x2x2", POD_ARCH)]
B, S = 4, 16
#: a position in the last "model" block of 16 rows on 2 ranks, and one in
#: the first
POSITIONS = {"last": 13, "first": 3}
#: E / k of the smoke olmoe: no expert can overflow
NO_DROP = 4.0


def _grid(name):
    return POD_GRID if name == "2x2x2" else GRIDS[name]


def _flat(tree, prefix=""):
    """Leaves by path ("k", "groups/ssm", "0/C"), dicts and lists only (a
    ``PartitionSpec`` is a leaf); None dropped."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


def _state(rcfg, shape, rng):
    """The reference's decode state of ``shape`` in f32, every leaf drawn
    standard normal (the xLSTM normalisers ``n`` at 1 + |N(0, 1)|)."""
    zero = ref_api.init_decode_cache(rcfg, shape, dtype=jnp.float32)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return np.abs(x) + 1 if path[-1].key == "n" else x

    return jax.tree_util.tree_map_with_path(draw, zero)


def _case(arch, seed):
    rcfg, cfg = ref_smoke_config(REF_ARCHS[arch]), smoke_config(ARCHS[arch])
    params = ref_api.init_params(rcfg, jax.random.PRNGKey(seed))
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        batch = {"frame_embeds": rng.standard_normal(
            (B, 2 * S, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S),
                                        dtype=np.int32)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    seq = 2 * S if cfg.family == "encdec" else S
    shape = RefShapeSpec("serving", seq, B, "decode")
    return dict(rcfg=rcfg, cfg=cfg, params=params, model=model, batch=batch,
                shape=shape, state=_state(rcfg, shape, rng),
                token=rng.integers(0, cfg.vocab, (B,), dtype=np.int32),
                whole={n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()},
                cf=NO_DROP if cfg.family == "moe" else 1.25)


def _references(case):
    """The reference's f32 prefill and decode steps (its MoE at the case's
    capacity) and the port's 1x1 f32 prefill, added to ``case``."""
    rcfg, cfg, cf = case["rcfg"], case["cfg"], case["cf"]
    mod = ref_api.module_for(rcfg)
    f32 = functools.partial
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_moe, "moe_ffn_ep", f32(ref_moe.moe_ffn_ep,
                                               capacity_factor=cf))
        name = "encode" if cfg.family == "encdec" else "forward"
        mp.setattr(mod, name, f32(getattr(mod, name),
                                  compute_dtype=jnp.float32))
        mp.setattr(mod, "decode_step", f32(mod.decode_step,
                                           compute_dtype=jnp.float32))
        batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
        case["ref_prefill"] = np.asarray(jax.jit(ref_api.make_prefill_step(
            rcfg))(case["params"], batch))
        step = jax.jit(ref_api.make_decode_step(rcfg))
        state = jax.tree.map(jnp.asarray, case["state"])
        case["ref_decode"] = {}
        for pos in POSITIONS.values():
            logits, new = step(case["params"], state,
                               jnp.asarray(case["token"]), jnp.int32(pos))
            case["ref_decode"][pos] = (np.asarray(logits),
                                       jax.tree.map(np.asarray, new))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "moe_ffn_ep", functools.partial(
            moe.moe_ffn_ep, capacity_factor=cf))
        case["prefill_1x1"] = api.make_prefill_step(cfg, torch.float32)(
            case["model"], {k: torch.from_numpy(v)
                            for k, v in case["batch"].items()}).numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A world of four ranks (every case on 2x2, then on 4x1) and one of
    eight (dense on 2x2x2), started together; the reference's and the 1x1
    steps are taken while the ranks run."""
    cases = {arch: _case(arch, 40 + i) for i, arch in enumerate(ARCHS_HERE)}
    tmp = tmp_path_factory.mktemp("serving-sharded")
    rows = [(arch, c["whole"], c["batch"], c["state"], c["token"],
             list(POSITIONS.values()), c["cf"]) for arch, c in cases.items()]
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(rows, f)
    with open(tmp / "pod.pkl", "wb") as f:
        pickle.dump([r for r in rows if r[0] == POD_ARCH], f)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        four = pool.submit(
            spawn_mesh, ranks.serving_runs, 2, 2, backend="gloo",
            device="cpu", init_file=str(tmp / "store4"),
            args=(list(GRIDS.values()), str(tmp / "cases.pkl")),
            timeout=300.0, threads=1)
        eight = pool.submit(
            spawn_mesh, ranks.serving_runs, 2, 2, pods=2, backend="gloo",
            device="cpu", init_file=str(tmp / "store8"),
            args=([POD_GRID], str(tmp / "pod.pkl")), timeout=300.0,
            threads=1)
        for case in cases.values():
            _references(case)
        recs = {}
        for rank_out in four.result() + eight.result():
            for key, rec in rank_out.items():
                recs.setdefault(key, []).append(rec)
    return cases, recs


def _sizes(grid):
    pods, rows, cols = grid
    sizes = {"data": rows, "model": cols}
    if pods > 1:
        sizes["pod"] = pods
    return sizes


def _coords(rank, grid):
    pods, rows, cols = grid
    return {"pod": rank // (rows * cols), "data": (rank // cols) % rows,
            "model": rank % cols}


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(arr, spec, sizes, coords):
    """The block of ``arr`` a rank at ``coords`` holds under ``spec`` (a
    reference ``PartitionSpec``)."""
    index = []
    for d in range(arr.ndim):
        axes = _axes(spec[d] if d < len(spec) else None)
        n, r = math.prod(sizes.get(a, 1) for a in axes), 0
        for a in axes:
            r = r * sizes.get(a, 1) + coords[a]
        m = arr.shape[d] // n
        index.append(slice(r * m, (r + 1) * m))
    return arr[tuple(index)]


def _ref_specs(case, grid):
    mesh = types.SimpleNamespace(shape=_sizes(grid))
    return _flat(ref_api.cache_pspecs(case["rcfg"], case["shape"], mesh,
                                      case["state"]))


def _rows(rank, grid, b=B):
    """The batch rows a rank of ``grid`` serves: its block over the batch
    axes (``batch_axes_for``)."""
    sizes, coords = _sizes(grid), _coords(rank, grid)
    axes = api.batch_axes_for(b, sizes, ("pod", "data"))
    n, r = math.prod(sizes[a] for a in axes), 0
    for a in axes:
        r = r * sizes[a] + coords[a]
    return slice(r * (b // n), (r + 1) * (b // n))


@pytest.mark.parametrize("grid,arch", CASES)
def test_prefill_matches_1x1_and_reference(runs, grid, arch):
    cases, recs = runs
    case = cases[arch]
    got = recs[(_grid(grid), arch)]
    assert len(got) == math.prod(_grid(grid))
    for rank, rec in enumerate(got):
        rows = _rows(rank, _grid(grid))
        np.testing.assert_allclose(rec["prefill"], case["prefill_1x1"][rows],
                                   err_msg=f"rank {rank}", **F32_TOL)
        np.testing.assert_allclose(rec["prefill"], case["ref_prefill"][rows],
                                   err_msg=f"rank {rank}", **F32_TOL)


@pytest.mark.parametrize("where", sorted(POSITIONS))
@pytest.mark.parametrize("grid,arch", CASES)
def test_decode_logits_match_reference(runs, grid, arch, where):
    cases, recs = runs
    pos = POSITIONS[where]
    want = cases[arch]["ref_decode"][pos][0]
    for rank, rec in enumerate(recs[(_grid(grid), arch)]):
        dec = rec["decode"][pos]
        assert dec["same"]
        np.testing.assert_allclose(dec["logits"],
                                   want[_rows(rank, _grid(grid))],
                                   err_msg=f"rank {rank}", **F32_TOL)
        counts = dec["counts"]
        assert counts["all_reduce"] > 0 or math.prod(_grid(grid)) == 1


@pytest.mark.parametrize("where", sorted(POSITIONS))
@pytest.mark.parametrize("grid,arch", CASES)
def test_decode_state_blocks_match_reference(runs, grid, arch, where):
    """Each rank's blocks of the updated state are the same blocks, cut by
    the reference's ``cache_pspecs``, of the reference's updated state
    (the row written at ``pos`` included)."""
    cases, recs = runs
    case = cases[arch]
    pos = POSITIONS[where]
    new = _flat(case["ref_decode"][pos][1])
    specs = _ref_specs(case, _grid(grid))
    for rank, rec in enumerate(recs[(_grid(grid), arch)]):
        blocks = rec["decode"][pos]["blocks"]
        assert blocks.keys() == new.keys()
        for path, arr in new.items():
            want = _block(arr, specs[path], _sizes(_grid(grid)),
                          _coords(rank, _grid(grid)))
            assert blocks[path].shape == want.shape, (rank, path)
            np.testing.assert_allclose(blocks[path], want,
                                       err_msg=f"rank {rank} {path}",
                                       **F32_TOL)


@pytest.mark.parametrize("grid,arch", CASES)
def test_state_bytes_are_the_reference_per_device_bytes(runs, grid, arch):
    cases, recs = runs
    case = cases[arch]
    sizes = _sizes(_grid(grid))
    specs = _ref_specs(case, _grid(grid))
    per_device = sum(
        arr.size * arr.dtype.itemsize
        // math.prod(sizes.get(a, 1) for ax in specs[p] for a in _axes(ax))
        for p, arr in _flat(case["state"]).items())
    for rec in recs[(_grid(grid), arch)]:
        assert {d["bytes"] for d in rec["decode"].values()} == {per_device}
        assert rec["zero_ok"]


def test_xlstm_states_are_stored_by_heads_over_data(runs):
    """The reference's catch-all rule puts the batch axes on the second-to-
    last dim: on 2x2 the (B, H, hd) states of xlstm-125m (H = 4) are split
    by heads over ``"data"`` and kept so; (B, H) ``m`` by batch."""
    cases, recs = runs
    case = cases["xlstm-125m"]
    specs = _ref_specs(case, GRIDS["2x2"])
    assert _axes(specs["0/n"][1]) == ("data",) and specs["0/n"][0] is None
    assert _axes(specs["0/m"][0]) == ("data",)
    h = case["cfg"].n_heads
    for rec in recs[(GRIDS["2x2"], "xlstm-125m")]:
        blocks = rec["decode"][POSITIONS["last"]]["blocks"]
        assert blocks["0/n"].shape[:2] == (B, h // 2)
        assert blocks["1/c"].shape[:2] == (B, h // 2)
        assert blocks["0/m"].shape == (B // 2, h)
        assert blocks["0/C"].shape[:2] == (B // 2, h // 2)


def test_split_plan_on_2x2(runs):
    """Which blocks run split over "model" on 2x2 (attention, vocabulary,
    recurrent heads): the smoke llama and internvl2 have one KV head, so
    their attention runs whole beside a cache split by rows."""
    _, recs = runs
    want = {"llama3.2-1b": (False, True, False),
            "internvl2-76b": (False, True, False),
            "olmoe-1b-7b": (True, True, False),
            "zamba2-7b": (True, True, True),
            "xlstm-125m": (False, True, True),
            "seamless-m4t-large-v2": (True, True, False)}
    for arch, plan in want.items():
        assert {r["plan"] for r in recs[(GRIDS["2x2"], arch)]} == {plan}


def _train_step_values(cfg, model, batch):
    mesh = make_nmf_mesh(1, 1, device="cpu")
    shards = sharding.shard_model(model, mesh)
    got = {}

    class Capture(AdamW):
        def update(self, grads, state, params):
            got.update(grads)
            return params, state

    opt = Capture()
    loss = sharding.make_train_step(cfg, opt, shards,
                                    compute_dtype=torch.float32)(
        model, opt.init(model), batch)[2]
    return loss, got


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-large-v2"])
def test_train_step_keeps_the_plain_attention_path(arch, monkeypatch):
    """``Step.flash`` is off in the train step: its loss and gradients are
    bitwise the same when the flash wrapper raises."""
    cfg = smoke_config(ARCHS[arch])
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16),
                                                     dtype=np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16),
                                                     dtype=np.int32))}
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, 32, cfg.d_model)).astype(np.float32))
    loss, grads = _train_step_values(
        cfg, api.init_params(cfg, 1, device="cpu"), batch)

    def refuse(*args, **kwargs):
        raise AssertionError("the train step entered the flash wrapper")

    monkeypatch.setattr(common, "flash_attention", refuse)
    monkeypatch.setattr(flash_mod, "flash_attention", refuse)
    loss2, grads2 = _train_step_values(
        cfg, api.init_params(cfg, 1, device="cpu"), batch)
    assert torch.equal(loss, loss2)
    assert grads.keys() == grads2.keys()
    assert all(torch.equal(grads[n], grads2[n]) for n in grads)
    assert sharding.Step.__dataclass_fields__["flash"].default is False


def test_sharded_cache_of_a_1x1_mesh_is_the_whole_state():
    cfg = smoke_config(ARCHS["zamba2-7b"])
    shape = ShapeSpec("serving", 16, 2, "decode")
    from repro_torch.serving import sharding as serving

    mesh = make_nmf_mesh(1, 1, device="cpu")
    drawn = serving.init_sharded_cache(cfg, shape, mesh, "cpu", seed=2,
                                       dtype=torch.float32)
    whole = serving.drawn_cache(cfg, shape, 2, "cpu", torch.float32)
    for a, b in zip(serving._leaves(drawn.blocks), serving._leaves(whole)):
        assert torch.equal(a, b)
    rows = serving.drawn_cache(cfg, shape, 2, "cpu", torch.float32,
                               rows=slice(1, 2))
    assert torch.equal(rows["groups"]["ssm"],
                       whole["groups"]["ssm"][:, :, 1:2])
    assert torch.equal(rows["k"], whole["k"][:, 1:2])
    assert serving.cache_bytes(drawn) == sum(
        t.numel() * t.element_size() for t in serving._leaves(whole))
