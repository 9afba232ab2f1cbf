"""Port parity for the mixture-of-experts family (``models/moe.py``):
routing, dispatch and combine, the model's forward, loss and gradients,
prefill and decode, the train step, the converter, the checkpoints and
the train launcher, each held against the reference
(``repro.models.moe``) on the same inputs.

Parameters cross as numpy through ``model_from_reference``; token ids and
activations are made with numpy; the reference runs on the CPU, in f32
where its bars are f32 ones.  Tolerances are the reference's: ``moe_ffn``
1e-5 in f32 with the same experts selected and kept; the dense-mixture
oracle rtol 2e-2 / atol 2e-3 (``tests/test_substrate.py:59-81``); the loss
1e-4 / 1e-5 and its gradients 1e-3 / 1e-5 (``tests/test_substrate.py:
33,55``); f32 LM quantities 1e-4.
"""
import dataclasses
import functools
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import moe as ref_moe
from repro.training import AdamW as RefAdamW
from repro.training.optimizer import AdamState as RefAdamState
from repro_torch.checkpoint import (
    latest_step, load_checkpoint_arrays, restore_checkpoint, save_checkpoint,
)
from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.convert import (
    adam_state_from_reference, model_from_reference,
)
from repro_torch.models import api, common, moe
from repro_torch.training import AdamW
from repro_torch.training.optimizer import value_and_grad

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MOE_ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")
FFN_TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_TOL = dict(rtol=2e-2, atol=2e-3)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _models(arch, seed=0):
    """(reference cfg, port cfg, reference params, port model on the
    CPU)."""
    cfg = ref_smoke_config(REF_ARCHS[arch])
    pcfg = smoke_config(ARCHS[arch])
    params = ref_api.init_params(cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return cfg, pcfg, params, model_from_reference(tree, pcfg,
                                                         device="cpu")


def _ref_leaf(tree, name):
    """The reference leaf (or its row) of port parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for key in parts[2:]:
            node = node[key]
        return np.asarray(node)[int(parts[1])]
    node = tree
    for key in parts:
        node = node[key]
    return np.asarray(node)


def _ffn_inputs(seed, g, t):
    cfg = ref_smoke_config(REF_ARCHS["olmoe-1b-7b"])
    p = jax.tree.map(np.array, ref_moe.init_moe_ffn(
        jax.random.PRNGKey(seed), cfg))
    x = np.random.default_rng(seed).standard_normal(
        (g, t, cfg.d_model)).astype(np.float32)
    return cfg, smoke_config(ARCHS["olmoe-1b-7b"]), p, x


def _ref_routing(p, x, cfg, capacity_factor):
    """The reference's routing (``src/repro/models/moe.py:57-70``): the
    experts each (token, k) pair selects, whether it is kept, the
    capacity."""
    g, tg, _ = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = max(int(math.ceil(tg * k / e * capacity_factor)), k)
    logits = jnp.einsum("gtd,de->gte", x, p["router"])
    _, sel = jax.lax.top_k(logits, k)
    e_flat = sel.reshape(g, tg * k)
    onehot = jax.nn.one_hot(e_flat, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    my_pos = jnp.take_along_axis(pos, e_flat[..., None], 2)[..., 0]
    return np.asarray(sel), np.asarray(my_pos < cap), cap


# ---------------------------------------------------------------------------
# moe_ffn: routing, dispatch, combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25])
def test_moe_ffn_matches_reference(capacity_factor):
    """Two groups of 32 tokens: the same experts selected and kept, the
    output within 1e-5; 8.0 drops nothing, 0.25 drops most pairs."""
    cfg, pcfg, p, x = _ffn_inputs(1, 2, 32)
    want = ref_moe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           cfg, capacity_factor)
    sel, keep, cap = _ref_routing(p, jnp.asarray(x), cfg, capacity_factor)
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    tx = torch.from_numpy(x)
    _, psel = moe.router_topk(tx, tp["router"], pcfg.moe_top_k)
    _, pkeep = moe.expert_slots(psel, pcfg.n_experts, cap)
    np.testing.assert_array_equal(psel.numpy(), sel)
    np.testing.assert_array_equal(pkeep.numpy(), keep)
    assert keep.all() == (capacity_factor == 8.0)
    if capacity_factor == 0.25:
        assert keep.mean() < 0.5
    got = moe.moe_ffn(tp, tx, pcfg, capacity_factor)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want, FFN_TOL)


def test_moe_dispatch_matches_dense_mixture():
    """At capacity 8.0 (no drops) the scatter dispatch equals every token
    run densely through its top-k experts (``tests/test_substrate.py:
    59-81``)."""
    _, pcfg, p, x = _ffn_inputs(4, 1, 32)
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    tx = torch.from_numpy(x)
    got = moe.moe_ffn(tp, tx, pcfg, capacity_factor=8.0)[0]
    gates, sel = torch.topk(tx[0] @ tp["router"], pcfg.moe_top_k)
    gates = torch.softmax(gates, -1)
    want = torch.zeros_like(tx[0])
    for t in range(32):
        for j in range(pcfg.moe_top_k):
            e = int(sel[t, j])
            h = torch.nn.functional.silu(tx[0, t] @ tp["w_gate"][e]) * (
                tx[0, t] @ tp["w_up"][e])
            want[t] += gates[t, j] * (h @ tp["w_down"][e])
    _close(got, want, ORACLE_TOL)


def test_moe_capacity_drops_tokens_gracefully():
    """Heavy drops (capacity 0.25) give finite output of the input's shape
    (``tests/test_substrate.py:84-92``)."""
    _, pcfg, p, x = _ffn_inputs(5, 1, 64)
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    out = moe.moe_ffn(tp, torch.from_numpy(x), pcfg, capacity_factor=0.25)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_pick_the_lower_expert(dtype):
    """Logits that tie exactly (experts 1, 3 and 6 share a router column,
    so do 0 and 5): the top k lists the lower expert first, as
    ``jax.lax.top_k`` does.  Each token is a one-hot row, so its logits
    are a row of the router, exact in either dtype and either package."""
    rng = np.random.default_rng(6)
    router = torch.from_numpy(rng.standard_normal((16, 8)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    router[:, 3] = router[:, 6] = router[:, 1]
    router[:, 5] = router[:, 0]
    x = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 40)]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tr = torch.from_numpy(router).to(getattr(torch, dtype))
    gates, sel = moe.router_topk(tx, tr, 4)
    logits = jnp.asarray(x, getattr(jnp, dtype)) @ jnp.asarray(
        router, getattr(jnp, dtype))
    want_vals, want = jax.lax.top_k(logits, 4)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want))
    vals = (tx @ tr).float().gather(-1, sel).numpy()
    np.testing.assert_array_equal(vals, np.asarray(want_vals, np.float32))
    # every row whose top 4 holds a tied pair lists its lower expert first
    sel = sel.numpy()
    for row in sel:
        for a, b in ((1, 3), (3, 6), (1, 6), (0, 5)):
            if a in row and b in row:
                assert list(row).index(a) < list(row).index(b)
    assert gates.dtype == tx.dtype
    assert any(1 in row and 3 in row for row in sel)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference(arch):
    """f32 logits within 1e-4 (both plain attention paths)."""
    cfg, pcfg, params, model = _models(arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 16),
                                             dtype=np.int32)
    want = ref_moe.forward(params, jnp.asarray(toks), cfg, remat=False,
                           compute_dtype=jnp.float32)
    with torch.no_grad():
        got = moe.forward(model, torch.from_numpy(toks), pcfg,
                          compute_dtype=torch.float32, flash=False)
        flash = model(torch.from_numpy(toks), compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, F32_TOL)
    _close(flash, want, F32_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_gradients_match_reference(arch, remat):
    cfg, pcfg, params, model = _models(arch)
    rng = np.random.default_rng(8)
    batch = {k: rng.integers(0, cfg.vocab, (2, 16), dtype=np.int32)
             for k in ("tokens", "labels")}
    ref_fn = jax.jit(jax.value_and_grad(functools.partial(
        ref_moe.lm_loss, cfg=cfg, remat=remat, compute_dtype=jnp.float32)))
    want, gwant = ref_fn(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    loss, grads = value_and_grad(functools.partial(
        moe.lm_loss, cfg=pcfg, remat=remat, compute_dtype=torch.float32),
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(loss, want, LOSS_TOL)
    gtree = jax.tree.map(np.asarray, gwant)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        _close(g, _ref_leaf(gtree, name), GRAD_TOL)
    assert float(grads["layers.0.moe.router"].abs().sum()) > 0


def test_decode_matches_reference():
    """Ten f32 decode steps (each step's B tokens one dispatch group): the
    logits of every step and the cache rows within 1e-4."""
    cfg, pcfg, params, model = _models("olmoe-1b-7b")
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (3, 10),
                                             dtype=np.int32)
    cache = ref_moe.init_cache(cfg, 3, 12, dtype=jnp.float32)
    pcache = moe.init_cache(pcfg, 3, 12, dtype=torch.float32)
    ref_step = jax.jit(lambda p, c, tok, pos: ref_moe.decode_step(
        p, c, tok, pos, cfg, compute_dtype=jnp.float32))
    for t in range(toks.shape[1]):
        want, cache = ref_step(params, cache, jnp.asarray(toks[:, t]),
                               jnp.int32(t))
        got, out_cache = moe.decode_step(model, pcache,
                                         torch.from_numpy(toks[:, t]), t,
                                         pcfg, compute_dtype=torch.float32)
        assert out_cache is pcache
        _close(got, want, F32_TOL)
    for name in ("k", "v"):
        _close(pcache[name], cache[name], F32_TOL)


def test_prefill_step_matches_reference(monkeypatch):
    """The prefill step of both packages, their forward at f32 compute:
    the next-token logits within 1e-4."""
    cfg, pcfg, params, model = _models("olmoe-1b-7b")
    monkeypatch.setattr(ref_moe, "forward", functools.partial(
        ref_moe.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(moe, "forward", functools.partial(
        moe.forward, compute_dtype=torch.float32))
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (2, 32),
                                              dtype=np.int32)
    want = ref_api.make_prefill_step(cfg)(params,
                                          {"tokens": jnp.asarray(toks)})
    got = api.make_prefill_step(pcfg)(model,
                                      {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, cfg.vocab) and got.dtype == torch.float32
    _close(got, want, F32_TOL)


def test_bf16_prefill_and_decode_are_finite():
    """The serving steps at their bf16 default on the smoke config
    (``tests/test_models_smoke.py:49-72``): finite logits of the right
    shape.  They are not held to each other: prefill dispatches all B * S
    tokens as one group at its capacity, decode each step's B tokens, so
    prefill can drop pairs that decode keeps (the reference's grouping)."""
    pcfg = smoke_config(ARCHS["olmoe-1b-7b"])
    model = api.init_params(pcfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, pcfg.vocab, (2, 8), dtype=np.int32))
    pre = api.make_prefill_step(pcfg)(model, {"tokens": toks})
    cache = api.init_decode_cache(pcfg, ShapeSpec("d", 8, 2, "decode"),
                                  device="cpu")
    dec = api.make_decode_step(pcfg)
    for t in range(8):
        logits, cache = dec(model, cache, toks[:, t], t)
    assert pre.shape == logits.shape == (2, pcfg.vocab)
    assert pre.dtype == logits.dtype == torch.float32
    assert bool(torch.isfinite(pre).all() and torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_runs(arch, microbatches):
    """One step at bf16 compute (``tests/test_models_smoke.py:21-46``):
    a finite scalar loss, and the parameters changed."""
    pcfg = smoke_config(ARCHS[arch])
    model = api.init_params(pcfg, 0, device="cpu")
    before = model.embed.detach().clone()
    batch = api.make_batch(pcfg, ShapeSpec("t", 32, 2, "train"), 0,
                           device="cpu")
    opt = AdamW(total_steps=4)
    model, state, loss = api.make_train_step(
        pcfg, opt, microbatches=microbatches)(model, opt.init(model), batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert not torch.allclose(model.embed, before)
    assert int(state.step) == 1


def _random_state(tree, rng, step):
    mu = jax.tree.map(lambda p: (1e-3 * rng.standard_normal(p.shape))
                      .astype(np.float32), tree)
    nu = jax.tree.map(lambda p: (1e-6 * rng.random(p.shape))
                      .astype(np.float32), tree)
    return RefAdamState(np.int32(step), mu, nu)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_reference(monkeypatch, arch):
    """One f32 step from one AdamW state: the loss within 1e-4, every
    parameter within 1e-4."""
    monkeypatch.setattr(ref_moe, "lm_loss", functools.partial(
        ref_moe.lm_loss, compute_dtype=jnp.float32))
    cfg, pcfg, params, model = _models(arch)
    rng = np.random.default_rng(12)
    batch = {k: rng.integers(0, cfg.vocab, (2, 16), dtype=np.int32)
             for k in ("tokens", "labels")}
    state = _random_state(jax.tree.map(np.asarray, params), rng, 3)
    ref, opt = RefAdamW(lr=1e-2, warmup=1), AdamW(lr=1e-2, warmup=1)
    p_ref, s_ref, l_ref = jax.jit(ref_api.make_train_step(cfg, ref))(
        params, jax.tree.map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in batch.items()})
    port_state = adam_state_from_reference(state, pcfg, device="cpu")
    model, port_state, loss = api.make_train_step(
        pcfg, opt, compute_dtype=torch.float32)(
            model, port_state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    _close(loss, l_ref, F32_TOL)
    want = jax.tree.map(np.asarray, p_ref)
    for name, p in model.named_parameters():
        _close(p, _ref_leaf(want, name), F32_TOL)
    assert int(port_state.step) == int(s_ref.step) == 4


# ---------------------------------------------------------------------------
# api, converter, checkpoints, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_module_for_returns_the_moe_module(arch):
    assert api.module_for(ARCHS[arch]) is moe
    assert ARCHS[arch].family == "moe"


@pytest.mark.parametrize("family,title", [
    ("hybrid", "the `hybrid` family"), ("ssm", "the `ssm` family"),
    ("encdec", "the `encdec` family")])
def test_unported_families_name_their_item_by_title(family, title):
    """The hybrid, ssm and encdec families are ported and return their
    modules (the titles name the ROADMAP items that ported them)."""
    cfg = next(c for c in REF_ARCHS.values() if c.family == family)
    assert title == f"the `{family}` family"
    assert api.module_for(common.ArchConfig(
        **dataclasses.asdict(cfg))) is api.FAMILY[family]
    assert api.FAMILY[family].__name__.rsplit(".", 1)[-1] == \
        {"hybrid": "hybrid", "ssm": "xlstm", "encdec": "encdec"}[family]


def test_converter_copies_the_stacked_experts():
    _, pcfg, params, model = _models("olmoe-1b-7b")
    tree = jax.tree.map(np.asarray, params)
    assert isinstance(model, moe.MoETransformer)
    for i, layer in enumerate(model.layers):
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                getattr(layer.moe, name).detach().numpy(),
                tree["layers"]["moe"][name][i])
    np.testing.assert_array_equal(model.unembed.detach().numpy(),
                                  tree["unembed"])


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "dtype",
                                  "dense tree"])
def test_converter_refuses_a_wrong_leaf(case):
    cfg = ref_smoke_config(REF_ARCHS["olmoe-1b-7b"])
    pcfg = smoke_config(ARCHS["olmoe-1b-7b"])
    tree = jax.tree.map(np.asarray, ref_api.init_params(
        cfg, jax.random.PRNGKey(0)))
    if case == "missing":
        del tree["layers"]["moe"]["w_up"]
    elif case == "extra":
        tree["layers"]["mlp"] = {"w_up": tree["layers"]["moe"]["w_up"]}
    elif case == "shape":
        tree["layers"]["moe"]["router"] = tree["layers"]["moe"]["router"][
            ..., :4]
    elif case == "dtype":
        tree["layers"]["moe"]["w_gate"] = tree["layers"]["moe"][
            "w_gate"].astype(np.int32)
    else:
        tree = jax.tree.map(np.asarray, ref_api.init_params(
            ref_smoke_config(REF_ARCHS["llama3.2-1b"]),
            jax.random.PRNGKey(0)))
    with pytest.raises(ValueError):
        model_from_reference(tree, pcfg, device="cpu")


def test_checkpoint_restores_the_moe_model_and_its_state(tmp_path):
    """The pytree checkpoint saves the model and its AdamW state in the
    reference's stacked layout and restores them bitwise."""
    pcfg = smoke_config(ARCHS["olmoe-1b-7b"])
    model = api.init_params(pcfg, 1, device="cpu")
    opt = AdamW()
    batch = api.make_batch(pcfg, ShapeSpec("t", 16, 2, "train"), 2,
                           device="cpu")
    model, state, _ = api.make_train_step(pcfg, opt)(model, opt.init(model),
                                                     batch)
    save_checkpoint(str(tmp_path), 1, (model, state))
    arrays, _ = load_checkpoint_arrays(str(tmp_path), 1)
    assert arrays["0/layers/moe/w_gate"].shape == (
        pcfg.n_layers, pcfg.n_experts, pcfg.d_model, pcfg.d_ff)
    fresh = api.init_params(pcfg, 9, device="cpu")
    fresh, fresh_state = restore_checkpoint(str(tmp_path), 1,
                                            (fresh, opt.init(fresh)))
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 fresh.named_parameters()):
        assert torch.equal(p, q), name
    for name in state.mu:
        assert torch.equal(state.mu[name], fresh_state.mu[name]), name
        assert torch.equal(state.nu[name], fresh_state.nu[name]), name
    assert int(fresh_state.step) == 1


def _train(*args, expect=0):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", "olmoe-1b-7b", "--smoke", "--device",
                          "cpu", "--batch", "2", "--seq", "16",
                          *map(str, args)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == expect, out.stderr[-2000:]
    return out


def test_train_launcher_kill_and_resume_is_bitwise_for_moe(tmp_path):
    """``--arch olmoe-1b-7b``: stopped at 2 steps and rerun to 4, it ends
    bitwise where an uninterrupted 4-step run ends (``--deterministic``)."""
    a, b = tmp_path / "a", tmp_path / "b"
    _train("--steps", 2, "--ckpt-dir", a, "--ckpt-every", 2,
           "--deterministic")
    assert latest_step(str(a)) == 2
    resumed = _train("--steps", 4, "--ckpt-dir", a, "--ckpt-every", 2,
                     "--deterministic")
    assert "resuming from checkpoint step 2" in resumed.stdout
    _train("--steps", 4, "--ckpt-dir", b, "--ckpt-every", 2,
           "--deterministic")
    got, _ = load_checkpoint_arrays(str(a), 4)
    want, _ = load_checkpoint_arrays(str(b), 4)
    assert got.keys() == want.keys() and "0/layers/moe/router" in got
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_serve_launcher_runs_olmoe_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--requests", "3",
          "--max-batch", "2", "--max-seq", "24", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out and "on the CPU" in out
