"""Port parity for the LM training half: the differentiable attention, the
chunked loss, ``lm_loss``, AdamW, the train step, the pytree checkpoints
and the train launcher, each held against the reference on the same inputs.

Parameters cross as numpy through ``model_from_reference`` (and the
optimizer state through ``adam_state_from_reference``); token ids,
activations and gradients are made with numpy; the reference runs under
``jax.jit`` on the CPU with its flash kernel off (its default, the path it
trains with).  Tolerances are the reference's: the chunked loss 1e-4 /
1e-5 and its gradients 1e-3 / 1e-5 (``tests/test_substrate.py:33,55``),
f32 LM quantities 1e-4, bf16 rtol 5e-2 / atol 1e-1
(``tests/test_kernels.py:71``).
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.training import AdamW as RefAdamW
from repro.training.optimizer import AdamState as RefAdamState
from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_step, load_checkpoint_arrays,
    restore_checkpoint, save_checkpoint,
)
from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.convert import (
    adam_state_from_reference, model_from_reference,
)
from repro_torch.launch import train as train_mod
from repro_torch.models import api, common, transformer
from repro_torch.training import AdamW
from repro_torch.training.optimizer import reference_ndim, value_and_grad

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=1e-1)


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


def _batch(cfg, b, s, seed):
    """A train batch as numpy, with its reference and port forms."""
    rng = np.random.default_rng(seed)
    text = s - (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, text), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, text), dtype=np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.fixture
def f32_loss(monkeypatch):
    """The reference's loss (and so its train step) at f32 compute; the
    port's step takes ``compute_dtype``."""
    monkeypatch.setattr(ref_tf, "lm_loss", functools.partial(
        ref_tf.lm_loss, compute_dtype=jnp.float32))


# ---------------------------------------------------------------------------
# chunked_lm_loss
# ---------------------------------------------------------------------------

def _naive_loss(h, w, labels):
    logp = torch.log_softmax(h @ w, -1)
    nll = -torch.gather(logp[:, :-1], -1, labels[:, 1:, None].long())[..., 0]
    return nll.mean()


@pytest.mark.parametrize("b,s,d,v,n_chunks", [
    (1, 8, 8, 11, 4), (2, 16, 16, 32, 4), (3, 24, 8, 13, 8),
    (2, 20, 16, 32, 8),     # n_chunks falls to 5
    (2, 7, 8, 11, 8),       # ... and to 7
])
def test_chunked_loss_and_grads_match_reference_and_naive(b, s, d, v,
                                                          n_chunks):
    rng = np.random.default_rng(b * 100 + s)
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    y = rng.integers(0, v, (b, s), dtype=np.int32)
    ref_fn = jax.jit(jax.value_and_grad(
        lambda h, w: ref_common.chunked_lm_loss(h, w, jnp.asarray(y),
                                                n_chunks, jnp.float32),
        argnums=(0, 1)))
    want, (gh_want, gw_want) = ref_fn(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = common.chunked_lm_loss(th, tw, torch.from_numpy(y), n_chunks,
                                 torch.float32)
    gh, gw = torch.autograd.grad(got, (th, tw))
    _close(got, want, LOSS_TOL)
    _close(gh, gh_want, GRAD_TOL)
    _close(gw, gw_want, GRAD_TOL)
    nh = torch.from_numpy(h).requires_grad_()
    nw = torch.from_numpy(w).requires_grad_()
    naive = _naive_loss(nh, nw, torch.from_numpy(y))
    _close(got, naive, LOSS_TOL)
    for g, n in zip((gh, gw), torch.autograd.grad(naive, (nh, nw))):
        _close(g, n, GRAD_TOL)


def test_chunked_loss_bf16_matches_reference():
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 32, 16)).astype(np.float32)
    w = rng.standard_normal((16, 64)).astype(np.float32)
    y = rng.integers(0, 64, (2, 32), dtype=np.int32)
    want = jax.jit(lambda h, w: ref_common.chunked_lm_loss(
        h, w, jnp.asarray(y)))(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w))
    got = common.chunked_lm_loss(torch.from_numpy(h).bfloat16(),
                                 torch.from_numpy(w), torch.from_numpy(y))
    assert got.dtype == torch.float32
    _close(got, want, BF16_TOL)


def test_chunked_loss_recomputes_each_chunk_in_backward(monkeypatch):
    """Each chunk's logits are made once forward and once more in backward
    (never all kept), and not at all twice without autograd."""
    calls = []
    orig = common._chunk_nll
    monkeypatch.setattr(common, "_chunk_nll",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    h = torch.randn((2, 16, 8), requires_grad=True)
    w = torch.randn((8, 13))
    y = torch.randint(0, 13, (2, 16))
    loss = common.chunked_lm_loss(h, w, y, 4, torch.float32)
    assert len(calls) == 4
    loss.backward()
    assert len(calls) == 8 and all(c == (2, 4, 8) for c in calls)
    with torch.no_grad():
        common.chunked_lm_loss(h, w, y, 4, torch.float32)
    assert len(calls) == 12


# ---------------------------------------------------------------------------
# the differentiable attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seq", [("llama3.2-1b", 64),
                                      ("llama3.2-1b", 2560),
                                      ("codeqwen1.5-7b", 2560)])
def test_plain_attention_matches_reference(arch, seq):
    """Whole (64) and q-chunked (2560 x 2560 > 2048^2: five query blocks)
    against the reference's XLA path at f32, with gradients."""
    cfg = ref_smoke_config(REF_ARCHS[arch])
    pcfg = smoke_config(ARCHS[arch])
    rng = np.random.default_rng(seq)
    p = {k: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
         for k, v in ref_common.init_attention(jax.random.PRNGKey(0),
                                               cfg).items()}
    x = rng.standard_normal((1, seq, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((1, seq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (1, seq))
    assert not ref_common.USE_FLASH_KERNEL

    def ref(x, p):
        return ref_common.attention(p, x, cfg, jnp.asarray(pos))

    want, vjp = jax.vjp(jax.jit(ref), jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in p.items()})
    gx_want, gp_want = vjp(jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    got = common.attention(tp, tx, pcfg, torch.from_numpy(pos.copy()),
                           flash=False)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))
    grads = torch.autograd.grad(got, [tx] + list(tp.values()),
                                torch.from_numpy(cot))
    _close(grads[0], gx_want, F32_TOL)
    for name, g in zip(tp, grads[1:]):
        _close(g, gp_want[name], F32_TOL)


def test_q_chunked_attention_recomputes_each_block(monkeypatch):
    """S = 2560 runs five 512-row blocks, each once more in backward; the
    result equals the unchunked path's."""
    cfg = smoke_config(ARCHS["llama3.2-1b"])
    calls = []
    orig = common._attend
    monkeypatch.setattr(common, "_attend", lambda q, k, v, c, causal, off:
                        calls.append(off) or orig(q, k, v, c, causal, off))
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2560, cfg.n_heads, cfg.hd), generator=gen,
                    requires_grad=True)
    k = torch.randn((1, 2560, cfg.n_kv_heads, cfg.hd), generator=gen,
                    requires_grad=True)
    out = common._plain_attention(q, k, k, cfg, True)
    assert calls == [0, 512, 1024, 1536, 2048]
    out.sum().backward()
    assert sorted(calls[5:]) == [0, 512, 1024, 1536, 2048]
    whole = orig(q, k, k, cfg, True, 0)
    _close(out, whole.detach(), dict(rtol=1e-5, atol=1e-6))


def test_flash_and_plain_attention_agree_and_flash_refuses_grads():
    cfg = smoke_config(ARCHS["llama3.2-1b"])
    model = api.init_params(cfg, 0, device="cpu")
    w = model.layers[0].weights(torch.float32)["attn"]
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.arange(40).expand(2, 40)
    with torch.no_grad():
        _close(common.attention(w, x, cfg, pos, flash=True),
               common.attention(w, x, cfg, pos, flash=False).numpy(),
               dict(rtol=2e-3, atol=2e-3))


# ---------------------------------------------------------------------------
# lm_loss and the gradients through the casts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-76b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_matches_reference(arch, dtype, remat):
    cfg, pcfg, params, model = _models(arch)
    jb, tb = _batch(cfg, 2, 24, seed=3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_fn = jax.jit(jax.value_and_grad(functools.partial(
        ref_tf.lm_loss, cfg=cfg, remat=remat, compute_dtype=jdt)))
    want, gwant = ref_fn(params, jb)
    loss, grads = value_and_grad(functools.partial(
        transformer.lm_loss, cfg=pcfg, remat=remat, compute_dtype=tdt),
        model, tb)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(loss, want, tol)
    gtree = jax.tree.map(np.asarray, gwant)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        _close(g, _ref_leaf(gtree, name),
               GRAD_TOL if dtype == "float32" else BF16_TOL)


def test_bf16_gradients_reach_the_f32_parameters_with_and_without_remat():
    """The layers run on bf16 copies made inside the checkpointed body
    (remat) or by ``compute_weights`` (no remat); either way every f32
    parameter gets a gradient, and the two are the same."""
    _, pcfg, _, model = _models("llama3.2-1b")
    _, tb = _batch(pcfg, 2, 16, seed=4)
    out = {}
    for remat in (True, False):
        loss, grads = value_and_grad(functools.partial(
            transformer.lm_loss, cfg=pcfg, remat=remat), model, tb)
        assert set(grads) == {n for n, _ in model.named_parameters()}
        for name, g in grads.items():
            assert g.dtype == torch.float32 and bool(g.abs().sum() > 0), name
        out[remat] = (loss, grads)
    assert torch.equal(out[True][0], out[False][0])
    for name in out[True][1]:
        _close(out[True][1][name], out[False][1][name].numpy(),
               dict(rtol=1e-6, atol=1e-7))
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-76b"])
def test_train_specs_and_batches_give_labels(arch):
    pcfg = smoke_config(ARCHS[arch])
    shape = ShapeSpec("t", 32, 2, "train")
    specs = api.input_specs(pcfg, shape)
    batch = api.make_batch(pcfg, shape, seed=1, device="cpu")
    assert "labels" in specs and batch["labels"].shape == \
        batch["tokens"].shape == specs["labels"].shape
    loss = api.make_loss_fn(pcfg)(api.init_params(pcfg, 0, device="cpu"),
                                  batch)
    assert loss.shape == () and torch.isfinite(loss)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_schedule_matches_reference():
    ref, opt = RefAdamW(warmup=3, total_steps=10), AdamW(warmup=3,
                                                         total_steps=10)
    steps = np.array([0, 1, 2, 3, 4, 6, 9, 10, 11, 50], np.int32)
    want = jax.jit(ref.schedule)(jnp.asarray(steps))
    got = opt.schedule(torch.from_numpy(steps))
    _close(got, want, dict(rtol=1e-6, atol=1e-9))
    assert float(got[-1]) == pytest.approx(0.1 * opt.lr)


def _random_state(params, rng, step):
    mu = jax.tree.map(lambda p: (1e-2 * rng.standard_normal(p.shape))
                      .astype(np.float32), params)
    nu = jax.tree.map(lambda p: (1e-4 * rng.random(p.shape) + 1e-6)
                      .astype(np.float32), params)
    return RefAdamState(np.int32(step), mu, nu)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "codeqwen1.5-7b"])
def test_adamw_update_matches_reference(arch):
    cfg, pcfg, params, model = _models(arch)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, params)
    state = _random_state(tree, rng, 7)
    grads = jax.tree.map(lambda p: (1e-2 * rng.standard_normal(p.shape))
                         .astype(np.float32), tree)
    ref, opt = RefAdamW(lr=1e-2, warmup=2), AdamW(lr=1e-2, warmup=2)
    ref_state = jax.tree.map(jnp.asarray, state)
    p_ref = params
    port_state = adam_state_from_reference(state, pcfg, device="cpu")
    pgrads = {n: torch.from_numpy(_ref_leaf(grads, n).copy())
              for n, _ in model.named_parameters()}
    upd = jax.jit(ref.update)
    for _ in range(2):
        p_ref, ref_state = upd(grads, ref_state, p_ref)
        model, port_state = opt.update(pgrads, port_state, model)
    assert int(port_state.step) == int(ref_state.step) == 9
    want = jax.tree.map(np.asarray, p_ref)
    for tree_name, port in (("params", dict(model.named_parameters())),
                            ("mu", port_state.mu), ("nu", port_state.nu)):
        ref_tree = want if tree_name == "params" else \
            jax.tree.map(np.asarray, getattr(ref_state, tree_name))
        for name, t in port.items():
            _close(t, _ref_leaf(ref_tree, name), dict(rtol=1e-6, atol=1e-7))


def test_adamw_decays_the_reference_leaves_of_ndim_two():
    """With zero gradients and moments only the decay moves a parameter:
    the per-layer norms and biases (stacked (L, d) in the reference) move,
    ``norm_f`` (d,) does not, in both packages."""
    cfg, pcfg, params, _ = _models("codeqwen1.5-7b")   # qkv biases
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(2)
    for name in ("bq", "bk", "bv"):        # zero biases would not move
        leaf = tree["layers"]["attn"][name]
        tree["layers"]["attn"][name] = rng.standard_normal(
            leaf.shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    model = model_from_reference(tree, pcfg, device="cpu")
    zeros = jax.tree.map(np.zeros_like, tree)
    ref_p, _ = jax.jit(RefAdamW(lr=1e-2, warmup=1).update)(
        zeros, RefAdamState(jnp.int32(0), zeros, zeros), params)
    ref_p = jax.tree.map(np.asarray, ref_p)
    opt = AdamW(lr=1e-2, warmup=1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: torch.zeros_like(p) for n, p in before.items()}
    model, _ = opt.update(grads, opt.init(model), model)
    moved = set()
    for name, p in model.named_parameters():
        ref_moved = not np.array_equal(_ref_leaf(ref_p, name),
                                       _ref_leaf(tree, name))
        assert ref_moved == (not torch.equal(p, before[name])), name
        assert ref_moved == (reference_ndim(name, p) >= 2), name
        if ref_moved:
            moved.add(name.split(".")[-1])
    assert {"norm_attn", "norm_mlp", "bq", "wq", "embed"} <= moved
    assert "norm_f" not in moved


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-76b"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(f32_loss, arch, microbatches):
    cfg, pcfg, params, model = _models(arch)
    jb, tb = _batch(cfg, 4, 16 + (cfg.n_patches if cfg.family == "vlm"
                                  else 0), seed=microbatches)
    rng = np.random.default_rng(1)
    state = _random_state(jax.tree.map(np.asarray, params), rng, 3)
    ref, opt = RefAdamW(lr=1e-2, warmup=1), AdamW(lr=1e-2, warmup=1)
    step = jax.jit(ref_api.make_train_step(cfg, ref,
                                           microbatches=microbatches))
    p_ref, s_ref, l_ref = step(params, jax.tree.map(jnp.asarray, state), jb)
    port_state = adam_state_from_reference(state, pcfg, device="cpu")
    model, port_state, loss = api.make_train_step(
        pcfg, opt, microbatches=microbatches,
        compute_dtype=torch.float32)(model, port_state, tb)
    _close(loss, l_ref, F32_TOL)
    want = jax.tree.map(np.asarray, p_ref)
    for name, p in model.named_parameters():
        _close(p, _ref_leaf(want, name), F32_TOL)
    assert int(port_state.step) == int(s_ref.step) == 4


def test_microbatched_gradient_equals_the_whole_batch():
    """M = 2 accumulates the same gradient and loss as M = 1 (f32 compute;
    the loss is a mean over equal halves)."""
    _, pcfg, _, model = _models("llama3.2-1b")
    _, tb = _batch(pcfg, 4, 16, seed=9)
    got = {}

    class Capture(AdamW):
        def update(self, grads, state, params):
            got[len(got)] = {k: g.clone() for k, g in grads.items()}
            return params, state

    losses = [api.make_train_step(pcfg, Capture(), microbatches=m,
                                  compute_dtype=torch.float32)(
        model, None, tb)[2] for m in (1, 2)]
    _close(losses[1], losses[0].numpy(), dict(rtol=1e-5, atol=1e-6))
    for name in got[0]:
        _close(got[1][name], got[0][name].numpy(), dict(rtol=1e-4,
                                                        atol=1e-6))
    with pytest.raises(ValueError, match="microbatches"):
        api.make_train_step(pcfg, AdamW(), microbatches=3)(model, None, tb)


# ---------------------------------------------------------------------------
# pytree checkpoints across the packages
# ---------------------------------------------------------------------------

def _ref_state(cfg, seed):
    params = ref_api.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    state = _random_state(jax.tree.map(np.asarray, params), rng, 11)
    return params, jax.tree.map(jnp.asarray, state)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg, pcfg, params, model = _models("internvl2-76b")
    _, state = _ref_state(cfg, 2)
    pstate = adam_state_from_reference(jax.tree.map(np.asarray, state),
                                       pcfg, device="cpu")
    save_checkpoint(str(tmp_path), 5, (model, pstate))
    other, other_state = _ref_state(cfg, 3)
    got_p, got_s = ref_store.restore_checkpoint(str(tmp_path), 5,
                                                (other, other_state))
    for a, b in zip(jax.tree.leaves((got_p, got_s)),
                    jax.tree.leaves((params, state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    names, _, _ = ref_store._flatten_with_names((params, state))
    with open(tmp_path / "step_5" / "manifest.json") as f:
        assert json.load(f)["names"] == names


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    cfg, pcfg, params, _ = _models("llama3.2-1b", seed=4)
    _, state = _ref_state(cfg, 4)
    ref_store.save_checkpoint(str(tmp_path), 7, (params, state))
    model = api.init_params(pcfg, 9, device="cpu")
    pstate = AdamW().init(model)
    out = restore_checkpoint(str(tmp_path), 7, (model, pstate))
    assert out[0] is model and latest_step(str(tmp_path)) == 7
    tree = jax.tree.map(np.asarray, params)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _ref_leaf(tree, name))
    st = jax.tree.map(np.asarray, state)
    assert int(pstate.step) == 11
    for name, t in pstate.mu.items():
        np.testing.assert_array_equal(t.numpy(), _ref_leaf(st.mu, name))
    with pytest.raises(ValueError, match="does not match"):
        restore_checkpoint(str(tmp_path), 7, (model,))


def test_bf16_leaves_cross_as_uint16_bits(tmp_path):
    x = torch.randn((3, 5)).bfloat16()
    save_checkpoint(str(tmp_path / "p"), 1, ({"a": x}, {"b": x[0]}))
    ref_arrays, _ = ref_store.load_checkpoint_arrays(str(tmp_path / "p"), 1)
    np.testing.assert_array_equal(np.asarray(ref_arrays["0/a"], np.float32),
                                  x.float().numpy())
    ref_store.save_checkpoint(str(tmp_path / "r"), 2, {
        "a": jnp.asarray(x.float().numpy(), jnp.bfloat16)})
    y = torch.zeros((3, 5), dtype=torch.bfloat16)
    restore_checkpoint(str(tmp_path / "r"), 2, {"a": y})
    assert torch.equal(y, x)
    with pytest.raises(ValueError, match="float32"):
        restore_checkpoint(str(tmp_path / "r"), 2, {"a": y.float()})


def test_async_checkpointer_writes_what_it_was_given(tmp_path):
    """The copy happens on the caller: an in-place update made while the
    write is in flight does not reach the checkpoint."""
    _, pcfg, _, model = _models("llama3.2-1b")
    state = AdamW().init(model)
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, (model, state))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    ck.wait()
    assert ck.stats["saves"] == 1 and ck.stats["write_s"] > 0
    fresh = api.init_params(pcfg, 1, device="cpu")
    restore_checkpoint(str(tmp_path), 3, (fresh, AdamW().init(fresh)))
    for name, p in fresh.named_parameters():
        assert torch.equal(p, want[name]), name


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------

def _train(*args, expect=0):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", "llama3.2-1b", "--smoke", "--device",
                          "cpu", "--batch", "2", "--seq", "32",
                          *map(str, args)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == expect, out.stderr[-2000:]
    return out


def test_train_launcher_kill_and_resume_is_bitwise(tmp_path):
    """Stopped at 6 steps (checkpoints at 3 and 6), rerun to 9: it resumes
    from 6 and ends bitwise where an uninterrupted 9-step run ends
    (``--deterministic``)."""
    a, b = tmp_path / "a", tmp_path / "b"
    first = _train("--steps", 6, "--ckpt-dir", a, "--ckpt-every", 3,
                   "--deterministic")
    assert "resuming" not in first.stdout and "done" in first.stdout
    assert latest_step(str(a)) == 6
    resumed = _train("--steps", 9, "--ckpt-dir", a, "--ckpt-every", 3,
                     "--deterministic")
    assert "resuming from checkpoint step 6" in resumed.stdout
    assert "step     8  loss" in resumed.stdout and "done" in resumed.stdout
    whole = _train("--steps", 9, "--ckpt-dir", b, "--ckpt-every", 3,
                   "--deterministic")
    got, _ = load_checkpoint_arrays(str(a), 9)
    want, _ = load_checkpoint_arrays(str(b), 9)
    assert got.keys() == want.keys() and "1/.step" in got
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert whole.stdout.splitlines()[-1] == "done"


@pytest.mark.parametrize("data,model,world", [(2, 2, 1), (1, 1, 2),
                                               (4, 1, 2)])
def test_train_launcher_refuses_a_world_size_other_than_the_grid(
        monkeypatch, capsys, data, model, world):
    """A ``data x model`` grid needs that many ranks, no more and no
    fewer: refused before any process group or parameter is made."""
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(SystemExit) as exc:
        train_mod.main(["--arch", "llama3.2-1b", "--smoke", "--device",
                        "cpu", "--data", str(data), "--model", str(model)])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"needs {data * model} ranks, have {world}" in err
    assert f"--nproc-per-node {data * model}" in err


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-7b", "xlstm-125m",
                                  "seamless-m4t-large-v2"])
def test_train_launcher_refuses_unported_families_on_a_grid(
        monkeypatch, capsys, arch):
    """Every family's layers shard, so none is refused on a grid: each
    gets past the launcher's checks to the transport, refused here only
    because NCCL needs the card (``tests/test_torch_sharding_families.py``
    trains them on gloo ranks)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as exc:
        train_mod.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--model", "2"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--dist-backend nccl needs the card" in err
    assert "family" not in err and "ROADMAP" not in err


def test_synthetic_batch_is_a_function_of_the_step():
    pcfg = smoke_config(ARCHS["llama3.2-1b"])
    shape = ShapeSpec("cli", 16, 2, "train")
    a = train_mod.synthetic_batch(pcfg, shape, 3, "cpu")
    b = train_mod.synthetic_batch(pcfg, shape, 3, "cpu")
    c = train_mod.synthetic_batch(pcfg, shape, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (2, 16)
