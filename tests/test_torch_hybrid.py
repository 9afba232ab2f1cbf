"""Port parity for the hybrid family (``models/mamba.py``,
``models/hybrid.py``, zamba2-7b): the SSD pieces, the Mamba block and its
decode, the model's forward, loss, gradients, prefill and decode, the
AdamW step and its decay set, the converter, the checkpoint layout, the
serving engine and the launchers, each held against the reference
(``repro.models.mamba`` / ``repro.models.hybrid``) on the same inputs.

Parameters cross as numpy through ``model_from_reference``; token ids and
activations are made with numpy.  The smoke config has 5 Mamba layers
with ``attn_every`` 2: two groups and a tail of 1, so every branch runs.
Tolerances: f32 LM quantities 1e-4; the loss 1e-4 / 1e-5 and gradients
1e-3 / 1e-5 (``tests/test_substrate.py:33,55``); bf16 rtol 5e-2 / atol
1e-1 (``tests/test_kernels.py:71``); the port's decode against its own
forward 2e-2 (``tests/test_models_smoke.py:94-111``); the AdamW step
1e-6.
"""
import contextlib
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import hybrid as ref_hybrid
from repro.models import mamba as ref_mamba
from repro_torch.checkpoint import (
    load_checkpoint_arrays, restore_checkpoint, save_checkpoint,
)
from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.convert import model_from_reference
from repro_torch.kernels import _build
from repro_torch.models import api, hybrid, mamba
from repro_torch.training import AdamW
from repro_torch.training.optimizer import value_and_grad

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_recurrent import (  # noqa: E402
    BF16_TOL, F32_TOL, LOSS_TOL, adamw_step_matches_reference, check_grads,
    close, converter_round_trips, init_decode_cache_matches_reference,
    models, run_train_launcher, serving_engine_matches_reference, tokens,
)

ARCH = "zamba2-7b"
DECODE_TOL = dict(rtol=2e-2, atol=2e-2)


@contextlib.contextmanager
def reference_flash():
    ref_common.use_flash_kernel(True, interpret=True)
    try:
        yield
    finally:
        ref_common.use_flash_kernel(False)


def _cfgs():
    return ref_smoke_config(REF_ARCHS[ARCH]), smoke_config(ARCHS[ARCH])


def _block(seed=0):
    """A Mamba block's reference parameters (numpy) and the port's."""
    cfg, pcfg = _cfgs()
    p = jax.tree.map(np.asarray, ref_mamba.init_mamba_block(
        jax.random.PRNGKey(seed), cfg))
    # A_log, D and dt_bias off their zero / one initialisation, so that
    # every one of them matters
    rng = np.random.default_rng(seed)
    for name in ("A_log", "D", "dt_bias"):
        p[name] = (p[name] + 0.5 * rng.standard_normal(p[name].shape)
                   ).astype(np.float32)
    return cfg, pcfg, p, {k: torch.from_numpy(np.array(v))
                          for k, v in p.items()}


# ---------------------------------------------------------------------------
# SSD pieces and the Mamba block
# ---------------------------------------------------------------------------

def test_segsum_matches_reference():
    a = np.random.default_rng(0).standard_normal((2, 3, 8)).astype(
        np.float32)
    want = np.asarray(ref_mamba._segsum(jnp.asarray(a)))
    got = mamba._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [8, 16])
@pytest.mark.parametrize("chunk", [4, 8])
def test_ssd_chunked_matches_reference(chunk, s):
    rng = np.random.default_rng(chunk + s)
    b, h, p, n = 2, 3, 4, 5
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.standard_normal((b, s, h)).astype(np.float32)
    a_log = (0.5 * rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    want = ref_mamba.ssd_chunked(*(jnp.asarray(t) for t in
                                   (x, dt, a_log, bb, cc)), chunk)
    got = mamba.ssd_chunked(*(torch.from_numpy(t) for t in
                              (x, dt, a_log, bb, cc)), chunk)
    close(got, want, F32_TOL)


def test_ssd_chunked_raises_when_the_chunk_does_not_divide():
    """S = 10 in chunks of 4: the reference's reshape raises, and so does
    the port."""
    args = [np.zeros(s, np.float32) for s in
            ((1, 10, 2, 3), (1, 10, 2), (2,), (1, 10, 4), (1, 10, 4))]
    with pytest.raises(TypeError):
        ref_mamba.ssd_chunked(*(jnp.asarray(t) for t in args), 4)
    with pytest.raises(ValueError, match="not a multiple"):
        mamba.ssd_chunked(*(torch.from_numpy(t) for t in args), 4)


def test_softplus_is_logaddexp():
    x = np.array([-50, -3, 0, 3, 19.9, 20.1, 50], np.float32)
    np.testing.assert_array_equal(
        mamba.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))))


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    want = ref_mamba.causal_conv(jnp.asarray(x), jnp.asarray(w))
    close(mamba.causal_conv(torch.from_numpy(x), torch.from_numpy(w)), want,
          F32_TOL)


def test_mamba_block_and_its_gradient_match_reference():
    cfg, pcfg, p, pt = _block(2)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)

    def ref_fn(p, x):
        y = ref_mamba.mamba_block(p, x, cfg, chunk=8)
        return jnp.sum(y * y), y

    (_, want), (gp, gx) = jax.value_and_grad(ref_fn, argnums=(0, 1),
                                             has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ptg = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    got = mamba.mamba_block(ptg, xt, pcfg, chunk=8)
    close(got, want, F32_TOL)
    (got * got).sum().backward()
    close(xt.grad, gx, dict(rtol=1e-3, atol=1e-4))
    for name, t in ptg.items():
        close(t.grad, gp[name], dict(rtol=1e-3, atol=1e-3))


def test_mamba_decode_matches_reference_step_by_step():
    cfg, pcfg, p, pt = _block(4)
    x = np.random.default_rng(5).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    st = ref_mamba.init_mamba_state(cfg, 2)
    pst = mamba.init_mamba_state(pcfg, 2)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in pst.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in st.items()}
    jp = jax.tree.map(jnp.asarray, p)
    for t in range(x.shape[1]):
        want, st = ref_mamba.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                          st, cfg)
        got, pst = mamba.mamba_decode(pt, torch.from_numpy(x[:, t:t + 1]),
                                      pst, pcfg)
        close(got, want, F32_TOL)
        for k in ("ssm", "conv"):
            close(pst[k], st[k], F32_TOL)


def test_mamba_decode_matches_its_forward():
    """The port's own decode against its chunked forward (the reference's
    bar, ``tests/test_models_smoke.py:94-111``)."""
    cfg, pcfg, p, pt = _block(6)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        full = mamba.mamba_block(pt, x, pcfg, chunk=4)
        st = mamba.init_mamba_state(pcfg, 2)
        steps = []
        for t in range(x.shape[1]):
            y, st = mamba.mamba_decode(pt, x[:, t:t + 1], st, pcfg)
            steps.append(y)
    close(torch.cat(steps, 1), full, DECODE_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    """Logits through both groups and the tail: f32 within 1e-4, bf16
    within the bf16 bar; the flash path (the plain version on the CPU)
    and the plain attention path agree."""
    cfg, pcfg, params, model = models(ARCH)
    toks = tokens(8, (2, 16), cfg.vocab)
    with reference_flash():
        want = ref_hybrid.forward(params, jnp.asarray(toks), cfg,
                                  remat=False,
                                  compute_dtype=getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = model(torch.from_numpy(toks), compute_dtype=tdt)
        plain = hybrid.forward(model, torch.from_numpy(toks), pcfg,
                               compute_dtype=tdt, flash=False)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    close(got, want, tol)
    close(plain, want, tol)


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_gradients_match_reference(remat):
    cfg, pcfg, params, model = models(ARCH)
    rng = np.random.default_rng(9)
    batch = {k: rng.integers(0, cfg.vocab, (2, 16), dtype=np.int32)
             for k in ("tokens", "labels")}
    ref_fn = jax.jit(jax.value_and_grad(functools.partial(
        ref_hybrid.lm_loss, cfg=cfg, remat=remat,
        compute_dtype=jnp.float32)))
    want, gwant = ref_fn(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    loss, grads = value_and_grad(functools.partial(
        hybrid.lm_loss, cfg=pcfg, remat=remat, compute_dtype=torch.float32),
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    close(loss, want, LOSS_TOL)
    check_grads(grads, gwant, model, pcfg)
    for name in ("groups.1.0.A_log", "tail.0.dt_bias", "shared.attn.wq"):
        assert float(grads[name].abs().sum()) > 0, name


def test_prefill_step_matches_reference(monkeypatch):
    """The prefill step of both packages at f32 compute, the reference's
    attention through its flash kernel in interpret mode: the next-token
    logits within 1e-4; no launch on the CPU."""
    cfg, pcfg, params, model = models(ARCH)
    monkeypatch.setattr(ref_hybrid, "forward", functools.partial(
        ref_hybrid.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(hybrid, "forward", functools.partial(
        hybrid.forward, compute_dtype=torch.float32))
    toks = tokens(10, (2, 32), cfg.vocab)
    with reference_flash():
        want = ref_api.make_prefill_step(cfg)(params,
                                              {"tokens": jnp.asarray(toks)})
    _build.reset_launch_counts()
    got = api.make_prefill_step(pcfg)(model,
                                      {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, cfg.vocab) and got.dtype == torch.float32
    close(got, want, F32_TOL)
    assert _build.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_teacher_forced_matches_reference(dtype):
    """Eight decode steps over the same tokens, compute and KV cache in
    ``dtype`` (the Mamba states f32): every step's logits and, at the end,
    every leaf of the cache match the reference's."""
    cfg, pcfg, params, model = models(ARCH)
    toks = tokens(11, (2, 8), cfg.vocab)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cache = ref_hybrid.init_cache(cfg, 2, 10, dtype=jdt)
    pcache = hybrid.init_cache(pcfg, 2, 10, dtype=tdt)
    step = jax.jit(lambda p, c, tok, pos: ref_hybrid.decode_step(
        p, c, tok, pos, cfg, compute_dtype=jdt))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t in range(toks.shape[1]):
        want, cache = step(params, cache, jnp.asarray(toks[:, t]),
                           jnp.int32(t))
        got, out = hybrid.decode_step(model, pcache,
                                      torch.from_numpy(toks[:, t]), t, pcfg,
                                      compute_dtype=tdt)
        assert out is pcache
        close(got, want, tol)
    for part in ("groups", "tail"):
        for k in ("ssm", "conv"):
            close(pcache[part][k], cache[part][k], tol)
    for k in ("k", "v"):
        close(pcache[k], cache[k], tol)


def test_decode_matches_forward():
    """Autoregressive decode against the teacher-forced forward, in f32
    (``tests/test_models_smoke.py:94-111``)."""
    pcfg = smoke_config(ARCHS[ARCH])
    model = api.init_params(pcfg, 0, device="cpu")
    toks = torch.from_numpy(tokens(12, (2, 8), pcfg.vocab))
    with torch.no_grad():
        full = hybrid.forward(model, toks, pcfg, compute_dtype=torch.float32)
    cache = hybrid.init_cache(pcfg, 2, 8, dtype=torch.float32)
    for t in range(8):
        logits, cache = hybrid.decode_step(model, cache, toks[:, t], t, pcfg,
                                           compute_dtype=torch.float32)
    close(logits, full[:, -1, :], DECODE_TOL)


def test_train_step_runs_with_microbatches():
    """One bf16 step in two microbatches (``tests/test_models_smoke.py:
    21-46``): a finite loss and every Mamba vector changed."""
    pcfg = smoke_config(ARCHS[ARCH])
    model = api.init_params(pcfg, 0, device="cpu")
    before = model.groups[0][1].dt_bias.detach().clone()
    batch = api.make_batch(pcfg, ShapeSpec("t", 16, 2, "train"), 0,
                           device="cpu")
    opt = AdamW(total_steps=4)
    model, state, loss = api.make_train_step(pcfg, opt, microbatches=2)(
        model, opt.init(model), batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert not torch.equal(model.groups[0][1].dt_bias, before)
    assert int(state.step) == 1


# ---------------------------------------------------------------------------
# api, optimizer, converter, checkpoints, serving, launchers
# ---------------------------------------------------------------------------

def test_module_for_returns_the_hybrid_module():
    assert api.module_for(ARCHS[ARCH]) is hybrid
    assert isinstance(api.init_params(smoke_config(ARCHS[ARCH]), 0,
                                      device="cpu"), hybrid.Hybrid)


def test_init_decode_cache_matches_reference():
    init_decode_cache_matches_reference(ARCH)


def test_adamw_step_and_decay_set_match_reference():
    """The reference stacks the groups (G, E, ...) and the tail (T, ...),
    so every Mamba vector is decayed; the shared block is not stacked, so
    its norms are not."""
    decayed = adamw_step_matches_reference(ARCH)
    assert {"groups.0.0.A_log", "groups.1.1.D", "tail.0.dt_bias",
            "tail.0.norm_in", "groups.0.1.gate_norm",
            "shared.attn.wq"} <= decayed
    assert not {"shared.norm_attn", "shared.norm_mlp", "norm_f"} & decayed


def test_converter_round_trips():
    converter_round_trips(ARCH)


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "dtype",
                                  "unstacked groups"])
def test_converter_refuses_a_mismatched_tree(case):
    cfg, pcfg = _cfgs()
    tree = jax.tree.map(np.asarray, ref_api.init_params(
        cfg, jax.random.PRNGKey(0)))
    if case == "missing":
        del tree["tail"]
    elif case == "extra":
        tree["shared"]["norm_x"] = np.ones(cfg.d_model, np.float32)
    elif case == "shape":
        tree["groups"]["in_proj"] = tree["groups"]["in_proj"][:1]
    elif case == "dtype":
        tree["groups"]["D"] = tree["groups"]["D"].astype(np.int32)
    elif case == "unstacked groups":
        tree["groups"]["A_log"] = tree["groups"]["A_log"][0]
    with pytest.raises(ValueError):
        model_from_reference(tree, pcfg, device="cpu")


def test_checkpoint_keeps_the_reference_layout_and_restores(tmp_path):
    """The model and its AdamW state are saved under the reference's names
    and stacked shapes ((G, E, ...) groups, (T, ...) tail) and restore
    bitwise."""
    cfg, pcfg = _cfgs()
    model = api.init_params(pcfg, 1, device="cpu")
    opt = AdamW()
    batch = api.make_batch(pcfg, ShapeSpec("t", 16, 2, "train"), 2,
                           device="cpu")
    model, state, _ = api.make_train_step(pcfg, opt)(model, opt.init(model),
                                                     batch)
    save_checkpoint(str(tmp_path), 1, (model, state))
    arrays, _ = load_checkpoint_arrays(str(tmp_path), 1)
    ref_tree = ref_api.init_params(cfg, jax.random.PRNGKey(0))
    want = {"0/" + "/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                ref_tree)[0]}
    got = {n: a.shape for n, a in arrays.items() if n.startswith("0/")}
    assert got == want
    assert arrays["1/.mu/groups/in_proj"].shape == \
        want["0/groups/in_proj"]
    fresh = api.init_params(pcfg, 9, device="cpu")
    fresh, fresh_state = restore_checkpoint(str(tmp_path), 1,
                                            (fresh, opt.init(fresh)))
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 fresh.named_parameters()):
        assert torch.equal(p, q), name
    for name in state.mu:
        assert torch.equal(state.mu[name], fresh_state.mu[name]), name
        assert torch.equal(state.nu[name], fresh_state.nu[name]), name


@pytest.mark.parametrize("case", ["substrate", "ragged"])
def test_serving_engine_matches_reference(case, monkeypatch):
    from test_torch_lm import SERVING_CASES
    serving_engine_matches_reference(ARCH, SERVING_CASES[case], monkeypatch,
                                     ref_hybrid, hybrid)


def test_serve_launcher_runs_zamba2_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
          "--max-batch", "2", "--max-seq", "24", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out and "on the CPU" in out


def test_train_launcher_runs_zamba2_on_the_cpu(tmp_path):
    out = run_train_launcher(ARCH, "--steps", 2, "--ckpt-dir", tmp_path,
                             "--ckpt-every", 1)
    assert "step     1  loss" in out.stdout and "done" in out.stdout
    arrays, _ = load_checkpoint_arrays(str(tmp_path), 2)
    assert "0/groups/in_proj" in arrays and "0/tail/A_log" in arrays
