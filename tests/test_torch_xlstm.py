"""Port parity for the ssm family (``models/xlstm.py``, xlstm-125m): the
mLSTM's chunkwise form, its decode and the sLSTM's loop, the model's
forward, loss, gradients, prefill and decode, the AdamW step and its decay
set, the converter, the decode state, the serving engine and the
launchers, each held against the reference (``repro.models.xlstm``) on
the same inputs.

Parameters cross as numpy through ``model_from_reference``; token ids and
activations are made with numpy.  The smoke config has 4 layers with the
sLSTM at 1 and 3 and no ``head_dim`` (the heads are ``2 d / h`` and
``d / h`` wide).  Tolerances: f32 LM quantities 1e-4; the loss 1e-4 /
1e-5 and gradients 1e-3 / 1e-5 (``tests/test_substrate.py:33,55``); bf16
rtol 5e-2 / atol 1e-1; the mLSTM's decode against its parallel form 5e-2
(``tests/test_models_smoke.py:114-130``); the AdamW step 1e-6.
"""
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
from repro.models import xlstm as ref_xlstm
from repro_torch.checkpoint import latest_step, load_checkpoint_arrays
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import model_from_reference
from repro_torch.models import api, xlstm
from repro_torch.training.optimizer import value_and_grad

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_recurrent import (  # noqa: E402
    BF16_TOL, F32_TOL, LOSS_TOL, adamw_step_matches_reference, check_grads,
    close, converter_round_trips, init_decode_cache_matches_reference,
    models, run_train_launcher, serving_engine_matches_reference, tokens,
)

ARCH = "xlstm-125m"
PARALLEL_VS_DECODE_TOL = dict(rtol=5e-2, atol=5e-2)


def _cfgs():
    return ref_smoke_config(REF_ARCHS[ARCH]), smoke_config(ARCHS[ARCH])


def _layer(kind, seed=0):
    """One mLSTM or sLSTM block's reference parameters (numpy, the biases
    moved off zero) and the port's."""
    cfg, pcfg = _cfgs()
    init = ref_xlstm.init_mlstm if kind == "mlstm" else ref_xlstm.init_slstm
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name in ("b_i", "b_f", "b"):
        if name in p:
            p[name] = (p[name] + 0.5 * rng.standard_normal(p[name].shape)
                       ).astype(np.float32)
    return cfg, pcfg, p, {k: torch.from_numpy(np.array(v))
                          for k, v in p.items()}


def _x(seed, s, d):
    return np.random.default_rng(seed).standard_normal(
        (2, s, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# mLSTM and sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(8, 4), (6, 4)])
def test_mlstm_parallel_and_its_gradient_match_reference(s, chunk):
    """A chunk that divides S (8 in 4s) and one that does not (6: q falls
    to 3): the output and the gradients, through the -inf masks and the
    -1e30 max state, match the reference's."""
    cfg, pcfg, p, pt = _layer("mlstm", s)
    x = _x(s, s, cfg.d_model)

    def ref_fn(p, x):
        y = ref_xlstm.mlstm_parallel(p, x, cfg, chunk=chunk)
        return jnp.sum(y * y), y

    (_, want), (gp, gx) = jax.value_and_grad(ref_fn, argnums=(0, 1),
                                             has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ptg = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    got = xlstm.mlstm_parallel(ptg, xt, pcfg, chunk=chunk)
    close(got, want, F32_TOL)
    (got * got).sum().backward()
    assert bool(torch.isfinite(xt.grad).all())
    close(xt.grad, gx, dict(rtol=1e-3, atol=1e-4))
    for name, t in ptg.items():
        close(t.grad, gp[name], dict(rtol=1e-3, atol=1e-4))


def test_mlstm_decode_matches_reference_step_by_step():
    cfg, pcfg, p, pt = _layer("mlstm", 1)
    x = _x(2, 6, cfg.d_model)
    st = ref_xlstm.init_mlstm_state(cfg, 2)
    pst = xlstm.init_mlstm_state(pcfg, 2)
    jp = jax.tree.map(jnp.asarray, p)
    for t in range(x.shape[1]):
        want, st = ref_xlstm.mlstm_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                          st, cfg)
        got, pst = xlstm.mlstm_decode(pt, torch.from_numpy(x[:, t:t + 1]),
                                      pst, pcfg)
        close(got, want, F32_TOL)
        for k in ("C", "n", "m"):
            close(pst[k], st[k], F32_TOL)


def test_mlstm_decode_matches_its_parallel_form():
    """The port's own recurrent form against its chunkwise one (the
    reference's bar)."""
    cfg, pcfg, p, pt = _layer("mlstm", 3)
    x = torch.from_numpy(_x(4, 10, cfg.d_model))
    with torch.no_grad():
        full = xlstm.mlstm_parallel(pt, x, pcfg, chunk=4)
        st = xlstm.init_mlstm_state(pcfg, 2)
        steps = []
        for t in range(x.shape[1]):
            y, st = xlstm.mlstm_decode(pt, x[:, t:t + 1], st, pcfg)
            steps.append(y)
    close(torch.cat(steps, 1), full, PARALLEL_VS_DECODE_TOL)


@pytest.mark.parametrize("given", [False, True])
def test_slstm_seq_matches_reference(given):
    """From a fresh state, and from a state carried out of an earlier
    sequence: the output, the state and the input gradient."""
    cfg, pcfg, p, pt = _layer("slstm", 5)
    x = _x(6, 7, cfg.d_model)
    jp = jax.tree.map(jnp.asarray, p)
    st, pst = None, None
    if given:
        pre = _x(7, 3, cfg.d_model)
        _, st = ref_xlstm.slstm_seq(jp, jnp.asarray(pre), cfg)
        _, pst = xlstm.slstm_seq(pt, torch.from_numpy(pre), pcfg)

    def ref_fn(x):
        y, new = ref_xlstm.slstm_seq(jp, x, cfg, state=st)
        return jnp.sum(y * y), (y, new)

    (_, (want, want_st)), gx = jax.value_and_grad(ref_fn, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got, got_st = xlstm.slstm_seq(pt, xt, pcfg, state=pst)
    close(got, want, F32_TOL)
    for k in ("c", "n", "m", "h"):
        close(got_st[k], want_st[k], F32_TOL)
    (got * got).sum().backward()
    close(xt.grad, gx, dict(rtol=1e-3, atol=1e-4))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    cfg, pcfg, params, model = models(ARCH)
    toks = tokens(8, (2, 12), cfg.vocab)
    want = ref_xlstm.forward(params, jnp.asarray(toks), cfg,
                             compute_dtype=getattr(jnp, dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(toks), compute_dtype=getattr(torch,
                                                                  dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape
    close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_lm_loss_and_gradients_match_reference():
    cfg, pcfg, params, model = models(ARCH)
    rng = np.random.default_rng(9)
    batch = {k: rng.integers(0, cfg.vocab, (2, 12), dtype=np.int32)
             for k in ("tokens", "labels")}
    ref_fn = jax.jit(jax.value_and_grad(functools.partial(
        ref_xlstm.lm_loss, cfg=cfg, compute_dtype=jnp.float32)))
    want, gwant = ref_fn(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    loss, grads = value_and_grad(functools.partial(
        xlstm.lm_loss, cfg=pcfg, compute_dtype=torch.float32), model,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    close(loss, want, LOSS_TOL)
    check_grads(grads, gwant, model, pcfg)
    for name in ("layers.1.r", "layers.0.b_f", "layers.2.w_if"):
        assert float(grads[name].abs().sum()) > 0, name


def test_prefill_step_matches_reference(monkeypatch):
    cfg, pcfg, params, model = models(ARCH)
    monkeypatch.setattr(ref_xlstm, "forward", functools.partial(
        ref_xlstm.forward, compute_dtype=jnp.float32))
    monkeypatch.setattr(xlstm, "forward", functools.partial(
        xlstm.forward, compute_dtype=torch.float32))
    toks = tokens(10, (2, 20), cfg.vocab)
    want = ref_api.make_prefill_step(cfg)(params,
                                          {"tokens": jnp.asarray(toks)})
    got = api.make_prefill_step(pcfg)(model,
                                      {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, cfg.vocab) and got.dtype == torch.float32
    close(got, want, F32_TOL)


def test_decode_step_matches_reference():
    """Six f32 decode steps: every step's logits and every layer's state
    within 1e-4; the states are updated in place."""
    cfg, pcfg, params, model = models(ARCH)
    toks = tokens(11, (2, 6), cfg.vocab)
    states = ref_xlstm.init_state(cfg, 2)
    pstates = xlstm.init_state(pcfg, 2)
    step = jax.jit(lambda p, s, tok: ref_xlstm.decode_step(
        p, s, tok, 0, cfg, compute_dtype=jnp.float32))
    for t in range(toks.shape[1]):
        want, states = step(params, states, jnp.asarray(toks[:, t]))
        got, out = xlstm.decode_step(model, pstates,
                                     torch.from_numpy(toks[:, t]), t, pcfg,
                                     compute_dtype=torch.float32)
        assert out is pstates
        close(got, want, F32_TOL)
    for got_st, want_st in zip(pstates, states):
        assert set(got_st) == set(want_st)
        for k in got_st:
            close(got_st[k], want_st[k], F32_TOL)


# ---------------------------------------------------------------------------
# api, optimizer, converter, serving, launchers
# ---------------------------------------------------------------------------

def test_module_for_returns_the_xlstm_module():
    assert api.module_for(ARCHS[ARCH]) is xlstm
    model = api.init_params(smoke_config(ARCHS[ARCH]), 0, device="cpu")
    assert [type(layer).__name__ for layer in model.layers] == \
        ["MLSTMBlock", "SLSTMBlock", "MLSTMBlock", "SLSTMBlock"]


def test_init_decode_cache_matches_reference():
    """The decode state: a dict a layer, f32, its size independent of the
    shape's length."""
    init_decode_cache_matches_reference(ARCH)


def test_adamw_step_and_decay_set_match_reference():
    """The reference keeps xlstm's layers in a list, not stacked: no
    layer vector (norms, gate biases, the sLSTM's bias) is decayed."""
    decayed = adamw_step_matches_reference(ARCH)
    assert {"layers.0.w_up", "layers.1.r", "embed", "unembed"} <= decayed
    assert not {"layers.0.norm", "layers.0.b_i", "layers.2.b_f",
                "layers.1.b", "layers.3.out_norm", "norm_f"} & decayed


def test_converter_round_trips():
    converter_round_trips(ARCH)


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "swapped"])
def test_converter_refuses_a_mismatched_tree(case):
    cfg, pcfg = _cfgs()
    tree = jax.tree.map(np.asarray, ref_api.init_params(
        cfg, jax.random.PRNGKey(0)))
    if case == "missing":
        del tree["layers"][2]["wq"]
    elif case == "extra":
        tree["layers"].append(tree["layers"][0])
    elif case == "shape":
        tree["layers"][1]["r"] = tree["layers"][1]["r"][:1]
    elif case == "swapped":                  # an mLSTM where an sLSTM is
        tree["layers"][1] = tree["layers"][0]
    with pytest.raises(ValueError):
        model_from_reference(tree, pcfg, device="cpu")


@pytest.mark.parametrize("case", ["substrate", "ragged"])
def test_serving_engine_matches_reference(case, monkeypatch):
    from test_torch_lm import SERVING_CASES
    serving_engine_matches_reference(ARCH, SERVING_CASES[case], monkeypatch,
                                     ref_xlstm, xlstm)


def test_serve_launcher_runs_xlstm_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
          "--max-batch", "2", "--max-seq", "24", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out and "on the CPU" in out


def test_train_launcher_kill_and_resume_is_bitwise_for_xlstm(tmp_path):
    """``--arch xlstm-125m``: stopped at 2 steps and rerun to 4, it ends
    bitwise where an uninterrupted 4-step run ends; the checkpoint keeps
    the reference's list of layers (``0/layers/1/r``)."""
    a, b = tmp_path / "a", tmp_path / "b"
    run_train_launcher(ARCH, "--steps", 2, "--ckpt-dir", a, "--ckpt-every",
                       2, "--deterministic")
    assert latest_step(str(a)) == 2
    resumed = run_train_launcher(ARCH, "--steps", 4, "--ckpt-dir", a,
                                 "--ckpt-every", 2, "--deterministic")
    assert "resuming from checkpoint step 2" in resumed.stdout
    run_train_launcher(ARCH, "--steps", 4, "--ckpt-dir", b, "--ckpt-every",
                       2, "--deterministic")
    got, _ = load_checkpoint_arrays(str(a), 4)
    want, _ = load_checkpoint_arrays(str(b), 4)
    assert got.keys() == want.keys()
    assert {"0/layers/1/r", "1/.mu/layers/3/w_in"} <= set(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
