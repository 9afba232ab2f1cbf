"""Port parity for the encdec family (``models/encdec.py``,
seamless-m4t-large-v2): the encoder, the teacher-forced decoder, the loss
and its gradients, prefill and the decode steps, the train step and
AdamW's decay set, the input specs and the decode cache, the converter,
the checkpoint layout, the train launcher's kill and resume, and the
serving refusals, each held against the reference
(``repro.models.encdec``) on the same inputs.

Parameters cross as numpy through ``model_from_reference``; frames and
token ids are made with numpy from a seed.  The reference's serving path
(``encode`` under ``prefill``, ``decode_step``'s cross-attention) runs its
flash kernel in interpret mode, as the port's serving path takes its
kernel's wrapper (the plain version on the CPU); its loss and
``decode_train`` run the plain path, as the port's.  Tolerances: f32 LM
quantities 1e-4; the loss 1e-4 / 1e-5 and gradients 1e-3 / 1e-5
(``tests/test_substrate.py:33,55``); bf16 rtol 5e-2 / atol 1e-1
(``tests/test_kernels.py:71``); decode against the teacher-forced decoder
2e-3 (``tests/test_models_smoke.py:90-91``).
"""
import contextlib
import functools
import os
import subprocess
import sys
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
from repro.models import common as ref_common
from repro.models import encdec as ref_encdec
from repro.serving import ServingEngine as RefEngine
from repro.training import AdamW as RefAdamW
from repro_torch.checkpoint import (
    load_checkpoint_arrays, restore_checkpoint, save_checkpoint,
)
from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.convert import adam_state_from_reference, model_from_reference
from repro_torch.kernels import _build
from repro_torch.models import api, encdec
from repro_torch.serving import ServingEngine
from repro_torch.training import AdamW
from repro_torch.training.optimizer import value_and_grad

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_recurrent import (  # noqa: E402
    BF16_TOL, F32_TOL, LOSS_TOL, SRC, adamw_step_matches_reference,
    check_grads, close, converter_round_trips,
    init_decode_cache_matches_reference, models, random_adam_state,
    ref_leaves,
)

ARCH = "seamless-m4t-large-v2"
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
B, S_ENC, S_DEC = 2, 32, 16
DTYPES = ["float32", "bfloat16"]


@contextlib.contextmanager
def reference_flash():
    ref_common.use_flash_kernel(True, interpret=True)
    try:
        yield
    finally:
        ref_common.use_flash_kernel(False)


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, port cfg, reference params, port model) from one
    reference pytree."""
    return models(ARCH)


@pytest.fixture(scope="module")
def inputs():
    """Frames (B, S_ENC, d) and token ids / labels (B, S_DEC) in numpy."""
    pcfg = smoke_config(ARCHS[ARCH])
    rng = np.random.default_rng(0)
    return dict(
        frame_embeds=rng.standard_normal((B, S_ENC, pcfg.d_model)).astype(
            np.float32),
        tokens=rng.integers(0, pcfg.vocab, (B, S_DEC), dtype=np.int32),
        labels=rng.integers(0, pcfg.vocab, (B, S_DEC), dtype=np.int32))


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the model's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(pair, inputs, dtype):
    """The encoder memory (B, S, d) in the compute dtype: the kernel's path
    against the reference's kernel in interpret mode, and the plain path
    against the reference's plain path."""
    cfg, pcfg, params, model = pair
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fe = inputs["frame_embeds"]
    with reference_flash():
        want = ref_encdec.encode(params, _j(fe), cfg, remat=False,
                                 compute_dtype=jdt)
    want_plain = ref_encdec.encode(params, _j(fe), cfg, remat=False,
                                   compute_dtype=jdt)
    with torch.no_grad():
        got = encdec.encode(model, _t(fe), pcfg, remat=False,
                            compute_dtype=tdt)
        plain = encdec.encode(model, _t(fe), pcfg, remat=False,
                              compute_dtype=tdt, flash=False)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    close(got, want, tol)
    close(plain, want_plain, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_train_matches_reference(pair, inputs, dtype):
    """The teacher-forced decoder's logits (B, S, vocab) in f32 over one
    memory: causal self-attention, cross-attention, the MLP."""
    cfg, pcfg, params, model = pair
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    mem = np.random.default_rng(1).standard_normal(
        (B, S_ENC, pcfg.d_model)).astype(np.float32)
    want = ref_encdec.decode_train(params, _j(mem), _j(inputs["tokens"]),
                                   cfg, remat=False, compute_dtype=jdt)
    with torch.no_grad():
        got = encdec.decode_train(model, _t(mem), _t(inputs["tokens"]),
                                  pcfg, remat=False, compute_dtype=tdt,
                                  flash=False)
        flash = encdec.decode_train(model, _t(mem), _t(inputs["tokens"]),
                                    pcfg, remat=False, compute_dtype=tdt)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    close(got, want, tol)
    close(flash, want, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_steps_match_reference(pair, inputs, dtype):
    """``prefill`` (the memory, ``ck`` and ``cv``), then 8 decode steps over
    the same tokens: every step's logits and, at the end, the
    self-attention cache; the port's cache is written in place."""
    cfg, pcfg, params, model = pair
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fe, toks = inputs["frame_embeds"], inputs["tokens"]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    with reference_flash():
        cache, memory = ref_encdec.prefill(params, _j(fe), cfg, max_dec=10,
                                           compute_dtype=jdt)
    pcache, pmemory = encdec.prefill(model, _t(fe), pcfg, max_dec=10,
                                     compute_dtype=tdt)
    assert {k: (tuple(v.shape), v.dtype) for k, v in pcache.items()} == \
        {k: (v.shape, tdt) for k, v in cache.items()}
    close(pmemory, memory, tol)
    for k in ("ck", "cv"):
        close(pcache[k], cache[k], tol)
    for k in ("k", "v"):
        assert not bool(pcache[k].any())
    step = jax.jit(lambda p, c, tok, pos: ref_encdec.decode_step(
        p, c, tok, pos, cfg, compute_dtype=jdt))
    for t in range(8):
        with reference_flash():
            want, cache = step(params, cache, _j(toks[:, t]), jnp.int32(t))
        got, out = encdec.decode_step(model, pcache, _t(toks[:, t]), t, pcfg,
                                      compute_dtype=tdt)
        assert out is pcache and got.dtype == torch.float32
        close(got, want, tol)
    for k in ("k", "v", "ck", "cv"):
        close(pcache[k], cache[k], tol)


@pytest.mark.parametrize("remat", [True, False])
def test_seq2seq_loss_and_gradients_match_reference(pair, inputs, remat):
    cfg, pcfg, params, model = pair
    ref_fn = jax.jit(jax.value_and_grad(functools.partial(
        ref_encdec.seq2seq_loss, cfg=cfg, remat=remat,
        compute_dtype=jnp.float32)))
    want, gwant = ref_fn(params, {k: _j(v) for k, v in inputs.items()})
    loss, grads = value_and_grad(functools.partial(
        encdec.seq2seq_loss, cfg=pcfg, remat=remat,
        compute_dtype=torch.float32),
        model, {k: _t(v) for k, v in inputs.items()})
    close(loss, want, LOSS_TOL)
    check_grads(grads, gwant, model, pcfg)
    for name in ("enc_layers.0.attn.wq", "dec_layers.1.cross_attn.wk",
                 "norm_enc", "embed", "unembed"):
        assert float(grads[name].abs().sum()) > 0, name


def test_decode_matches_decode_train():
    """The port's own prefill and decode steps against its teacher-forced
    decoder over the same memory, in f32 (``tests/test_models_smoke.py:
    90-91``)."""
    pcfg = smoke_config(ARCHS[ARCH])
    model = api.init_params(pcfg, 0, device="cpu")
    rng = np.random.default_rng(2)
    fe = _t(rng.standard_normal((B, S_ENC, pcfg.d_model)).astype(np.float32))
    toks = _t(rng.integers(0, pcfg.vocab, (B, 8), dtype=np.int32))
    cache, memory = encdec.prefill(model, fe, pcfg, max_dec=8,
                                   compute_dtype=torch.float32)
    with torch.no_grad():
        full = encdec.decode_train(model, memory, toks, pcfg,
                                   compute_dtype=torch.float32)
    for t in range(8):
        logits, cache = encdec.decode_step(model, cache, toks[:, t], t, pcfg,
                                           compute_dtype=torch.float32)
        close(logits, full[:, t, :], DECODE_TOL)


# ---------------------------------------------------------------------------
# api: steps, specs, caches
# ---------------------------------------------------------------------------

def test_module_for_returns_the_encdec_module():
    assert api.module_for(ARCHS[ARCH]) is encdec
    assert isinstance(api.init_params(smoke_config(ARCHS[ARCH]), 0,
                                      device="cpu"), encdec.EncDec)


def test_prefill_step_returns_the_reference_memory(pair, inputs):
    """``make_prefill_step`` returns the encoder memory (bf16), as the
    reference's; no launch on the CPU."""
    cfg, pcfg, params, model = pair
    fe = inputs["frame_embeds"]
    with reference_flash():
        want = ref_api.make_prefill_step(cfg)(params,
                                              {"frame_embeds": _j(fe)})
    _build.reset_launch_counts()
    got = api.make_prefill_step(pcfg)(model, {"frame_embeds": _t(fe)})
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    close(got, want, BF16_TOL)
    assert _build.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_and_make_batch_match_reference(kind):
    """The frames (B, S, d) in bf16 and the decoder's tokens and labels of
    ``max(S // dec_ratio, 16)``; ``make_batch`` draws every key of the
    specs in its shape and dtype."""
    cfg = smoke_config(ARCHS[ARCH])
    for s in (32, 256):
        want = ref_api.input_specs(cfg, RefShapeSpec("x", s, 3, kind))
        got = api.input_specs(cfg, ShapeSpec("x", s, 3, kind))
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}
        batch = api.make_batch(cfg, ShapeSpec("x", s, 3, kind), 0,
                               device="cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in got.items()}
        for k, v in batch.items():
            if v.dtype == torch.int32:
                assert 0 <= int(v.min()) and int(v.max()) < cfg.vocab


def test_init_decode_cache_matches_reference():
    """``k``, ``v`` of ``max(S // dec_ratio, 16)`` rows and ``ck``, ``cv``
    of S frames, (L, B, ., Hkv, hd) each, zero."""
    init_decode_cache_matches_reference(ARCH)
    cache = api.init_decode_cache(smoke_config(ARCHS[ARCH]),
                                  ShapeSpec("d", 256, 3, "decode"),
                                  device="cpu")
    assert cache["k"].shape[2] == 32 and cache["ck"].shape[2] == 256


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(pair, inputs, monkeypatch,
                                      microbatches):
    """One AdamW step at f32 compute from the same parameters and state:
    the loss and every parameter within 1e-4 of the reference's; with two
    microbatches the frames are split with the tokens."""
    monkeypatch.setattr(ref_encdec, "seq2seq_loss", functools.partial(
        ref_encdec.seq2seq_loss, compute_dtype=jnp.float32))
    cfg, pcfg, params, _ = pair
    tree = jax.tree.map(np.asarray, params)
    model = model_from_reference(tree, pcfg, device="cpu")
    state = random_adam_state(tree, np.random.default_rng(4), 3)
    ref_opt, opt = RefAdamW(lr=1e-2, warmup=1), AdamW(lr=1e-2, warmup=1)
    step = jax.jit(ref_api.make_train_step(cfg, ref_opt,
                                           microbatches=microbatches))
    p_ref, s_ref, l_ref = step(params, jax.tree.map(jnp.asarray, state),
                               {k: _j(v) for k, v in inputs.items()})
    port_state = adam_state_from_reference(state, pcfg, device="cpu")
    model, port_state, loss = api.make_train_step(
        pcfg, opt, microbatches=microbatches,
        compute_dtype=torch.float32)(model, port_state,
                                     {k: _t(v) for k, v in inputs.items()})
    close(loss, l_ref, F32_TOL)
    want = ref_leaves(p_ref, pcfg)
    for name, p in model.named_parameters():
        close(p, want[name], F32_TOL)
    assert int(port_state.step) == int(s_ref.step) == 4


def test_adamw_step_and_decay_set_match_reference():
    """The reference stacks the encoder and decoder layers, so every
    layer's norms are decayed; ``norm_enc`` and ``norm_dec`` are not."""
    decayed = adamw_step_matches_reference(ARCH)
    assert {"enc_layers.0.norm_attn", "enc_layers.1.norm_mlp",
            "dec_layers.0.norm_self", "dec_layers.1.norm_cross",
            "dec_layers.0.norm_mlp", "dec_layers.1.cross_attn.wq",
            "embed", "unembed"} <= decayed
    assert not {"norm_enc", "norm_dec"} & decayed


# ---------------------------------------------------------------------------
# converter, checkpoints, launchers, serving
# ---------------------------------------------------------------------------

def test_converter_round_trips():
    converter_round_trips(ARCH)


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "dtype",
                                  "unstacked layers"])
def test_converter_refuses_a_mismatched_tree(pair, case):
    cfg, pcfg, params, _ = pair
    tree = jax.tree.map(np.asarray, params)
    if case == "missing":
        del tree["norm_dec"]
    elif case == "extra":
        tree["dec_layers"]["norm_x"] = tree["dec_layers"]["norm_mlp"]
    elif case == "shape":
        tree["enc_layers"]["mlp"]["w_up"] = \
            tree["enc_layers"]["mlp"]["w_up"][:1]
    elif case == "dtype":
        tree["norm_enc"] = tree["norm_enc"].astype(np.int32)
    elif case == "unstacked layers":
        tree["dec_layers"]["norm_cross"] = tree["dec_layers"]["norm_cross"][0]
    with pytest.raises(ValueError):
        model_from_reference(tree, pcfg, device="cpu")


def test_checkpoint_keeps_the_reference_layout_and_restores(tmp_path):
    """The model and its AdamW state are saved under the reference's names
    and stacked (L, ...) shapes and restore bitwise."""
    cfg = smoke_config(ARCHS[ARCH])
    model = api.init_params(cfg, 1, device="cpu")
    opt = AdamW()
    batch = api.make_batch(cfg, ShapeSpec("t", 32, 2, "train"), 2,
                           device="cpu")
    model, state, _ = api.make_train_step(cfg, opt)(model, opt.init(model),
                                                    batch)
    save_checkpoint(str(tmp_path), 1, (model, state))
    arrays, _ = load_checkpoint_arrays(str(tmp_path), 1)
    ref_cfg = ref_smoke_config(REF_ARCHS[ARCH])
    ref_tree = ref_api.init_params(ref_cfg, jax.random.PRNGKey(0))
    want = {"0/" + "/".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                ref_tree)[0]}
    got = {n: a.shape for n, a in arrays.items() if n.startswith("0/")}
    assert got == want and ref_cfg.n_enc_layers == 2
    assert arrays["1/.mu/dec_layers/cross_attn/wk"].shape == \
        want["0/dec_layers/cross_attn/wk"]
    fresh = api.init_params(cfg, 9, device="cpu")
    fresh, fresh_state = restore_checkpoint(str(tmp_path), 1,
                                            (fresh, opt.init(fresh)))
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 fresh.named_parameters()):
        assert torch.equal(p, q), name
    for name in state.mu:
        assert torch.equal(state.mu[name], fresh_state.mu[name]), name
        assert torch.equal(state.nu[name], fresh_state.nu[name]), name


def test_train_launcher_kill_and_resume_is_bitwise(tmp_path):
    """``--arch seamless-m4t-large-v2 --smoke --deterministic`` on the CPU,
    stopped at 4 steps (checkpoints every 2) and rerun to 6: it resumes
    from 4 and ends bitwise where an uninterrupted 6-step run ends."""
    env = dict(os.environ, PYTHONPATH=SRC)
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
            "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-every", "2", "--deterministic"]
    a, b = tmp_path / "a", tmp_path / "b"

    def start(steps, where):
        return subprocess.Popen(base + ["--steps", str(steps), "--ckpt-dir",
                                        str(where)], env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)

    def finish(proc):
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-2000:]
        return out

    first, whole = start(4, a), start(6, b)
    assert "resuming" not in finish(first)
    assert finish(whole).splitlines()[-1] == "done"
    resumed = finish(start(6, a))
    assert "resuming from checkpoint step 4" in resumed
    got, _ = load_checkpoint_arrays(str(a), 6)
    want, _ = load_checkpoint_arrays(str(b), 6)
    assert got.keys() == want.keys() and "0/enc_layers/attn/wq" in got
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_serving_engine_refuses_the_family_as_the_reference_does(pair):
    cfg, pcfg, params, model = pair
    with pytest.raises(NotImplementedError, match="prefill/decode_step"):
        RefEngine(cfg, params, max_batch=2, max_seq=32)
    with pytest.raises(NotImplementedError,
                       match=r"repro_torch\.models\.encdec\.prefill / "
                             "decode_step"):
        ServingEngine(pcfg, model, max_batch=2, max_seq=32, device="cpu")


def test_serve_launcher_refuses_the_family_before_drawing_parameters(
        monkeypatch):
    from repro_torch.launch import serve

    def drawn(*args, **kwargs):
        raise AssertionError("parameters were drawn")

    monkeypatch.setattr(serve.api, "init_params", drawn)
    with pytest.raises(SystemExit, match=r"repro_torch\.models\.encdec\."
                                         "prefill / decode_step"):
        serve.main(["--arch", ARCH, "--device", "cpu"])


def test_full_width_model_has_the_reference_parameter_count():
    """seamless-m4t-large-v2 at full width: 2 x 262,354,944 embedding and
    unembedding, 24 encoder layers of 29,362,176 and 24 decoder layers of
    33,557,504, as the reference's pytree (shapes only)."""
    cfg = ARCHS[ARCH]
    shapes = jax.eval_shape(lambda: ref_api.init_params(
        REF_ARCHS[ARCH], jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    got = sum(p.numel() for p in encdec.EncDec(cfg, device="meta")
              .parameters())
    assert got == want == 2_034_784_256
