"""Port parity for the LM serving slice: configs, the attention / forward /
prefill / decode functions, the serving engine and the weight converter,
each held against the reference on the same inputs.

The reference runs its attention through the Pallas flash kernel in
interpret mode (``common.use_flash_kernel(True, interpret=True)``, reset in
a ``finally`` as ``tests/test_kernels.py:237-241`` does), because the port's
``attention`` always goes through its flash wrapper.  Weights cross as
numpy through ``model_from_reference``; token ids and activations are
made with numpy.  Tolerances are the reference's: 2e-3 in f32
(``tests/test_kernels.py:243``, ``tests/test_models_smoke.py:90-91``) and
rtol 5e-2 / atol 1e-1 in bf16 (``tests/test_kernels.py:71``).
"""
import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import ShapeSpec as RefShapeSpec
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, smoke_config
from repro_torch.convert import model_from_reference
from repro_torch.kernels import _build
from repro_torch.models import (
    api, common, encdec, hybrid, moe, transformer, xlstm,
)
from repro_torch.serving import Request, ServingEngine

F32_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_TOL = dict(rtol=5e-2, atol=1e-1)
PORTED = ("codeqwen1.5-7b", "deepseek-coder-33b", "internvl2-76b",
          "llama3.2-1b", "olmoe-1b-7b", "phi4-mini-3.8b",
          "qwen3-moe-235b-a22b", "seamless-m4t-large-v2", "xlstm-125m",
          "zamba2-7b")


@contextlib.contextmanager
def reference_flash():
    ref_common.use_flash_kernel(True, interpret=True)
    try:
        yield
    finally:
        ref_common.use_flash_kernel(False)


def _models(arch, seed=0, bias_seed=None):
    """(reference cfg, port cfg, reference params, port model on the CPU).
    ``bias_seed`` fills the (zero-initialised) qkv biases with numpy noise
    so that a biased config exercises them."""
    cfg = ref_smoke_config(REF_ARCHS[arch])
    pcfg = smoke_config(ARCHS[arch])
    params = ref_api.init_params(cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)
        for name in ("bq", "bk", "bv"):
            leaf = tree["layers"]["attn"][name]
            tree["layers"]["attn"][name] = (
                0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        params = jax.tree.map(jnp.asarray, tree)
    return cfg, pcfg, params, model_from_reference(tree, pcfg,
                                                         device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), **tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_config_and_smoke_config_match_reference(arch):
    """Every reference arch: the port's config field for field, and
    ``smoke_config`` with every family's overrides."""
    ref = REF_ARCHS[arch]
    cfg = ARCHS[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(smoke_config(cfg)) == \
        dataclasses.asdict(ref_smoke_config(ref))
    assert cfg.hd == ref.hd and cfg.q_dim == ref.q_dim
    assert smoke_config(cfg).hd == ref_smoke_config(ref).hd


def test_ported_archs_are_the_dense_and_vlm_families():
    """Every family is ported: ``ARCHS`` is the reference's registry, in
    its order."""
    assert list(ARCHS) == list(REF_ARCHS)
    assert set(ARCHS) == set(PORTED)
    assert {n: dataclasses.asdict(s) for n, s in SHAPES.items()} == \
        {n: dataclasses.asdict(s) for n, s in REF_SHAPES.items()}


# ---------------------------------------------------------------------------
# attention, forward, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,bias", [("llama3.2-1b", False),
                                       ("codeqwen1.5-7b", True)])
def test_attention_matches_reference(arch, bias):
    cfg = ref_smoke_config(REF_ARCHS[arch])
    p = jax.tree.map(np.asarray, ref_common.init_attention(
        jax.random.PRNGKey(3), cfg))
    if bias:
        rng = np.random.default_rng(1)
        p = {n: (0.1 * rng.standard_normal(w.shape)).astype(np.float32)
             if n.startswith("b") else w for n, w in p.items()}
    x = np.random.default_rng(2).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
    with reference_flash():
        want = ref_common.attention(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x), cfg, jnp.asarray(pos))
    got = common.attention({n: torch.tensor(w) for n, w in p.items()},
                           torch.from_numpy(x), smoke_config(ARCHS[arch]),
                           torch.from_numpy(pos.copy()))
    _assert_close(got, want, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "codeqwen1.5-7b"])
def test_forward_matches_reference(arch, dtype):
    cfg, pcfg, params, model = _models(arch, bias_seed=4 if
                                       REF_ARCHS[arch].qkv_bias else None)
    toks = _tokens(5, (2, 24), cfg.vocab)
    with reference_flash():
        want = ref_tf.forward(params, jnp.asarray(toks), cfg, remat=False,
                              compute_dtype=getattr(jnp, dtype))
    with torch.no_grad():
        got = transformer.forward(model, torch.from_numpy(toks), pcfg,
                                  compute_dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_forward_vlm_prefix_and_hidden_match_reference():
    cfg, pcfg, params, model = _models("internvl2-76b")
    toks = _tokens(6, (2, 12), cfg.vocab)
    patches = np.random.default_rng(7).standard_normal(
        (2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    with reference_flash():
        want = ref_tf.forward(params, jnp.asarray(toks), cfg, remat=False,
                              extra_embeds=jnp.asarray(patches),
                              compute_dtype=jnp.float32, unembed=False)
    with torch.no_grad():
        got = model(torch.from_numpy(toks),
                    extra_embeds=torch.from_numpy(patches),
                    compute_dtype=torch.float32, unembed=False)
    assert got.shape == (2, cfg.n_patches + 12, cfg.d_model)
    _assert_close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-76b"])
def test_prefill_step_matches_reference(arch):
    cfg, pcfg, params, model = _models(arch)
    shape = RefShapeSpec("smoke_pre", 32, 2, "prefill")
    batch = jax.tree.map(np.asarray,
                         ref_api.make_batch(cfg, shape, jax.random.PRNGKey(1)))
    with reference_flash():
        want = ref_api.make_prefill_step(cfg)(
            params, jax.tree.map(jnp.asarray, batch))
    port_batch = {n: torch.tensor(np.asarray(x, dtype=np.float32))
                  .to(torch.bfloat16) if x.dtype != np.int32
                  else torch.tensor(x) for n, x in batch.items()}
    _build.reset_launch_counts()
    got = api.make_prefill_step(pcfg)(model, port_batch)
    assert got.shape == (2, cfg.vocab) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    _assert_close(got, want, BF16_TOL)
    assert _build.launch_counts()["flash_attention"] == 0   # CPU: no launch


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_teacher_forced_matches_reference(dtype):
    """Decode steps over the same tokens, compute and cache in ``dtype``:
    the logits of every step and the cache rows match the reference's."""
    cfg, pcfg, params, model = _models("llama3.2-1b")
    toks = _tokens(8, (2, 10), cfg.vocab)
    cache = ref_tf.init_cache(cfg, 2, 12, dtype=getattr(jnp, dtype))
    pcache = transformer.init_cache(pcfg, 2, 12, dtype=getattr(torch, dtype))
    ref_step = jax.jit(lambda p, c, tok, pos: ref_tf.decode_step(
        p, c, tok, pos, cfg, compute_dtype=getattr(jnp, dtype)))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t in range(toks.shape[1]):
        want, cache = ref_step(params, cache, jnp.asarray(toks[:, t]),
                               jnp.int32(t))
        got, out_cache = transformer.decode_step(
            model, pcache, torch.from_numpy(toks[:, t]), t, pcfg,
            compute_dtype=getattr(torch, dtype))
        assert out_cache is pcache          # updated in place
        _assert_close(got, want, tol)
    for name in ("k", "v"):
        _assert_close(pcache[name].float(), np.asarray(cache[name],
                                                       dtype=np.float32), tol)


def test_decode_matches_forward():
    """Autoregressive decode == teacher-forced forward, in f32
    (``tests/test_models_smoke.py:75-91``)."""
    pcfg = smoke_config(ARCHS["llama3.2-1b"])
    model = api.init_params(pcfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(9, (2, 8), pcfg.vocab))
    with torch.no_grad():
        full = transformer.forward(model, toks, pcfg,
                                   compute_dtype=torch.float32)
    cache = transformer.init_cache(pcfg, 2, 8, dtype=torch.float32)
    with torch.no_grad():
        for t in range(8):
            logits, cache = transformer.decode_step(
                model, cache, toks[:, t], t, pcfg,
                compute_dtype=torch.float32)
    torch.testing.assert_close(logits, full[:, -1, :], rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# serving engine
# ---------------------------------------------------------------------------

def _record_logits(engine, to_numpy):
    """Wrap ``engine._decode`` so every call's logits are kept."""
    log = []
    inner = engine._decode

    def decode(*args):
        out = inner(*args)
        log.append(to_numpy(out[0]))
        return out

    engine._decode = decode
    return log


def _serve(engine, requests):
    for r in requests:
        engine.submit(r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return engine.run_until_drained()


SERVING_CASES = {
    # tests/test_substrate.py:161-176: staggered admissions at max_batch 2
    "substrate": dict(max_batch=2, max_seq=32,
                      requests=[([5, 6, 7], 3)] * 5),
    "ragged": dict(max_batch=3, max_seq=16, requests=[
        ([11, 200, 3, 9], 4), ([1], 6), ([40, 41, 42, 43, 44, 45], 3),
        ([250, 7], 5), (list(range(100, 115)), 2), ([2, 60], 4),
        ([77] * 9, 8)]),
}


@pytest.mark.parametrize("case", sorted(SERVING_CASES))
def test_serving_engine_matches_reference(case):
    """Same requests, same weights: call by call the same logits within the
    bf16 bar, the same argmax on every slot row, and so the same token
    streams.  An argmax may rightly differ only where the reference's top-2
    margin on that row is under the bf16 bar; from such a call on the two
    engines decode different tokens, so the comparison stops there, and the
    test asserts that most calls were compared."""
    spec = SERVING_CASES[case]
    cfg, pcfg, params, model = _models("llama3.2-1b", seed=0)
    ref_engine = RefEngine(cfg, params, max_batch=spec["max_batch"],
                           max_seq=spec["max_seq"])
    engine = ServingEngine(pcfg, model, max_batch=spec["max_batch"],
                           max_seq=spec["max_seq"], device="cpu")
    ref_log = _record_logits(ref_engine, np.asarray)
    log = _record_logits(engine, lambda x: x.float().numpy().copy())
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new=n)
                for i, (p, n) in enumerate(spec["requests"])]
    reqs = [Request(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(spec["requests"])]
    ref_done = _serve(ref_engine, ref_reqs)
    done = _serve(engine, reqs)
    assert all(len(r.out) >= 1 for r in reqs) and not engine.queue

    n_cmp = 0
    for got, want in zip(log, ref_log):
        _assert_close(got, want, BF16_TOL)
        flipped = got.argmax(-1) != want.argmax(-1)
        if flipped.any():
            top2 = np.sort(want[flipped], -1)[:, -2:]
            bar = BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(top2[:, 1])
            assert (top2[:, 1] - top2[:, 0] < bar).all()
            break
        n_cmp += 1
    assert n_cmp >= 0.75 * len(ref_log), (n_cmp, len(ref_log))
    if n_cmp == len(ref_log) == len(log):
        assert [r.out for r in reqs] == [r.out for r in ref_reqs]
        assert [r.rid for r in done] == [r.rid for r in ref_done]


def test_serving_rejections_match_reference():
    cfg, pcfg, params, model = _models("llama3.2-1b")
    bad = [(0, [], 3), (1, ["x"], 3), (2, [5, cfg.vocab], 3), (3, [-1], 3),
           (4, [5, 6], 0), (5, [5, 6], 16), (6, [5, 6, 7], 2)]
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new=n) for i, p, n in bad]
    reqs = [Request(rid=i, prompt=p, max_new=n) for i, p, n in bad]
    _serve(RefEngine(cfg, params, max_batch=2, max_seq=16), ref_reqs)
    with pytest.warns(RuntimeWarning, match="rejected"):
        engine = ServingEngine(pcfg, model, max_batch=2, max_seq=16,
                               device="cpu")
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
    assert [r.error for r in reqs] == [r.error for r in ref_reqs]
    assert [r.error is None for r in reqs] == [False] * 6 + [True]
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]


def test_serve_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "3", "--max-batch", "2",
          "--max-seq", "24", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out and "on the CPU" in out


# ---------------------------------------------------------------------------
# api and converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["moe", "hybrid", "ssm", "encdec"])
def test_unported_family_raises_with_its_roadmap_item(family):
    """Every family is ported and returns its module (``encdec``, the last
    one, since its slice); an unknown family raises."""
    cfg = next(c for c in REF_ARCHS.values() if c.family == family)
    port_cfg = common.ArchConfig(**dataclasses.asdict(cfg))
    ported = {"moe": moe, "hybrid": hybrid, "ssm": xlstm, "encdec": encdec}
    assert api.module_for(port_cfg) is ported[family]
    with pytest.raises(NotImplementedError, match="is unknown"):
        api.module_for(dataclasses.replace(port_cfg, family="rnn"))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-76b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_and_make_batch_match_reference(arch, kind):
    cfg = ref_smoke_config(REF_ARCHS[arch])
    pcfg = smoke_config(ARCHS[arch])
    want = ref_api.input_specs(cfg, RefShapeSpec("s", 32, 2, kind))
    shape = ShapeSpec("s", 32, 2, kind)
    specs = api.input_specs(pcfg, shape)
    assert {n: (tuple(s.shape), str(s.dtype).split(".")[-1])
            for n, s in specs.items()} == \
        {n: (tuple(s.shape), str(s.dtype)) for n, s in want.items()}
    batch = api.make_batch(pcfg, shape, seed=3, device="cpu")
    again = api.make_batch(pcfg, shape, seed=3, device="cpu")
    for name, spec in specs.items():
        x = batch[name]
        assert tuple(x.shape) == spec.shape and x.dtype == spec.dtype
        assert torch.equal(x, again[name])
        if x.dtype == torch.int32:
            assert 0 <= int(x.min()) and int(x.max()) < pcfg.vocab


def test_init_params_and_cache_follow_the_reference_layout():
    pcfg = smoke_config(ARCHS["codeqwen1.5-7b"])
    cfg = ref_smoke_config(REF_ARCHS["codeqwen1.5-7b"])
    model = api.init_params(pcfg, 7, device="cpu")
    again = api.init_params(pcfg, 7, device="cpu")
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(p, q), name
    tree = jax.tree.map(np.asarray, ref_api.init_params(
        cfg, jax.random.PRNGKey(0)))
    for layer in model.layers:
        for name, p in layer.named_parameters():
            block, _, leaf = name.rpartition(".")
            want = tree["layers"][block][leaf] if block else \
                tree["layers"][leaf]
            assert tuple(p.shape) == want.shape[1:], name
    assert torch.equal(model.layers[0].norm_attn, torch.ones(pcfg.d_model))
    assert torch.count_nonzero(model.layers[1].attn.bq) == 0
    assert hasattr(model, "unembed") == (not pcfg.tie_embeddings)
    ref_cache = ref_api.init_decode_cache(cfg, RefShapeSpec("d", 16, 3,
                                                            "decode"))
    cache = api.init_decode_cache(pcfg, ShapeSpec("d", 16, 3, "decode"),
                                  device="cpu")
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == ref_cache[name].shape
        assert cache[name].dtype == torch.bfloat16


def test_converter_copies_without_transposing():
    cfg, pcfg, params, model = _models("llama3.2-1b")
    tree = jax.tree.map(np.asarray, params)
    assert not hasattr(model, "unembed")           # tied embeddings
    np.testing.assert_array_equal(model.embed.detach().numpy(), tree["embed"])
    for i, layer in enumerate(model.layers):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                getattr(layer.attn, name).detach().numpy(),
                tree["layers"]["attn"][name][i])
        np.testing.assert_array_equal(layer.mlp.w_down.detach().numpy(),
                                      tree["layers"]["mlp"]["w_down"][i])


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "config"])
def test_converter_refuses_a_mismatched_tree(case):
    cfg = ref_smoke_config(REF_ARCHS["llama3.2-1b"])
    pcfg = smoke_config(ARCHS["llama3.2-1b"])
    tree = jax.tree.map(np.asarray, ref_api.init_params(
        cfg, jax.random.PRNGKey(0)))
    if case == "missing":
        del tree["layers"]["mlp"]["w_up"]
    elif case == "extra":
        tree["unembed"] = np.zeros((cfg.d_model, cfg.vocab), np.float32)
    elif case == "shape":
        tree["layers"]["attn"]["wk"] = tree["layers"]["attn"]["wk"][:1]
    elif case == "config":
        pcfg = smoke_config(ARCHS["codeqwen1.5-7b"])   # needs qkv biases
    with pytest.raises(ValueError):
        model_from_reference(tree, pcfg, device="cpu")
