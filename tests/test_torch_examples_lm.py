"""Port parity for the LM examples: ``examples/torch_serving.py`` and
``examples/torch_lm_training.py`` against the reference's
``examples/serving.py`` and ``examples/lm_training.py``, on the same inputs.

The reference draws its weights, prompts and batches from ``jax.random``;
here both sides get the reference's weights (``convert.model_from_reference``)
and the same prompts and numpy batches, and run the examples' loops: the
port's through the example's own functions, the reference's as its example
writes them.  Bars: the bf16 bar (rtol 5e-2, atol 1e-1;
``tests/test_kernels.py:71``) on logits and losses; serving compares tick by
tick as ``tests/test_torch_lm.py`` does, stopping at the first argmax flip
whose reference margin is under that bar.
"""
import contextlib
import importlib.util
import io
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro.training import AdamW as RefAdamW
from repro.training import init_error_state as ref_init_error_state
from repro.training import make_compressed_grad_fn as ref_compressed
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import model_from_reference
from repro_torch.kernels import _build
from repro_torch.models import api
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import AdamW

REPO = Path(__file__).resolve().parents[1]
BF16_TOL = dict(rtol=5e-2, atol=1e-1)
#: one architecture of each family
FAMILIES = {"dense": "llama3.2-1b", "vlm": "internvl2-76b",
            "moe": "olmoe-1b-7b", "hybrid": "zamba2-7b", "ssm": "xlstm-125m",
            "encdec": "seamless-m4t-large-v2"}


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def serving():
    return load_example("torch_serving")


@pytest.fixture(scope="module")
def training():
    return load_example("torch_lm_training")


def _models(arch, seed=0):
    """(reference cfg, port cfg, reference params, port model on the CPU)
    with the reference's weights."""
    cfg = ref_smoke_config(REF_ARCHS[arch])
    pcfg = smoke_config(ARCHS[arch])
    params = ref_api.init_params(cfg, jax.random.PRNGKey(seed))
    model = model_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                 device="cpu")
    return cfg, pcfg, params, model


def _record_logits(engine, to_numpy):
    log = []
    inner = engine._decode

    def decode(*args):
        out = inner(*args)
        log.append(to_numpy(out[0]))
        return out

    engine._decode = decode
    return log


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_prompts_are_the_examples_wave(serving):
    cfg = smoke_config(ARCHS[serving.ARCH])
    p = serving.prompts(cfg.vocab)
    assert len(p) == serving.REQUESTS == 8
    assert all(len(x) == serving.PROMPT == 6 for x in p)
    assert all(3 <= t < cfg.vocab for x in p for t in x)
    assert p == serving.prompts(cfg.vocab)          # a function of the seed


def test_serving_example_matches_reference(serving):
    """The example's drain and the reference example's loop over the same
    prompts and weights: call by call the same logits within the bf16 bar,
    the same argmax, and so the same tokens; an argmax may differ only
    where the reference's top-2 margin is under the bar, and the comparison
    stops there."""
    cfg, pcfg, params, model = _models(serving.ARCH)
    prompts = serving.prompts(cfg.vocab)
    ref_engine = RefEngine(cfg, params, max_batch=serving.MAX_BATCH,
                           max_seq=serving.MAX_SEQ)
    engine = ServingEngine(pcfg, model, max_batch=serving.MAX_BATCH,
                           max_seq=serving.MAX_SEQ, device="cpu")
    ref_log = _record_logits(ref_engine, np.asarray)
    log = _record_logits(engine, lambda x: x.float().numpy().copy())
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new=serving.MAX_NEW)
                for i, p in enumerate(prompts)]
    reqs = [Request(rid=i, prompt=p, max_new=serving.MAX_NEW)
            for i, p in enumerate(prompts)]

    # the reference example's loop (examples/serving.py:26-37)
    for r in ref_reqs:
        ref_engine.submit(r)
    ref_ticks, ref_emitted = 0, []
    while ref_engine.queue or any(s is not None for s in ref_engine.slots):
        ref_emitted.append(dict(sorted(ref_engine.step().items())))
        ref_ticks += 1
        if ref_ticks > serving.MAX_TICKS:
            break
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        got = serving.drain(engine, reqs)
    assert sum(_build.launch_counts().values()) == 0   # CPU: plain versions
    assert "8 requests submitted; engine slots: 4" in text.getvalue()
    assert all(len(r.out) == serving.MAX_NEW for r in reqs)

    n_cmp = 0
    for have, want in zip(log, ref_log):
        np.testing.assert_allclose(have, want, **BF16_TOL)
        flipped = have.argmax(-1) != want.argmax(-1)
        if flipped.any():
            top2 = np.sort(want[flipped], -1)[:, -2:]
            bar = BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(top2[:, 1])
            assert (top2[:, 1] - top2[:, 0] < bar).all()
            break
        n_cmp += 1
    assert n_cmp >= 0.75 * len(ref_log), (n_cmp, len(ref_log))
    if n_cmp == len(ref_log) == len(log):
        assert got["ticks"] == ref_ticks
        assert got["emitted"] == ref_emitted
        assert [r.out for r in reqs] == [r.out for r in ref_reqs]


def test_serving_main_drains_on_the_cpu(serving):
    with contextlib.redirect_stdout(io.StringIO()) as text, \
            warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = serving.main(["--device", "cpu"])
    assert got["device"] == "cpu" and "device: cpu" in text.getvalue()
    assert sorted(got["outputs"]) == list(range(8))
    assert all(len(o) == serving.MAX_NEW for o in got["outputs"].values())
    assert 1 < got["ticks"] <= serving.MAX_TICKS + 1
    assert f"drained in {got['ticks']} ticks" in text.getvalue()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

STEPS, BATCH, SEQ = 3, 4, 64


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ),
                                    dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ),
                                    dtype=np.int32)}
            for _ in range(STEPS)]


def _reference_losses(cfg, params, batches, compress, density):
    """The reference example's loop (examples/lm_training.py:36-64) on
    ``batches``."""
    opt = RefAdamW(total_steps=STEPS, lr=1e-3)
    opt_state = opt.init(params)
    losses = []
    if compress:
        mesh = jax.make_mesh((jax.device_count(),), ("data",))
        grad_fn = ref_compressed(ref_api.make_loss_fn(cfg), mesh, ("data",),
                                 density=density)
        err = ref_init_error_state(params, jax.device_count())

        @jax.jit
        def step(params, opt_state, err, batch):
            loss, grads, err = grad_fn(params, batch, err)
            params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, err, loss

        with jax.set_mesh(mesh):
            for b in batches:
                params, opt_state, err, loss = step(
                    params, opt_state, err, jax.tree.map(jnp.asarray, b))
                losses.append(float(loss))
    else:
        step = jax.jit(ref_api.make_train_step(cfg, opt))
        for b in batches:
            params, opt_state, loss = step(params, opt_state,
                                           jax.tree.map(jnp.asarray, b))
            losses.append(float(loss))
    return losses


@pytest.mark.parametrize("arch,compress", [("llama3.2-1b", False),
                                           ("olmoe-1b-7b", True)])
def test_training_example_matches_reference(training, arch, compress):
    """Three steps from the reference's weights on the same batches: each
    loss within the bf16 bar (``--compress`` at density 0.05)."""
    cfg, pcfg, params, model = _models(arch)
    batches = _batches(cfg, seed=11)
    want = _reference_losses(cfg, params, batches, compress, 0.05)
    opt = AdamW(total_steps=STEPS, lr=1e-3)
    step, err = training.make_step(pcfg, opt, model, compress, 0.05)
    assert (err is None) == (not compress)
    with contextlib.redirect_stdout(io.StringIO()):
        got = training.train(step, model, opt.init(model), err,
                             ({k: torch.from_numpy(v) for k, v in b.items()}
                              for b in batches))
    assert len(got["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], want, **BF16_TOL)


@pytest.mark.parametrize("arch,compress", [
    (arch, False) for arch in FAMILIES.values()] + [("olmoe-1b-7b", True)])
def test_training_main_runs_every_family(training, arch, compress):
    argv = ["--arch", arch, "--steps", "2", "--device", "cpu"] + (
        ["--compress"] if compress else [])
    with contextlib.redirect_stdout(io.StringIO()) as text:
        got = training.main(argv)
    lines = text.getvalue().splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith(f"{arch}: ") and "M params" in lines[1]
    assert len(got["losses"]) == 2 and np.all(np.isfinite(got["losses"]))
    assert all(("compressed grads" in ln) == compress for ln in lines[2:])
    assert got["n_params"] == sum(p.numel() for p in api.init_params(
        smoke_config(ARCHS[arch]), 0, device="cpu").parameters())
