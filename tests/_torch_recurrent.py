"""Helpers shared by the port's parity tests of the hybrid and ssm
families (``test_torch_hybrid.py``, ``test_torch_xlstm.py``): the two
packages' models from one reference pytree, a port parameter's reference
leaf, and the checks both families run alike (the AdamW step, the
converter, the decode cache, the serving engine, the launchers)."""
import functools
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import ShapeSpec as RefShapeSpec
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro.training import AdamW as RefAdamW
from repro.training.optimizer import AdamState as RefAdamState
from repro_torch.configs import ARCHS, ShapeSpec, smoke_config
from repro_torch.convert import (
    _flatten, _placed, adam_state_from_reference, model_from_reference,
)
from repro_torch.models import api
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import AdamW

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

#: f32 LM quantities (PRs 12 and 20); the reference's loss and gradient
#: bars (``tests/test_substrate.py:33,55``); its bf16 bar
#: (``tests/test_kernels.py:71``); the AdamW step (one update of the same
#: numbers)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=1e-1)
ADAM_TOL = dict(rtol=1e-6, atol=1e-6)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(np32(got), np32(want), **tol)


def models(arch, seed=0):
    """(reference cfg, port cfg, reference params, port model on the
    CPU), the port's parameters converted from the reference's."""
    cfg = ref_smoke_config(REF_ARCHS[arch])
    pcfg = smoke_config(ARCHS[arch])
    params = ref_api.init_params(cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return cfg, pcfg, params, model_from_reference(tree, pcfg, device="cpu")


def ref_leaves(tree, pcfg):
    """Port parameter name -> its row of the reference tree's leaf."""
    flat = _flatten(jax.tree.map(np.asarray, tree))
    return {name: flat[path][index]
            for name, (path, index, _) in _placed(pcfg).items()}


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def check_grads(grads, ref_grads, model, pcfg):
    want = ref_leaves(ref_grads, pcfg)
    assert set(grads) == {n for n, _ in model.named_parameters()} == \
        set(want)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        close(g, want[name], GRAD_TOL)


def random_adam_state(tree, rng, step):
    mu = jax.tree.map(lambda p: (1e-3 * rng.standard_normal(p.shape))
                      .astype(np.float32), tree)
    nu = jax.tree.map(lambda p: (1e-6 * rng.random(p.shape))
                      .astype(np.float32), tree)
    return RefAdamState(np.int32(step), mu, nu)


def adamw_step_matches_reference(arch):
    """One ``AdamW.update`` from the same parameters (random, so that no
    leaf is zero), state and gradients: parameters, mu and nu within 1e-6
    of the reference's.  Then the decayed set: with zero gradients and
    moments only the decay moves a leaf, and the port moves exactly the
    leaves the reference moves, which are its ``p.ndim >= 2`` ones, by
    name; ``reference_ndim`` agrees."""
    from repro_torch.training.optimizer import reference_ndim

    cfg, pcfg, params, _ = models(arch)
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda p: rng.standard_normal(p.shape)
                        .astype(np.float32), jax.tree.map(np.asarray, params))
    params = jax.tree.map(jnp.asarray, tree)
    state = random_adam_state(tree, rng, 5)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape)
                         .astype(np.float32), tree)
    ref_opt, opt = (RefAdamW(lr=1e-2, warmup=1, weight_decay=0.5),
                    AdamW(lr=1e-2, warmup=1, weight_decay=0.5))
    update = jax.jit(ref_opt.update)
    p_ref, s_ref = update(jax.tree.map(jnp.asarray, grads),
                          jax.tree.map(jnp.asarray, state), params)
    model = model_from_reference(tree, pcfg, device="cpu")
    port_state = adam_state_from_reference(state, pcfg, device="cpu")
    port_grads = {n: torch.from_numpy(np.array(g))
                  for n, g in ref_leaves(grads, pcfg).items()}
    model, port_state = opt.update(port_grads, port_state, model)
    for got, want in ((dict(model.named_parameters()), p_ref),
                      (port_state.mu, s_ref.mu), (port_state.nu, s_ref.nu)):
        want = ref_leaves(want, pcfg)
        for name, t in got.items():
            close(t, want[name], ADAM_TOL)
    assert int(port_state.step) == int(s_ref.step) == 6

    zeros = jax.tree.map(np.zeros_like, tree)
    still = RefAdamState(np.int32(5), zeros, zeros)
    p_ref, _ = update(jax.tree.map(jnp.asarray, zeros),
                      jax.tree.map(jnp.asarray, still), params)
    after_ref, before_ref = ref_leaves(p_ref, pcfg), ref_leaves(tree, pcfg)
    flat = _flatten(tree)
    ndim_ref = {name: flat[path].ndim
                for name, (path, _, _) in _placed(pcfg).items()}
    model = model_from_reference(tree, pcfg, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt.update({n: torch.zeros_like(p) for n, p in before.items()},
               adam_state_from_reference(still, pcfg, device="cpu"), model)
    decayed = set()
    for name, p in model.named_parameters():
        ref_moved = not np.array_equal(after_ref[name], before_ref[name])
        assert ref_moved == (ndim_ref[name] >= 2), name
        assert (not torch.equal(p, before[name])) == ref_moved, name
        assert (reference_ndim(name, p, pcfg.family) >= 2) == ref_moved, \
            name
        if ref_moved:
            decayed.add(name)
    return decayed


def init_decode_cache_matches_reference(arch):
    cfg = ref_smoke_config(REF_ARCHS[arch])
    pcfg = smoke_config(ARCHS[arch])
    want = jax.tree_util.tree_flatten_with_path(ref_api.init_decode_cache(
        cfg, RefShapeSpec("d", 16, 3, "decode")))[0]
    got = api.init_decode_cache(pcfg, ShapeSpec("d", 16, 3, "decode"),
                                device="cpu")
    flat = _flatten(got)
    names = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): leaf for path, leaf in want}
    assert set(flat) == set(names)
    for name, leaf in names.items():
        t = flat[name]
        assert tuple(t.shape) == leaf.shape, name
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), name
        np.testing.assert_array_equal(np32(t), np.asarray(leaf, np.float32),
                                      err_msg=name)


def converter_round_trips(arch):
    """Every leaf of the reference's tree is copied, unchanged, into the
    port's parameter that the layout names, and back."""
    cfg, pcfg, params, model = models(arch)
    want = ref_leaves(params, pcfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[name],
                                      err_msg=name)
    from repro_torch.checkpoint.store import _host_leaves
    names, arrays, _ = _host_leaves(model)
    flat = _flatten(jax.tree.map(np.asarray, params))
    assert set(names) == set(flat)
    for name, a in zip(names, arrays):
        np.testing.assert_array_equal(a, flat[name], err_msg=name)


def _record_logits(engine, to_numpy):
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


def serving_engine_matches_reference(arch, spec, monkeypatch, ref_mod, mod):
    """Both engines on the same requests with the decode steps at f32
    compute and an f32 KV cache (the recurrent states are f32 anyway):
    call by call the logits within 1e-4, the same argmax and so the same
    tokens (``tests/test_torch_lm.py``'s check: an argmax may rightly
    differ only where the reference's top-2 margin is under the bar, and
    the comparison stops there)."""
    monkeypatch.setattr(ref_mod, "decode_step", functools.partial(
        ref_mod.decode_step, compute_dtype=jnp.float32))
    monkeypatch.setattr(mod, "decode_step", functools.partial(
        mod.decode_step, compute_dtype=torch.float32))
    if hasattr(ref_mod, "init_cache"):
        monkeypatch.setattr(ref_mod, "init_cache", functools.partial(
            ref_mod.init_cache, dtype=jnp.float32))
        monkeypatch.setattr(mod, "init_cache", functools.partial(
            mod.init_cache, dtype=torch.float32))
    cfg, pcfg, params, model = models(arch)
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
        close(got, want, F32_TOL)
        flipped = got.argmax(-1) != want.argmax(-1)
        if flipped.any():
            top2 = np.sort(want[flipped], -1)[:, -2:]
            bar = F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(top2[:, 1])
            assert (top2[:, 1] - top2[:, 0] < bar).all()
            break
        n_cmp += 1
    assert n_cmp >= 0.75 * len(ref_log), (n_cmp, len(ref_log))
    if n_cmp == len(ref_log) == len(log):
        assert [r.out for r in reqs] == [r.out for r in ref_reqs]
        assert [r.rid for r in done] == [r.rid for r in ref_done]


def run_train_launcher(arch, *args, expect=0):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", arch, "--smoke", "--device", "cpu",
                          "--batch", "2", "--seq", "16", *map(str, args)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == expect, out.stderr[-2000:]
    return out
