"""Port parity: the relu + top-t epilogue.  The port's plain versions of its
one-launch kernel — ``relu_topk_ref`` (relu, bisection, mask) and
``relu_topk_rounds_ref`` (the kernel's round structure, ``s`` bisection
steps per count round) — against the reference's ``FusedReluTopK`` (its
Pallas mask in interpret mode) and the threshold it computes with
``topk_threshold_bisect``.  Both ``tau`` and ``out`` must match bitwise:
the port's arithmetic is the reference's, step for step, in f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import topk as ref_topk
from repro_torch.core import topk
from repro_torch.kernels import _build, ref
from repro_torch.kernels.project_mask import relu_topk

STEPS = (1, 2, 3, 5)


def _ref_epilogue(x: np.ndarray, t: int, num_steps: int = 40):
    """The reference's ``(out, tau)``: ``FusedReluTopK``'s output, and the
    threshold its ``__call__`` computes (the same bisection call)."""
    key = (x.tobytes(), x.shape, t, num_steps)
    if key not in _REF_CACHE:
        _REF_CACHE[key] = _ref_epilogue_uncached(x, t, num_steps)
    return _REF_CACHE[key]


_REF_CACHE: dict = {}


def _ref_epilogue_uncached(x: np.ndarray, t: int, num_steps: int):
    xj = jnp.asarray(x)

    def count_pos_ge(_absx, tau):
        return jnp.sum(jnp.maximum(xj, 0.0) >= tau)

    hi = jnp.maximum(jnp.max(xj), 0.0)
    tau = ref_topk.topk_threshold_bisect(xj, t, num_steps,
                                         count_fn=count_pos_ge, hi_init=hi)
    out = ref_topk.FusedReluTopK(t=t, num_steps=num_steps,
                                 interpret=True)(xj)
    return np.asarray(out), np.asarray(tau)


def _case(name: str) -> tuple:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "300x5":
        return rng.standard_normal((300, 5)).astype(np.float32), 55
    if name == "pubmed_u":
        return rng.standard_normal((20112, 5)).astype(np.float32), 2011
    if name == "all_negative":
        x = -np.abs(rng.standard_normal((200, 5))) - 1e-3
        return x.astype(np.float32), 40
    if name == "all_zero":
        return np.zeros((100, 5), np.float32), 17
    if name == "ties":
        return rng.choice(np.float32([0, 0.5, 1]), (400, 5)), 300
    if name == "nan":
        x = rng.standard_normal((300, 5)).astype(np.float32)
        x[17, 3] = np.nan
        return x, 55
    if name == "t1":
        return rng.standard_normal((300, 5)).astype(np.float32), 1
    if name == "t_numel_minus_1":
        return rng.standard_normal((300, 5)).astype(np.float32), 300 * 5 - 1
    raise KeyError(name)


CASES = ["300x5", "pubmed_u", "all_negative", "all_zero", "ties", "nan",
         "t1", "t_numel_minus_1"]


def _assert_bitwise(got_out, got_tau, want_out, want_tau):
    assert got_tau.dtype == torch.float32 and got_tau.shape == ()
    np.testing.assert_array_equal(got_tau.numpy(), want_tau)
    assert got_tau.numpy().tobytes() == np.float32(want_tau).tobytes()
    np.testing.assert_array_equal(got_out.numpy(), want_out)


@pytest.mark.parametrize("name", CASES)
def test_relu_topk_ref_bitwise(name):
    x, t = _case(name)
    want_out, want_tau = _ref_epilogue(x, t)
    out, tau = ref.relu_topk_ref(torch.from_numpy(x), t)
    _assert_bitwise(out, tau, want_out, want_tau)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("name", CASES)
def test_round_structured_bisection_bitwise(name, steps):
    x, t = _case(name)
    want_out, want_tau = _ref_epilogue(x, t)
    out, tau = ref.relu_topk_rounds_ref(torch.from_numpy(x), t, 40, steps)
    _assert_bitwise(out, tau, want_out, want_tau)


@pytest.mark.parametrize("num_steps", [0, 1, 7, 12])
@pytest.mark.parametrize("steps", STEPS)
def test_rounds_take_any_step_count(num_steps, steps):
    """A last round shorter than the others, and no step at all."""
    x, t = _case("300x5")
    want_out, want_tau = _ref_epilogue(x, t, num_steps)
    out, tau = ref.relu_topk_rounds_ref(torch.from_numpy(x), t, num_steps,
                                        steps)
    _assert_bitwise(out, tau, want_out, want_tau)


@pytest.mark.parametrize("name", ["300x5", "ties", "nan", "t1"])
def test_fused_relu_topk_and_cpu_wrapper(name):
    """``FusedReluTopK`` and the ``relu_topk`` wrapper on CPU tensors run
    the plain version, launch nothing, and keep NNZ at t up to ties."""
    x, t = _case(name)
    want_out, want_tau = _ref_epilogue(x, t)
    _build.reset_launch_counts()
    out, tau = relu_topk(torch.from_numpy(x), t)
    _assert_bitwise(out, tau, want_out, want_tau)
    np.testing.assert_array_equal(
        topk.FusedReluTopK(t=t)(torch.from_numpy(x)).numpy(), want_out)
    assert sum(_build.launch_counts().values()) == 0
    if name in ("300x5", "t1"):
        assert int((out != 0).sum()) == t


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 200), k=st.integers(1, 6), seed=st.integers(0, 999),
       steps=st.sampled_from(STEPS), frac=st.floats(0.0, 1.0))
def test_round_structured_bisection_property(n, k, seed, steps, frac):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k)).astype(np.float32)
    t = max(1, min(n * k - 1, int(frac * n * k))) if n * k > 1 else 1
    want_out, want_tau = _ref_epilogue(x, t)
    out, tau = ref.relu_topk_rounds_ref(torch.from_numpy(x), t, 40, steps)
    _assert_bitwise(out, tau, want_out, want_tau)
    out, tau = ref.relu_topk_ref(torch.from_numpy(x), t)
    _assert_bitwise(out, tau, want_out, want_tau)
