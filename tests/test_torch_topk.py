"""Port parity: top-t sparsifiers and metrics.  The bisection threshold and
the masks must be bitwise the reference's on f32 input; the exact and
columnwise projections agree where no ties exist."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.core import topk as ref_topk
from repro_torch.core import metrics, topk


def _x(shape, seed):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


@pytest.mark.parametrize("shape,t", [((300, 5), 55), ((200, 5), 600),
                                     ((1000, 8), 17), ((64, 3), 1)])
def test_bisect_threshold_and_mask_bitwise(shape, t):
    x = _x(shape, t)
    tau_ref = ref_topk.topk_threshold_bisect(jnp.asarray(x), t)
    tau = topk.topk_threshold_bisect(torch.from_numpy(x), t)
    assert tau.dtype == torch.float32 and tau.shape == ()
    np.testing.assert_array_equal(tau.numpy(), np.asarray(tau_ref))
    np.testing.assert_array_equal(
        topk.topk_project_bisect(torch.from_numpy(x), t).numpy(),
        np.asarray(ref_topk.topk_project_bisect(jnp.asarray(x), t)))


@pytest.mark.parametrize("shape,t", [((300, 5), 55), ((200, 5), 600),
                                     ((50, 4), 0), ((10, 2), 20)])
def test_fused_relu_topk_bitwise(shape, t):
    x = _x(shape, 3 + t)
    want = ref_topk.FusedReluTopK(t=t, interpret=True)(jnp.asarray(x))
    got = topk.FusedReluTopK(t=t)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert topk.FusedReluTopK.fuses_relu


def test_exact_and_columnwise_match_reference():
    x = _x((120, 6), 1)
    for t in (0, 7, 300, 720):
        np.testing.assert_array_equal(
            topk.topk_project_exact(torch.from_numpy(x), t).numpy(),
            np.asarray(ref_topk.topk_project_exact(jnp.asarray(x), t)))
    for t in (0, 5, 60, 120):
        np.testing.assert_array_equal(
            topk.topk_project_columns(torch.from_numpy(x), t).numpy(),
            np.asarray(ref_topk.topk_project_columns(jnp.asarray(x), t)))


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    a = rng.random((40, 30)).astype(np.float32)
    a[a < 0.7] = 0
    u = rng.random((40, 4)).astype(np.float32)
    v = rng.random((30, 4)).astype(np.float32)
    t = torch.from_numpy
    assert float(metrics.relative_error(t(a), t(u), t(v))) == pytest.approx(
        float(ref_metrics.relative_error(a, u, v)), rel=1e-5)
    assert float(metrics.relative_residual(t(u), t(u * 0.9))) == \
        pytest.approx(float(ref_metrics.relative_residual(u, u * 0.9)),
                      rel=1e-5)
    rows, cols = np.nonzero(a)
    got = metrics.relative_error_sparse(
        t(a[rows, cols]), t(rows), t(cols), torch.tensor(float((a ** 2).sum())),
        t(u), t(v))
    want = ref_metrics.relative_error_sparse(
        a[rows, cols], rows, cols, np.float32((a ** 2).sum()), u, v)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    dj = rng.integers(0, 3, 30)
    vs = np.where(rng.random((30, 4)) < 0.4, v, 0).astype(np.float32)
    assert float(metrics.mean_clustering_accuracy(t(dj), t(vs), 3)) == \
        pytest.approx(float(ref_metrics.mean_clustering_accuracy(
            jnp.asarray(dj), jnp.asarray(vs), 3)), rel=1e-5)
    assert int(metrics.max_nnz_tracker(torch.tensor(3), t(u), t(vs))) == \
        int(ref_metrics.max_nnz_tracker(jnp.int32(3), u, vs))
