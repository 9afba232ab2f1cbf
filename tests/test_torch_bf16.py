"""bf16 operands and the fused half-step past k = 32, port against reference
on the CPU.

The reference's Pallas kernels run in interpret mode, as its own tests run
them; the port's wrappers run their plain versions on CPU tensors (bf16
widened to f32, accumulated in f32, the product rounded back to bf16).
Bars are the reference's: bf16 outputs within rtol 5e-2, atol 1e-1
(``tests/test_kernels.py``, ``tests/test_backends.py``) with the same output
dtype; the fused product bitwise the plain one; the bisection threshold and
the mask bitwise; the wide-k fused half-step within 1e-4 of the reference's
fused kernel (``tests/test_backends.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.topk import topk_threshold_bisect as ref_bisect
from repro.kernels import bsr as ref_bsr
from repro.kernels.bsr_spmm import bsr_spmm as ref_spmm
from repro.kernels.bsr_spmm import bsr_spmm_t as ref_spmm_t
from repro.kernels.fused import bsr_spmm_gram as ref_fused
from repro.kernels.gram import gram as ref_gram
from repro.kernels.project_mask import project_mask as ref_mask
from repro_torch.backend import get_backend
from repro_torch.backend.cuda_bsr import CudaBsrBackend
from repro_torch.core.topk import FusedReluTopK
from repro_torch.kernels import bsr, ref
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_t
from repro_torch.kernels.fused import bsr_spmm_gram, bsr_spmm_gram_t
from repro_torch.kernels.gram import gram
from repro_torch.kernels.project_mask import project_mask, relu_topk

BF16_TOL = dict(rtol=5e-2, atol=1e-1)


def _rand_sparse(rng, n, m, density=0.05):
    a = rng.random((n, m)).astype(np.float32)
    a[rng.random((n, m)) > density] = 0
    return a


def _np(x):
    """A port tensor or a reference array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _ref_bf16(b):
    """The reference's BSR with bf16 tiles (its tests cast the same way)."""
    return type(b)(b.tiles.astype(jnp.bfloat16), b.block_cols, b.shape)


def _bf16(a):
    """A host array as a bf16 tensor and the same values as a jax array."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


@pytest.mark.parametrize("n,m,k,bs", [(128, 128, 16, 64), (257, 129, 33, 32),
                                      (300, 200, 40, 64), (64, 512, 5, 32)])
def test_bsr_spmm_bf16_matches_reference(n, m, k, bs):
    rng = np.random.default_rng(n + m + k)
    a = _rand_sparse(rng, n, m)
    b_ref = _ref_bf16(ref_bsr.bsr_from_dense(a, bm=bs, bk=bs))
    b = bsr.bsr_operand(a, bm=bs, bk=bs, dtype=torch.bfloat16).bsr
    assert b.tiles.dtype == torch.bfloat16
    u, u_ref = _bf16(rng.standard_normal((m, k)))
    want = ref_spmm(b_ref, u_ref, interpret=True)
    got = bsr_spmm(b, u)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    # and both against f32 math on the same bf16 values
    np.testing.assert_allclose(
        _np(got), _np(bsr.bsr_to_dense(b)) @ _np(u), **BF16_TOL)


def test_bsr_spmm_t_bf16_on_an_operand_matches_reference():
    """``tests/test_backends.py::test_pallas_spmm_t_bf16`` on both."""
    rng = np.random.default_rng(3)
    a = _rand_sparse(rng, 128, 96)
    op_ref = ref_bsr.bsr_operand(a, bm=32, bk=32, dtype=np.float32)
    op_ref = ref_bsr.BSROperand(_ref_bf16(op_ref.bsr),
                                _ref_bf16(op_ref.bsr_t), op_ref.shape)
    op = bsr.bsr_operand(a, bm=32, bk=32, dtype=torch.bfloat16)
    assert op.bsr_t.tiles.dtype == torch.bfloat16
    u, u_ref = _bf16(rng.standard_normal((128, 16)))
    want = ref_spmm_t(op_ref, u_ref, interpret=True)
    got = bsr_spmm_t(op, u)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    np.testing.assert_allclose(_np(got), a.T @ _np(u), **BF16_TOL)


@pytest.mark.parametrize("n,m,k,bs", [(128, 128, 16, 64), (300, 200, 40, 64),
                                      (257, 129, 5, 32)])
def test_fused_bf16_matches_reference(n, m, k, bs):
    """``tests/test_kernels.py::test_fused_spmm_gram_bf16`` on both: the
    product bitwise the port's own plain product and within the bar of the
    reference's; the Gram f32 in both."""
    rng = np.random.default_rng(6 + n)
    a = _rand_sparse(rng, n, m)
    b_ref = _ref_bf16(ref_bsr.bsr_from_dense(a, bm=bs, bk=bs))
    op = bsr.bsr_operand(a, bm=bs, bk=bs, dtype=torch.bfloat16)
    u, u_ref = _bf16(rng.standard_normal((m, k)))
    y_ref, g_ref = ref_fused(b_ref, u_ref, interpret=True)
    y, g = bsr_spmm_gram(op.bsr, u)
    assert y.dtype == torch.bfloat16 and y_ref.dtype == jnp.bfloat16
    assert g.dtype == torch.float32 and g_ref.dtype == jnp.float32
    assert torch.equal(y.view(torch.int16), bsr_spmm(op.bsr, u).view(
        torch.int16))
    np.testing.assert_allclose(_np(y), _np(y_ref), **BF16_TOL)
    np.testing.assert_allclose(_np(g), _np(g_ref), **BF16_TOL)
    uf = _np(u)
    np.testing.assert_allclose(_np(g), uf.T @ uf, rtol=1e-5, atol=1e-4)
    v, _ = _bf16(rng.standard_normal((n, k)))
    y_t, _ = bsr_spmm_gram_t(op, v)
    assert torch.equal(y_t.view(torch.int16),
                       bsr_spmm_t(op, v).view(torch.int16))


@pytest.mark.parametrize("n,k", [(1000, 16), (513, 40), (64, 5), (300, 256)])
def test_gram_bf16_matches_reference(n, k):
    u, u_ref = _bf16(np.random.default_rng(n + k).standard_normal((n, k)))
    want = ref_gram(u_ref, interpret=True)
    got = gram(u)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    np.testing.assert_allclose(_np(got), _np(u).T @ _np(u), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("shape", [(100, 37), (256, 256), (17, 512)])
@pytest.mark.parametrize("tau", [0.0, 0.5, 2.0])
def test_project_mask_bf16_matches_reference(shape, tau):
    rng = np.random.default_rng(sum(shape))
    x, x_ref = _bf16(rng.standard_normal(shape))
    want = ref_mask(x_ref, jnp.float32(tau), interpret=True)
    for t in (torch.tensor(tau), torch.tensor(tau).to(torch.bfloat16)):
        got = project_mask(x, t)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("n,k,t", [(1001, 5, 150), (20112, 5, 2011),
                                   (300, 40, 2400)])
def test_bisection_and_relu_topk_bf16_match_reference(n, k, t):
    """``tau`` bisected in f32 on the bf16 entries and cast to bf16 at the
    end, bitwise the reference's ``topk_threshold_bisect``; ``relu_topk``'s
    mask bitwise the reference's mask at that ``tau``."""
    rng = np.random.default_rng(n + k)
    x, x_ref = _bf16(rng.standard_normal((n, k)) - 0.25)
    y, y_ref = torch.clamp_min(x, 0.0), jnp.maximum(x_ref, 0.0)
    want_tau = ref_bisect(y_ref, t)
    tau = ref.topk_threshold_bisect(y, t)
    assert tau.dtype == torch.bfloat16 and want_tau.dtype == jnp.bfloat16
    assert float(tau) == float(want_tau)
    out, tau2 = relu_topk(x, t)
    assert out.dtype == torch.bfloat16 and float(tau2) == float(want_tau)
    want_out = ref_mask(x_ref, want_tau, interpret=True)
    np.testing.assert_array_equal(_np(out), _np(want_out))
    assert torch.equal(FusedReluTopK(t)(x).view(torch.int16),
                       out.view(torch.int16))
    # f32 input keeps its bits: the f32 comparison is the same comparison
    xf = x.float()
    assert ref.topk_threshold_bisect(torch.clamp_min(xf, 0.0), t).dtype == (
        torch.float32)


# ---------------------------------------------------------------------------
# The backend: bf16 ingest, products and Grams; fusion past k = 32
# ---------------------------------------------------------------------------

def test_cuda_bsr_prepare_bf16_ingests_in_f32_and_casts():
    rng = np.random.default_rng(9)
    a = _rand_sparse(rng, 200, 150, density=0.1)
    be = get_backend("cuda-bsr")
    op = be.prepare(a, dtype=torch.bfloat16, device="cpu")
    op32 = be.prepare(a, device="cpu")
    for b, b32 in ((op.bsr, op32.bsr), (op.bsr_t, op32.bsr_t)):
        assert b.tiles.dtype == torch.bfloat16
        assert torch.equal(b.tiles, b32.tiles.to(torch.bfloat16))
        assert torch.equal(b.block_cols, b32.block_cols)
        assert torch.equal(b.gram_flags, b32.gram_flags)
    # a bf16 BSR round-trips through the host ingest and keeps its dtype
    again = bsr.bsr_operand(op.bsr)
    assert torch.equal(again.bsr_t.tiles, op.bsr_t.tiles)
    assert torch.equal(bsr.bsr_transpose(op.bsr).tiles, op.bsr_t.tiles)
    import scipy.sparse

    op_sp = be.prepare(scipy.sparse.csr_matrix(a), dtype=torch.bfloat16,
                       device="cpu")
    assert torch.equal(op_sp.bsr.tiles, op.bsr.tiles)


def test_cuda_bsr_bf16_backend_matches_reference_backend():
    """``cuda-bsr`` against ``pallas-bsr`` on the same bf16 operand:
    ``matmul``, ``matmul_t``, ``gram`` and both fused half-steps, in bf16
    (the Gram cast back to the factor's dtype, as the reference does)."""
    from repro.backend import get_backend as ref_get_backend

    rng = np.random.default_rng(12)
    a = _rand_sparse(rng, 192, 160, density=0.1)
    be = CudaBsrBackend(64, 64)
    op = be.prepare(a, dtype=torch.bfloat16, device="cpu")
    rb = ref_get_backend("pallas-bsr")
    op_ref = ref_bsr.bsr_operand(a, bm=64, bk=64, dtype=jnp.bfloat16)
    v, v_ref = _bf16(rng.random((160, 6)))
    u, u_ref = _bf16(rng.random((192, 6)))
    pairs = [(be.matmul(op, v), rb.matmul(op_ref, v_ref)),
             (be.matmul_t(op, u), rb.matmul_t(op_ref, u_ref)),
             (be.gram(u), rb.gram(u_ref))]
    for (y, g), (y_ref, g_ref) in ((be.matmul_with_gram(op, v),
                                    rb.matmul_with_gram(op_ref, v_ref)),
                                   (be.matmul_t_with_gram(op, u),
                                    rb.matmul_t_with_gram(op_ref, u_ref))):
        pairs += [(y, y_ref), (g, g_ref)]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_bf16_fit_fails_at_the_solve_as_the_reference_does():
    """Neither package solves in bf16: both ingest and take the first
    half-step, then the Cholesky solve refuses bf16."""
    from repro.nmf import EnforcedNMF as RefNMF
    from repro.nmf import NMFConfig as RefConfig
    from repro_torch.nmf import EnforcedNMF, NMFConfig

    a = _rand_sparse(np.random.default_rng(4), 96, 64, density=0.2)
    with pytest.raises(NotImplementedError, match="BFloat16"):
        EnforcedNMF(NMFConfig(k=3, iters=2, dtype="bfloat16",
                              backend="cuda-bsr"), device="cpu").fit(a)
    with pytest.raises(NotImplementedError):
        RefNMF(RefConfig(k=3, iters=2, dtype="bfloat16",
                         backend="jnp-dense")).fit(a)


@pytest.mark.parametrize("k,bs", [(33, 128), (40, 128), (128, 64)])
def test_fused_half_step_past_k_32_matches_reference(k, bs):
    """``cuda-bsr`` fuses the half-step at these k at tiles ``_fusable``
    admits; its product and Gram within 1e-4 of the reference's fused
    kernel at the same tiles, both orientations."""
    rng = np.random.default_rng(k)
    n, m = 300, 200
    a = _rand_sparse(rng, n, m, density=0.1)
    be = CudaBsrBackend(bs, bs)
    op = be.prepare(a, device="cpu")
    op_ref = ref_bsr.bsr_operand(a, bm=bs, bk=bs)
    v = rng.standard_normal((m, k)).astype(np.float32)
    u = rng.standard_normal((n, k)).astype(np.float32)
    vt, ut = torch.from_numpy(v), torch.from_numpy(u)
    assert be._fusable(op.bsr, vt) and be._fusable(op.bsr_t, ut)
    for (y, g), (y_ref, g_ref) in (
            (be.matmul_with_gram(op, vt),
             ref_fused(op_ref.bsr, jnp.asarray(v), interpret=True)),
            (be.matmul_t_with_gram(op, ut),
             ref_fused(op_ref.bsr_t, jnp.asarray(u), interpret=True))):
        np.testing.assert_allclose(_np(y), _np(y_ref), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(g), _np(g_ref), rtol=1e-4, atol=1e-4)
