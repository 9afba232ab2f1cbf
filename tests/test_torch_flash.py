"""Port parity for the flash-attention module: the reference's Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it) against the port's
wrapper, which runs its plain version (``kernels.ref.flash_attention_ref``)
on CPU tensors.

In f32 the tolerance is the reference's own, rtol/atol 2e-3
(``tests/test_kernels.py:211``).  In bf16 it is tighter than the
reference's 5e-2 (``:224``), which is a third of a typical output here:
rtol 1e-2 and atol 2e-3 allow one bf16 step of the output plus the
difference of rounding p against the running max or the row's final max.
Inputs are made with numpy and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import check_operands, flash_attention


def _qkv(seed, b, h, hkv, s, t, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, hd)).astype(np.float32),
            rng.standard_normal((b, hkv, t, hd)).astype(np.float32),
            rng.standard_normal((b, hkv, t, hd)).astype(np.float32))


def _both(q, k, v, causal, groups, dtype=np.float32, bq=64, bk=64):
    want = ref_flash(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                     jnp.asarray(v, dtype), causal=causal, bq=bq, bk=bk,
                     groups=groups, interpret=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = flash_attention(torch.from_numpy(q).to(tdt),
                          torch.from_numpy(k).to(tdt),
                          torch.from_numpy(v).to(tdt), causal=causal,
                          groups=groups)
    return got.float().numpy(), np.asarray(want, dtype=np.float32)


# the shape cases of tests/test_kernels.py:195-200
@pytest.mark.parametrize("b,h,hkv,s,t,hd,causal", [
    (2, 4, 4, 128, 128, 32, True),
    (1, 8, 2, 256, 256, 64, True),
    (2, 4, 2, 64, 192, 32, False),
    (1, 2, 1, 96, 96, 16, True),
])
def test_flash_matches_reference(b, h, hkv, s, t, hd, causal):
    q, k, v = _qkv(b + s, b, h, hkv, s, t, hd)
    got, want = _both(q, k, v, causal, h // hkv)
    assert got.shape == (b, h, s, hd)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_flash_bf16_matches_reference():
    q, k, v = _qkv(9, 1, 2, 2, 128, 128, 32)
    got, want = _both(q, k, v, True, 1, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("b,h,hkv,s,t,hd", [
    (1, 4, 1, 64, 192, 32),      # Sq < T: top-left aligned, not bottom-right
    (2, 2, 2, 128, 64, 16),      # Sq > T: rows past T see every key
    (1, 4, 2, 48, 48, 128),      # hd 128, one block smaller than 64
])
def test_causal_mask_is_absolute_indices(b, h, hkv, s, t, hd):
    q, k, v = _qkv(s * t, b, h, hkv, s, t, hd)
    got, want = _both(q, k, v, True, h // hkv, bq=16, bk=16)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_gqa_reads_kv_head_h_div_groups():
    """Query head h reads KV head h // groups: zeroing KV head 1's values
    zeroes exactly query heads 2 and 3 (groups 2)."""
    q, k, v = _qkv(5, 1, 4, 2, 32, 32, 16)
    v[:, 1] = 0.0
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), groups=2)
    assert torch.count_nonzero(out[:, 2:]) == 0
    assert bool((out[:, :2].abs() > 0).any())


def test_plain_version_chunking_does_not_change_rows(monkeypatch):
    q, k, v = _qkv(3, 1, 4, 2, 200, 200, 32)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    whole = ref.flash_attention_ref(*args, causal=True, groups=2)
    monkeypatch.setattr(ref, "_FLASH_REF_ROWS", 7)
    pieces = ref.flash_attention_ref(*args, causal=True, groups=2)
    torch.testing.assert_close(pieces, whole, rtol=1e-6, atol=1e-6)


def test_p_is_rounded_to_v_dtype_before_pv():
    """In bf16 the unnormalised probabilities are rounded to bf16 before
    P @ V, while l sums them unrounded: the plain version matches a
    by-hand computation of exactly that."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(11, 1, 1, 1, 16, 16, 16))
    s = (q.float() @ k.float().transpose(-1, -2)) * 16 ** -0.5
    s = s.masked_fill(torch.ones(16, 16, dtype=torch.bool).triu(1), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = ((p.to(torch.bfloat16).float() @ v.float())
            / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    assert torch.equal(ref.flash_attention_ref(q, k, v), want)


def test_cpu_wrapper_counts_no_launch():
    _build.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 2, 1, 16, 16, 16))
    flash_attention(q, k, v, groups=2)
    assert _build.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("case,exc", [
    ("head size", ValueError), ("groups", ValueError),
    ("dtype", TypeError), ("stride", ValueError), ("batch", ValueError),
])
def test_check_operands_refuses_what_the_kernel_cannot_take(case, exc):
    q = torch.zeros((2, 4, 8, 64))
    k = torch.zeros((2, 2, 8, 64))
    v = k.clone()
    groups = 2
    if case == "head size":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    elif case == "groups":
        groups = 3
    elif case == "dtype":
        q = q.half()
    elif case == "stride":
        q = torch.zeros((2, 4, 64, 8)).transpose(2, 3)
    elif case == "batch":
        k, v = k[:1], v[:1]
    with pytest.raises(exc):
        check_operands(q, k, v, groups)
    check_operands(torch.zeros((2, 4, 8, 64)), torch.zeros((2, 2, 8, 64)),
                   torch.zeros((2, 2, 8, 64)), 2)


def _bf16_operands():
    return (torch.zeros((2, 4, 8, 64), dtype=torch.bfloat16),
            torch.zeros((2, 2, 8, 64), dtype=torch.bfloat16),
            torch.zeros((2, 2, 8, 64), dtype=torch.bfloat16))


@pytest.mark.parametrize("operand", [0, 1, 2])
def test_check_operands_refuses_misaligned_bf16_base_pointer(operand):
    """The bf16 kernel's TMA copies need each base pointer 16-byte
    aligned: a view two bytes into its storage is refused."""
    ops = list(_bf16_operands())
    shape = ops[operand].shape
    flat = torch.zeros(ops[operand].numel() + 1, dtype=torch.bfloat16)
    ops[operand] = flat[1:].view(shape)
    assert ops[operand].data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_operands(*ops, 2)


@pytest.mark.parametrize("operand", [0, 1, 2])
def test_check_operands_refuses_bf16_row_stride_off_16_bytes(operand):
    """A row stride of 68 bf16 values (136 bytes) is not a multiple of 16
    bytes, which TMA needs; 72 values (144 bytes) is taken."""
    for width, ok in ((68, False), (72, True)):
        ops = list(_bf16_operands())
        b, h, s, hd = ops[operand].shape
        ops[operand] = torch.zeros((b, h, s, width),
                                   dtype=torch.bfloat16)[..., :hd]
        if ok:
            check_operands(*ops, 2)
        else:
            with pytest.raises(ValueError, match="multiples of 16"):
                check_operands(*ops, 2)


def test_check_operands_takes_strided_views_of_the_model():
    """The model's (B, S, H, hd) projections, transposed to (B, H, S, hd)
    without a copy, meet TMA's alignment in bf16 and f32 alike."""
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros((2, 8, 4, 64), dtype=dtype).transpose(1, 2)
        kv = torch.zeros((2, 8, 2, 64), dtype=dtype).transpose(1, 2)
        check_operands(q, kv, kv, 2)


def test_check_operands_leaves_f32_strides_to_the_cuda_core_kernel():
    """f32 runs on the CUDA-core kernel, which reads any row stride."""
    q = torch.zeros((2, 4, 8, 68))[..., :64]
    kv = torch.zeros((2, 2, 8, 64))
    check_operands(q, kv, kv, 2)
