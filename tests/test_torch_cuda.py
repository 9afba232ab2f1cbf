"""The port's kernels on the card against their plain versions, at small
shapes.  Marked ``cuda``: they skip where no CUDA device is visible and run
on a machine with an NVIDIA card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build, bsr, ref
from repro_torch.kernels.autotune import FUSED_MAX_K
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_t
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused import bsr_spmm_gram
from repro_torch.kernels.gram import gram
from repro_torch.kernels.project_mask import project_mask
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: no CUDA device is visible")
    return resolve_device("cuda")


def _rand_sparse(rng, n, m, density=0.05):
    a = rng.random((n, m)).astype(np.float32)
    a[rng.random((n, m)) > density] = 0
    return a


@pytest.mark.parametrize("n,m,k,bm", [(257, 129, 5, 32), (300, 200, 33, 64),
                                      (128, 256, 7, 128)])
def test_bsr_kernels_match_plain_versions(card, n, m, k, bm):
    rng = np.random.default_rng(n + m + k)
    a = _rand_sparse(rng, n, m)
    op = bsr.bsr_operand(a, bm=bm, bk=bm, device=card)
    v = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(card)
    u = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(card)
    _build.reset_launch_counts()
    y = bsr_spmm(op.bsr, v)
    torch.testing.assert_close(y, ref.bsr_spmm_ref(op.bsr, v), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(bsr_spmm_t(op, u),
                               ref.bsr_spmm_ref(op.bsr_t, u), rtol=1e-4,
                               atol=1e-4)
    if k > FUSED_MAX_K:   # the backend takes the separate launches there
        with pytest.raises(ValueError, match="k <="):
            bsr_spmm_gram(op.bsr, v)
        assert _build.launch_counts()["bsr_spmm_gram"] == 0
        return
    y_f, g_f = bsr_spmm_gram(op.bsr, v)
    torch.cuda.synchronize()
    assert torch.equal(y_f, y)
    torch.testing.assert_close(g_f, ref.gram_ref(v), rtol=1e-5, atol=1e-4)
    counts = _build.launch_counts()
    assert counts["bsr_spmm"] == 2 and counts["bsr_spmm_gram"] == 1


def test_gram_and_mask_match_plain_versions(card):
    gen = torch.Generator().manual_seed(0)
    for n, k in ((513, 40), (64, 5), (20112, 5)):
        u = torch.randn((n, k), generator=gen).to(card)
        torch.testing.assert_close(gram(u), ref.gram_ref(u), rtol=1e-4,
                                   atol=1e-3)
    x = torch.randn((1001, 5), generator=gen).to(card)
    for tau in (0.0, 0.5, 2.0):
        t = torch.tensor(tau, device=card)
        assert torch.equal(project_mask(x, t), ref.project_mask_ref(x, t))


def test_fused_unreferenced_blocks_on_card(card):
    rng = np.random.default_rng(4)
    a = np.zeros((128, 256), np.float32)
    a[:64, :64] = rng.random((64, 64))
    b = bsr.bsr_from_dense(a, bm=64, bk=64, device=card)
    u = torch.from_numpy(rng.standard_normal((256, 7)).astype(np.float32)).to(card)
    y, g = bsr_spmm_gram(b, u)
    torch.testing.assert_close(g, ref.gram_ref(u), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(y, ref.bsr_spmm_ref(b, u), rtol=1e-5,
                               atol=1e-5)


def test_fit_on_card_matches_cpu(card):
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.sparse import to_scipy

    a, _ = synthetic_journal_corpus(n_terms=300, n_docs=200, seed=1)
    sp = to_scipy(a)
    u0 = np.random.default_rng(0).random((300, 5)).astype(np.float32)
    cfg = NMFConfig(k=5, iters=8, sparsity=Sparsity(t_u=55, t_v=600),
                    backend="cuda-bsr")
    on_card = EnforcedNMF(cfg, device=card).fit(sp, u0=u0)
    on_cpu = EnforcedNMF(cfg, device="cpu").fit(sp, u0=u0)
    torch.testing.assert_close(on_card.result_.error.cpu(),
                               on_cpu.result_.error, rtol=0, atol=1e-4)
    assert torch.equal(on_card.result_.nnz_u.cpu(), on_cpu.result_.nnz_u)
    assert int(on_card.result_.health) == -1


@pytest.mark.parametrize("b,h,hkv,s,t,hd,causal,dtype", [
    (2, 4, 4, 128, 128, 32, True, torch.float32),
    (1, 8, 2, 192, 320, 64, False, torch.float32),
    (1, 8, 2, 1000, 1000, 64, True, torch.bfloat16),
    (1, 4, 2, 100, 100, 128, True, torch.float32),
    (2, 2, 1, 96, 33, 16, True, torch.bfloat16),
])
def test_flash_kernel_matches_plain_version(card, b, h, hkv, s, t, hd,
                                            causal, dtype):
    """The flash kernel against its plain version on the same card tensors,
    one launch each.  In bf16 both round p to bf16 (against different
    maxima) and then the output: rtol 1e-2, atol 2e-3 against outputs of
    0.02-0.1.  In f32 only the order of the sums differs."""
    gen = torch.Generator(device=card).manual_seed(s + t + hd)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((b, h, s, hd), (b, hkv, t, hd), (b, hkv, t, hd)))
    _build.reset_launch_counts()
    out = flash_attention(q, k, v, causal=causal, groups=h // hkv)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_attention"] == 1
    assert out.shape == q.shape and out.dtype == dtype
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (1e-2, 2e-3)
    torch.testing.assert_close(
        out.float(), ref.flash_attention_ref(q, k, v, causal=causal,
                                             groups=h // hkv).float(),
        rtol=rtol, atol=atol)


def test_prefill_on_card_matches_cpu(card):
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import api

    cfg = smoke_config(ARCHS["llama3.2-1b"])
    model = api.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 96),
                           generator=torch.Generator().manual_seed(1))
    step = api.make_prefill_step(cfg)
    on_cpu = step(model, {"tokens": tokens})
    _build.reset_launch_counts()
    on_card = step(model.to(card), {"tokens": tokens.to(card)})
    assert _build.launch_counts()["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=5e-2, atol=1e-1)
