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
from repro_torch.kernels.autotune import SMEM_BUDGET, fused_working_set
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_t
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused import bsr_spmm_gram
from repro_torch.kernels.gram import gram
from repro_torch.kernels.project_mask import (
    project_mask, relu_topk, relu_topk_plan,
)
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


def _operand_matrix(case, rng, n, m, bm, bk):
    """A test matrix of shape (n, m) whose BSR form has the case's shape:
    ``random`` elements (padded slots where a row-block has fewer occupied
    blocks), ``block_sparse`` (a third of the (bm, bk) blocks occupied:
    many padded slots), ``long_rows`` (few row-blocks of many slots, so a
    row-block spans several runs, as A^T does at PubMed), ``flags_rb0``
    (row-block 0 dense: every first-occurrence flag in it) and
    ``block_diag`` (bcap = 1, fewer slots than the card has SMs)."""
    if case == "block_sparse":
        a = _rand_sparse(rng, n, m, density=0.2)
        keep = rng.random((-(-n // bm), -(-m // bk))) < 0.33
        return a * np.kron(keep, np.ones((bm, bk), np.float32))[:n, :m]
    if case == "flags_rb0":
        a = _rand_sparse(rng, n, m, density=0.01)
        a[:bm] = rng.random((bm, m)).astype(np.float32)
        return a
    if case == "block_diag":
        a = np.zeros((n, m), np.float32)
        for i in range(0, min(n, m), max(bm, bk)):
            a[i:i + bm, i:i + bk] = rng.random(a[i:i + bm, i:i + bk].shape)
        return a
    return _rand_sparse(rng, n, m)


@pytest.mark.parametrize("case,n,m,k,bm,bk", [
    ("random", 257, 129, 5, 32, 32),
    ("random", 300, 200, 33, 64, 64),
    ("random", 128, 256, 7, 128, 128),
    ("long_rows", 50, 9001, 5, 32, 32),
    ("long_rows", 100, 4000, 32, 64, 64),
    ("flags_rb0", 700, 517, 5, 128, 128),
    ("flags_rb0", 333, 1000, 1, 64, 32),
    ("block_diag", 379, 377, 5, 128, 128),
    ("block_sparse", 1000, 700, 32, 128, 128),
    ("block_sparse", 517, 450, 33, 32, 64),
])
def test_bsr_kernels_match_plain_versions(card, case, n, m, k, bm, bk):
    """Both orientations, under the ingest plan (one run per SM) and under
    a 7-run plan: each kernel within its bar of its plain version (Y 1e-4,
    Gram 1e-5/1e-4), the fused Y bitwise the plain Y, two calls bitwise
    equal, one launch per call."""
    rng = np.random.default_rng(n + m + k)
    a = _operand_matrix(case, rng, n, m, bm, bk)
    op = bsr.bsr_operand(a, bm=bm, bk=bk, device=card)
    if case == "block_diag":
        slots = op.bsr.nrb * op.bsr.bcap
        assert op.bsr.bcap == 1 and slots < bsr.plan_runs(card)
        assert op.bsr.plan.runs == slots
    if case == "long_rows":
        first, last = op.bsr.plan.rb_runs.cpu().numpy().T
        assert (last > first).all()
    if case == "flags_rb0":
        assert int(op.bsr.gram_flags[1:].sum()) == 0
    v, u = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(card) for shape in ((m, k), (n, k)))
    for b0, w in ((op.bsr, v), (op.bsr_t, u)):
        for b in (b0, bsr.replan(b0, 7)):
            _build.reset_launch_counts()
            y = bsr_spmm(b, w)
            torch.testing.assert_close(y, ref.bsr_spmm_ref(b, w), rtol=1e-4,
                                       atol=1e-4)
            assert torch.equal(bsr_spmm(b, w), y)
            if fused_working_set(bm, bk, k) > SMEM_BUDGET:
                # the backend takes the separate launches
                with pytest.raises(ValueError, match="k <="):
                    bsr_spmm_gram(b, w)
                counts = _build.launch_counts()
                assert counts["bsr_spmm"] == 2
                assert counts["bsr_spmm_gram"] == 0
                continue
            y_f, g_f = bsr_spmm_gram(b, w)
            y_f2, g_f2 = bsr_spmm_gram(b, w)
            torch.cuda.synchronize()
            assert torch.equal(y_f, y)
            assert torch.equal(y_f2, y) and torch.equal(g_f2, g_f)
            torch.testing.assert_close(g_f, ref.gram_ref(w), rtol=1e-5,
                                       atol=1e-4)
            torch.testing.assert_close(g_f, ref.bsr_spmm_gram_ref(b, w)[1],
                                       rtol=1e-5, atol=1e-4)
            counts = _build.launch_counts()
            assert counts["bsr_spmm"] == 2 and counts["bsr_spmm_gram"] == 2
            # each block's start and end time, on request
            stamps = torch.zeros((b.plan.runs, 2), dtype=torch.int64,
                                 device=card)
            assert torch.equal(bsr_spmm_gram(b, w, stamps=stamps)[0], y)
            assert bool((stamps[:, 0] > 0).all())
            assert bool((stamps[:, 1] >= stamps[:, 0]).all())
    assert bsr_spmm_t(op, u).shape == (m, k)


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


def _qkv_on_card(card, b, h, hkv, s, t, hd, dtype, strided=False,
                 seed=0):
    """q (B, H, S, hd), k and v (B, Hkv, T, hd) drawn on the card; with
    ``strided`` each is the (B, H, S, hd) view of a (B, S, H, hd) tensor,
    as the model passes its projections."""
    gen = torch.Generator(device=card).manual_seed(seed)
    out = []
    for (bb, hh, ss) in ((b, h, s), (b, hkv, t), (b, hkv, t)):
        if strided:
            x = torch.randn((bb, ss, hh, hd), generator=gen, device=card)
            out.append(x.to(dtype).transpose(1, 2))
        else:
            x = torch.randn((bb, hh, ss, hd), generator=gen, device=card)
            out.append(x.to(dtype))
    return out


@pytest.mark.parametrize("b,h,hkv,s,t,hd,causal,dtype,strided", [
    (2, 4, 4, 128, 128, 32, True, torch.float32, False),
    (1, 8, 2, 192, 320, 64, False, torch.float32, False),
    (1, 8, 2, 1000, 1000, 64, True, torch.bfloat16, False),
    (1, 4, 2, 100, 100, 128, True, torch.float32, False),
    (2, 2, 1, 96, 33, 16, True, torch.bfloat16, False),
    # bf16, the tensor-core kernel: every head size, non-causal, Sq != T,
    # S not a multiple of 128, and the model's strided views
    (2, 4, 2, 200, 200, 16, True, torch.bfloat16, False),
    (1, 4, 4, 333, 333, 32, True, torch.bfloat16, False),
    (1, 8, 2, 260, 260, 128, True, torch.bfloat16, False),
    (1, 8, 2, 192, 320, 64, False, torch.bfloat16, False),
    (2, 4, 1, 300, 130, 32, False, torch.bfloat16, False),
    (1, 4, 2, 70, 450, 128, True, torch.bfloat16, False),
    (1, 4, 2, 450, 70, 64, True, torch.bfloat16, False),
    (2, 8, 2, 513, 513, 64, True, torch.bfloat16, True),
    (1, 6, 2, 257, 257, 128, False, torch.bfloat16, True),
    (2, 4, 4, 129, 129, 16, True, torch.bfloat16, True),
])
def test_flash_kernel_matches_plain_version(card, b, h, hkv, s, t, hd,
                                            causal, dtype, strided):
    """The flash kernel against its plain version on the same card tensors,
    one launch each.  In bf16 both round p to bf16 (against different
    maxima) and then the output: rtol 1e-2, atol 2e-3 against outputs of
    0.02-0.1.  In f32 only the order of the sums differs."""
    q, k, v = _qkv_on_card(card, b, h, hkv, s, t, hd, dtype, strided,
                           seed=s + t + hd)
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


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_bf16_kernel_is_deterministic(card, hd):
    """No atomics and no split over keys: two calls give bitwise the same
    output."""
    q, k, v = _qkv_on_card(card, 2, 8, 2, 700, 700, hd, torch.bfloat16,
                           strided=True, seed=hd)
    first = flash_attention(q, k, v, causal=True, groups=4)
    second = flash_attention(q, k, v, causal=True, groups=4)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("k", [1, 5, 33, 128])
@pytest.mark.parametrize("n", [0, 1, 511, 20112])
def test_gram_kernel_one_launch_repeatable(card, n, k):
    """One launch per call, within rtol 1e-4 / atol 1e-3 of the plain
    version, and bitwise the same from call to call (no float atomics)."""
    u = torch.randn((n, k), generator=torch.Generator().manual_seed(n + k)
                    ).to(card)
    _build.reset_launch_counts()
    first = gram(u)
    assert _build.launch_counts()["gram"] == 1
    second = gram(u)
    torch.cuda.synchronize()
    assert _build.launch_counts()["gram"] == 2
    assert first.shape == (k, k) and first.dtype == torch.float32
    assert torch.equal(first, second)
    torch.testing.assert_close(first, ref.gram_ref(u), rtol=1e-4, atol=1e-3)


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


def _bits(x):
    return x.contiguous().view(torch.int32)


#: (rows, k, t): a small factor, PubMed's U and V, a Wikipedia-shaped U
#: (143,462 x 5), a factor beyond the largest cluster's shared memory that
#: the grid still holds, and one beyond the grid's that it streams
EPILOGUE_SHAPES = [(1001, 5, 150), (20112, 5, 2011), (7510, 5, 751),
                   (143462, 5, 14346), (1_000_000, 2, 40_000),
                   (4_000_000, 8, 640_000)]


@pytest.mark.parametrize("n,k,t", EPILOGUE_SHAPES)
def test_relu_topk_matches_plain_version(card, n, k, t):
    """``relu_topk`` is its plain version bit for bit, ``out`` and
    ``tau``, in one launch per call, and two calls are bitwise equal;
    ``project_mask`` with that ``tau`` too."""
    gen = torch.Generator().manual_seed(n + k)
    x = (torch.randn((n, k), generator=gen) - 0.25).to(card)
    want_out, want_tau = ref.relu_topk_ref(x, t)
    _build.reset_launch_counts()
    out, tau = relu_topk(x, t)
    assert _build.launch_counts()["relu_topk"] == 1
    out2, tau2 = relu_topk(x, t)
    torch.cuda.synchronize()
    assert tau.shape == () and tau.device == x.device
    assert torch.equal(_bits(tau), _bits(want_tau))
    assert torch.equal(_bits(out), _bits(want_out))
    assert torch.equal(_bits(out2), _bits(out))
    assert torch.equal(_bits(tau2), _bits(tau))
    assert torch.equal(_bits(project_mask(x, want_tau)),
                       _bits(ref.project_mask_ref(x, want_tau)))
    assert _build.launch_counts()["project_mask"] == 1


def test_relu_topk_paths_and_cluster_sizes(card):
    """The factor's size picks every cluster size, the grid with the factor
    resident and the grid streaming it; each gives the plain version's
    bits, on a plain and a 4-byte-misaligned view."""
    want = {6_000: (1, "cluster", "resident"),
            12_000: (2, "cluster", "resident"),
            30_000: (4, "cluster", "resident"),
            60_000: (8, "cluster", "resident"),
            100_560: (16, "cluster", "resident")}
    for numel, (blocks, exchange, path) in want.items():
        plan = relu_topk_plan(numel)
        assert (plan["blocks"], plan["exchange"], plan["path"]) == (
            blocks, exchange, path), (numel, plan)
    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    assert relu_topk_plan(2_000_000)["exchange"] == "grid"
    assert relu_topk_plan(2_000_000)["path"] == "resident"
    assert relu_topk_plan(32_000_000)["path"] == "streamed"
    assert relu_topk_plan(32_000_000)["blocks"] == n_sm
    gen = torch.Generator().manual_seed(3)
    for numel in (*want, 2_000_000, 32_000_000 + 3):
        x = torch.randn(numel + 1, generator=gen).to(card)
        for view in (x[:numel], x[1:]):
            t = numel // 10
            want_out, want_tau = ref.relu_topk_ref(view, t)
            out, tau = relu_topk(view, t)
            assert torch.equal(_bits(tau), _bits(want_tau)), numel
            assert torch.equal(_bits(out), _bits(want_out)), numel


@pytest.mark.parametrize("case", ["nan", "all_negative", "all_zero", "ties",
                                  "misaligned", "t1", "numel_minus_1",
                                  "steps0", "tiny", "nan_grid"])
def test_relu_topk_edge_cases_on_card(card, case):
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((3001, 5), generator=gen)
    t, steps = 400, 40
    if case == "nan":
        x[17, 3] = float("nan")
    elif case == "all_negative":
        x = -x.abs() - 1e-3
    elif case == "all_zero":
        x = torch.zeros_like(x)
    elif case == "ties":
        x = torch.randint(0, 3, x.shape, generator=gen).float() * 0.5
    elif case == "t1":
        t = 1
    elif case == "numel_minus_1":
        t = x.numel() - 1
    elif case == "steps0":
        steps = 0
    elif case == "tiny":
        x, t = x[:1, :3].contiguous(), 1
    elif case == "nan_grid":  # on the grid exchange
        x = torch.randn((500_000, 4), generator=gen)
        x[123_456, 1] = float("nan")
        t = 50_000
    x = x.to(card)
    if case == "misaligned":  # 4 bytes past a 16-byte boundary
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].reshape(x.shape)
        assert x.data_ptr() % 16 == 4
    want_out, want_tau = ref.relu_topk_ref(x, t, steps)
    out, tau = relu_topk(x, t, steps)
    assert torch.equal(_bits(tau), _bits(want_tau))
    assert torch.equal(_bits(out), _bits(want_out))
    if case == "nan_grid":
        assert relu_topk_plan(x.numel())["exchange"] == "grid"


def test_relu_topk_makes_no_host_sync(card):
    from repro_torch.core.topk import FusedReluTopK

    for n in (20112, 1_000_000):  # the cluster and the grid exchange
        x = torch.randn((n, 5), generator=torch.Generator().manual_seed(5)
                        ).to(card)
        relu_topk(x, 2011)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, tau = relu_topk(x, 2011)
            fused = FusedReluTopK(t=2011)(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert _build.launch_counts()["relu_topk"] == 2
        assert torch.equal(fused, out)


@pytest.mark.parametrize("k", [224, 225, 256, 512])
@pytest.mark.parametrize("n", [1, 3001, 20112])
def test_gram_kernel_tiled_matches_matmul(card, n, k):
    """Past one tile (k > 224) the output is tiled: one launch a call,
    within the Gram's bar of ``u.T @ u`` (TF32 off) and of the plain
    version, bitwise repeatable and bitwise symmetric."""
    u = torch.randn((n, k), generator=torch.Generator().manual_seed(n + k)
                    ).to(card)
    _build.reset_launch_counts()
    first = gram(u)
    second = gram(u)
    torch.cuda.synchronize()
    assert _build.launch_counts()["gram"] == 2
    assert torch.equal(first, second) and torch.equal(first, first.T)
    torch.testing.assert_close(first, u.T @ u, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(first, ref.gram_ref(u), rtol=1e-4, atol=1e-3)


def test_bsr_products_at_k_256(card):
    """k = 256 streams the tiles once per 8-column ring chunk; both
    orientations within 1e-4 of their plain versions."""
    rng = np.random.default_rng(256)
    a = _rand_sparse(rng, 700, 500, density=0.05)
    op = bsr.bsr_operand(a, bm=128, bk=128, device=card)
    v, u = (torch.from_numpy(rng.random(shape).astype(np.float32)).to(card)
            for shape in ((500, 256), (700, 256)))
    torch.testing.assert_close(bsr_spmm(op.bsr, v), ref.bsr_spmm_ref(op.bsr, v),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(bsr_spmm_t(op, u),
                               ref.bsr_spmm_ref(op.bsr_t, u),
                               rtol=1e-4, atol=1e-4)


def _small_corpus():
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.sparse import to_scipy

    a, _ = synthetic_journal_corpus(n_terms=600, n_docs=400, seed=3)
    return to_scipy(a)


def test_fit_at_k_256_on_card_matches_cpu(card):
    """The unfused half-steps (``bsr_spmm`` + the tiled ``gram``) and
    ``relu_topk`` at k = 256, against the same fit on the CPU, 2% of each
    factor kept.  With a few hundred documents a rank-256 fit is
    ill-conditioned (backends differ by far more than 1e-4 on the CPU
    alone), so the corpus has 1,000."""
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.sparse import to_scipy

    a, _ = synthetic_journal_corpus(n_terms=2000, n_docs=1000, seed=0)
    sp = to_scipy(a)
    u0 = np.random.default_rng(0).random((2000, 256)).astype(np.float32)
    cfg = NMFConfig(k=256, iters=3, backend="cuda-bsr",
                    sparsity=Sparsity(t_u=2000 * 256 // 50,
                                      t_v=1000 * 256 // 50))
    _build.reset_launch_counts()
    on_card = EnforcedNMF(cfg, device=card).fit(sp, u0=u0)
    counts = _build.launch_counts()
    assert counts["gram"] >= 6 and counts["bsr_spmm"] >= 6
    assert counts["relu_topk"] == 6 and counts["bsr_spmm_gram"] == 0
    on_cpu = EnforcedNMF(cfg, device="cpu").fit(sp, u0=u0)
    torch.testing.assert_close(on_card.result_.error.cpu(),
                               on_cpu.result_.error, rtol=0, atol=1e-4)
    assert int(on_card.result_.health) == -1


def test_streamed_fit_on_card_matches_cpu(card, tmp_path):
    """A streamed ``cuda-bsr`` fit (side-stream copies from pinned memory,
    a worker thread packing ahead) against the CPU run within 1e-4;
    prefetch on and off, and a corpus directory, bitwise equal on the
    card."""
    from repro_torch.data import write_corpus

    sp = _small_corpus()
    u0 = np.random.default_rng(1).random((600, 5)).astype(np.float32)
    cfg = NMFConfig(k=5, iters=6, solver="streaming", chunk_docs=70,
                    backend="cuda-bsr", sparsity=Sparsity(t_u=60, t_v=400))
    _build.reset_launch_counts()
    on = EnforcedNMF(cfg, device=card).fit(sp, u0=u0)
    counts = _build.launch_counts()
    chunks = -(-400 // 70)
    # two fused half-steps and two epilogues per inner pass; one bsr_spmm
    # per chunk for the fold-in and one for the statistics' seed
    # 2 x 6 passes a chunk, and the fold-in's epilogue
    assert counts["bsr_spmm_gram"] == 2 * 6 * chunks
    assert counts["relu_topk"] == 2 * 6 * chunks + 1
    assert counts["bsr_spmm"] == 2 * chunks
    off = EnforcedNMF(cfg.replace(prefetch=False), device=card).fit(sp, u0=u0)
    disk = EnforcedNMF(cfg, device=card).fit(
        write_corpus(sp, tmp_path / "c", chunk_docs=70), u0=u0)
    for other in (off, disk):
        assert torch.equal(on.u_, other.u_) and torch.equal(on.v_, other.v_)
        assert torch.equal(on.result_.error, other.result_.error)
    cpu = EnforcedNMF(cfg, device="cpu").fit(sp, u0=u0)
    torch.testing.assert_close(on.result_.error.cpu(), cpu.result_.error,
                               rtol=0, atol=1e-4)
    # U is not normalized: its bar is relative to its largest entry
    assert float((on.u_.cpu() - cpu.u_).abs().max()
                 / cpu.u_.abs().max()) <= 1e-4
    assert torch.equal(on.result_.nnz_v.cpu(), cpu.result_.nnz_v)


@pytest.mark.parametrize("backend", ["cuda-bsr", "torch-csr"])
def test_online_step_makes_no_host_sync(card, backend):
    from repro_torch.backend import get_backend
    from repro_torch.core.online import init_online_stats, online_als_step

    sp = _small_corpus()
    op = get_backend(backend).prepare(sp[:, :100].tocsr(), device=card)
    u = torch.rand((600, 5), generator=torch.Generator().manual_seed(2)
                   ).to(card)
    be = get_backend(backend)
    sparsity = Sparsity(t_u=60, t_v=100)
    kw = dict(iters=3, backend=backend,
              sparsify_u=sparsity.sparsifier(600, 5, "u", be.fuse_epilogue),
              sparsify_v=sparsity.sparsifier(100, 5, "v", be.fuse_epilogue))
    stats = init_online_stats(600, 5, device=card)
    online_als_step(op, u, stats, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = online_als_step(op, u, stats, 0.9, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(res.health) == -1


class _Killed(Exception):
    """In-process stand-in for a hard kill at a checkpoint commit."""


@pytest.mark.parametrize("solver", ["enforced", "streaming"])
def test_killed_and_resumed_cuda_bsr_fit_is_bitwise(card, tmp_path, solver):
    """Every kernel of the ``cuda-bsr`` path is deterministic and a snapshot
    is an exact copy, so a fit killed at a snapshot and resumed is the
    uninterrupted fit bit for bit (U, V, the traces), batch and streamed."""
    from repro_torch.robustness import faults

    sp = _small_corpus()
    u0 = np.random.default_rng(5).random((600, 5)).astype(np.float32)
    cfg = NMFConfig(k=5, iters=12, backend="cuda-bsr", solver=solver,
                    sparsity=Sparsity(t_u=60, t_v=100), chunk_docs=100,
                    checkpoint_dir=str(tmp_path), checkpoint_every=4
                    if solver == "enforced" else 2)
    full = EnforcedNMF(cfg.replace(checkpoint_dir=None),
                       device=card).fit(sp, u0=u0)
    key = 8 if solver == "enforced" else 2
    with faults.inject("kill", key=key, exc=_Killed):
        with pytest.raises(_Killed):
            EnforcedNMF(cfg, device=card).fit(sp, u0=u0)
    _build.reset_launch_counts()
    res = EnforcedNMF(cfg, device=card).fit(sp, u0=u0, resume=True)
    counts = _build.launch_counts()
    for a, b in ((full.u_, res.u_), (full.v_, res.v_),
                 (full.result_.residual, res.result_.residual),
                 (full.result_.error, res.result_.error)):
        assert torch.equal(a, b)
    assert res.result_.n_iter == full.result_.n_iter
    if solver == "enforced":   # 4 iterations left, and the statistics' seed
        assert counts["bsr_spmm_gram"] == 9 and counts["relu_topk"] == 8


def test_poisoned_cuda_bsr_fit_rolls_back_on_card(card, tmp_path):
    """NaN through the fused product + Gram, the Cholesky solve and
    ``relu_topk``: the health index comes back set (no barrier traps) and
    the fit rolls back to finite factors; under ``"raise"`` it raises."""
    from repro_torch.robustness import FitHealthError, faults

    sp = _small_corpus()
    u0 = np.random.default_rng(6).random((600, 5)).astype(np.float32)
    cfg = NMFConfig(k=5, iters=12, backend="cuda-bsr",
                    sparsity=Sparsity(t_u=60, t_v=100),
                    checkpoint_dir=str(tmp_path), checkpoint_every=4)
    with faults.inject("poison-step", key=4):
        with pytest.warns(RuntimeWarning, match="at iteration 4; rolling"):
            model = EnforcedNMF(cfg, device=card).fit(sp, u0=u0)
    assert bool(torch.isfinite(model.u_).all()) and model.n_iter_ == 12
    assert int(model.result_.health) == -1
    with faults.inject("poison-step", key=0):
        with pytest.raises(FitHealthError, match="iteration 0"):
            EnforcedNMF(cfg.replace(on_unhealthy="raise",
                                    checkpoint_dir=None),
                        device=card).fit(sp, u0=u0)


def test_mesh_fits_on_card_match_cpu(card, tmp_path):
    """The mesh engine on the card: 2x2 as four gloo ranks sharing it (gloo
    stages the CUDA tensors through the host) and 1x1 under NCCL.  Every
    rank launches ``bsr_spmm_gram`` 2 * iters + 1 times and no
    ``relu_topk`` (``DistTopK`` masks with a ``where``); the traces agree
    with the same 2x2 grid on the CPU within 1e-4, U within 1e-4 relative,
    and the ranks return the same whole U."""
    import sys
    from pathlib import Path

    from repro_torch.launch.mesh import spawn_mesh

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _torch_mesh_ranks as ranks

    a = _small_corpus().toarray().astype(np.float32)
    data = tmp_path / "data.npz"
    np.savez(data, a=a,
             u0=np.random.default_rng(1).random((600, 5)).astype(np.float32))
    iters = 6
    case = lambda shape: [("fit", dict(
        k=5, iters=iters, solver="distributed", mesh_shape=shape,
        backend="cuda-bsr", sparsity=dict(t_u=60, t_v=400)), "scipy")]
    run = lambda shape, backend, device, name: spawn_mesh(
        ranks.fit_cases, *shape, backend=backend, device=device,
        init_file=str(tmp_path / name), timeout=300.0,
        args=(str(data), case(shape), device))
    on_card = run((2, 2), "gloo", "cuda:0", "card")
    on_cpu = run((2, 2), "gloo", "cpu", "cpu")
    (nccl,) = run((1, 1), "nccl", "cuda:0", "nccl")
    want = on_cpu[0]["fit"]
    for rec in [r["fit"] for r in on_card] + [nccl["fit"]]:
        assert rec["launches"]["bsr_spmm_gram"] == 2 * iters + 1
        assert rec["launches"]["relu_topk"] == 0
        np.testing.assert_allclose(rec["err"], want["err"], atol=1e-4)
        np.testing.assert_allclose(rec["res"], want["res"], atol=1e-4)
        rel = np.linalg.norm(rec["u"] - want["u"]) / np.linalg.norm(want["u"])
        assert rel < 1e-4
    for r in on_card:
        np.testing.assert_array_equal(r["fit"]["u"], on_card[0]["fit"]["u"])
        assert r["fit"]["collectives"]["all_reduce"] > 0


# ---------------------------------------------------------------------------
# Column chunks, bf16 and the fused half-step past k = 32
# ---------------------------------------------------------------------------

def _bf16_bar(got, want_f32):
    """The reference's bf16 bar against f32 math (``tests/test_kernels.py``:
    rtol 5e-2, atol 1e-1)."""
    torch.testing.assert_close(got.float(), want_f32, rtol=5e-2, atol=1e-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,n,m,k,bm,bk", [
    ("random", 257, 129, 5, 32, 32),
    ("random", 300, 200, 40, 64, 64),
    ("long_rows", 100, 4000, 33, 64, 64),
    ("flags_rb0", 700, 517, 70, 128, 128),
    ("block_sparse", 517, 450, 128, 128, 64),
    ("block_sparse", 1000, 700, 100, 64, 32),
])
def test_bsr_chunks_and_bf16_match_plain_versions(card, dtype, case, n, m,
                                                  k, bm, bk):
    """Every column chunk, in f32 and bf16, both orientations: the product
    within its bar of the plain version (f32 1e-4; bf16 the reference's bar
    against f32 math on the same bf16 values), in the factor's dtype; the
    fused product bitwise the plain one at the same ``kb``; the Gram f32
    within 1e-5 / 1e-4 of the plain one; one launch a call."""
    from repro_torch.kernels.autotune import KB_WIDTHS

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(n + m + k)
    a = _operand_matrix(case, rng, n, m, bm, bk)
    op = bsr.bsr_operand(a, bm=bm, bk=bk, dtype=dt, device=card)
    assert op.bsr.tiles.dtype == dt and op.bsr_t.tiles.dtype == dt
    v, u = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(card, dt) for shape in ((m, k), (n, k)))
    for b, w in ((op.bsr, v), (op.bsr_t, u)):
        # A^T's tiles are (bk, bm): the fused kernel's gate is per orientation
        ws = fused_working_set(b.bm, b.bk, k, w.element_size())
        fuses = ws <= SMEM_BUDGET
        want = ref.bsr_spmm_ref(dataclasses_replace_tiles(b), w.float())
        for kb in KB_WIDTHS:
            _build.reset_launch_counts()
            y = bsr_spmm(b, w, kb=kb)
            assert y.dtype == dt and _build.launch_counts()["bsr_spmm"] == 1
            assert torch.equal(bsr_spmm(b, w, kb=kb), y)
            if dt == torch.float32:
                torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
            else:
                _bf16_bar(y, want)
            if not fuses:
                continue
            y_f, g_f = bsr_spmm_gram(b, w, kb=kb)
            assert _build.launch_counts()["bsr_spmm_gram"] == 1
            assert g_f.dtype == torch.float32
            assert torch.equal(y_f.view(torch.int16 if dt == torch.bfloat16
                                        else torch.int32),
                               y.view(torch.int16 if dt == torch.bfloat16
                                      else torch.int32))
            torch.testing.assert_close(g_f, ref.gram_ref(w), rtol=1e-5,
                                       atol=1e-4)


def dataclasses_replace_tiles(b):
    """``b`` with f32 tiles (the f32 math the bf16 bar is held against)."""
    import dataclasses

    return dataclasses.replace(b, tiles=b.tiles.float())


@pytest.mark.parametrize("k,bm,bk", [(33, 128, 128), (40, 128, 128),
                                     (128, 64, 64)])
def test_cuda_bsr_fuses_past_k_32(card, k, bm, bk, tmp_path, monkeypatch):
    """``cuda-bsr`` at the tiles its ledger gives (a temporary ledger entry
    for the corpus's shape) takes the fused kernel at these k: one
    ``bsr_spmm_gram`` launch a half-step, no ``gram``, the product bitwise
    the unfused one's; a 3-iteration fit within 1e-4 of
    ``cuda-bsr-unfused``."""
    from repro_torch.backend import get_backend
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.kernels import autotune as at
    from repro_torch.sparse import to_scipy

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_LEDGER",
                       str(tmp_path / "ledger.json"))
    at._CACHE.clear()
    at.update_ledger(f"{at.device_kind(card)}/"
                     f"{at.shape_bucket(2000, 1000, None)}",
                     {"bm": bm, "bk": bk, "kb": 8, "source": "test"})
    a, _ = synthetic_journal_corpus(n_terms=2000, n_docs=1000, seed=0)
    sp = to_scipy(a)
    fused, unfused = get_backend("cuda-bsr"), get_backend("cuda-bsr-unfused")
    op = fused.prepare(sp, device=card)
    assert (op.bsr.bm, op.bsr.bk) == (bm, bk)
    v = torch.rand((1000, k), device=card)
    _build.reset_launch_counts()
    y, g = fused.matmul_with_gram(op, v)
    counts = _build.launch_counts()
    assert counts["bsr_spmm_gram"] == 1 and counts["gram"] == 0
    y_u, g_u = unfused.matmul_with_gram(op, v)
    assert torch.equal(y, y_u)
    torch.testing.assert_close(g, g_u, rtol=1e-5, atol=1e-4)
    u0 = np.random.default_rng(0).random((2000, k)).astype(np.float32)
    sparsity = Sparsity(t_u=2000 * k // 10, t_v=1000 * k // 10)
    fits = {}
    for name in ("cuda-bsr", "cuda-bsr-unfused"):
        _build.reset_launch_counts()
        fits[name] = EnforcedNMF(
            NMFConfig(k=k, iters=3, backend=name, sparsity=sparsity),
            device=card).fit(sp, u0=u0)
        fused_launches = _build.launch_counts()["bsr_spmm_gram"]
        assert fused_launches == (7 if name == "cuda-bsr" else 0)
    torch.testing.assert_close(fits["cuda-bsr"].result_.error,
                               fits["cuda-bsr-unfused"].result_.error,
                               rtol=0, atol=1e-4)
    at._CACHE.clear()


@pytest.mark.parametrize("k", [5, 40, 256, 300])
@pytest.mark.parametrize("n", [1, 3001, 20112])
def test_gram_kernel_bf16_matches_plain_version(card, n, k):
    """bf16 in, f32 out, both paths (one tile up to k = 224, tiles above):
    within 1e-4 / 1e-3 of the plain version on the widened values (f32
    sums of exact products), bitwise repeatable, one launch."""
    gen = torch.Generator().manual_seed(n + k)
    u = torch.randn((n, k), generator=gen).to(card, torch.bfloat16)
    _build.reset_launch_counts()
    g = gram(u)
    assert g.dtype == torch.float32 and _build.launch_counts()["gram"] == 1
    assert torch.equal(gram(u), g)
    torch.testing.assert_close(g, ref.gram_ref(u), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n,k,t", EPILOGUE_SHAPES)
def test_relu_topk_bf16_matches_plain_version(card, n, k, t):
    """bf16 ``relu_topk``: ``tau`` (bisected in f32, rounded to bf16) and
    ``out`` bitwise the plain version's, on both exchanges and paths;
    ``project_mask`` with that ``tau`` bitwise too."""
    gen = torch.Generator().manual_seed(n + k)
    x = (torch.randn((n, k), generator=gen) - 0.25).to(card, torch.bfloat16)
    want_out, want_tau = ref.relu_topk_ref(x, t)
    _build.reset_launch_counts()
    out, tau = relu_topk(x, t)
    assert _build.launch_counts()["relu_topk"] == 1
    assert out.dtype == torch.bfloat16 and tau.dtype == torch.bfloat16
    assert torch.equal(tau.view(torch.int16), want_tau.view(torch.int16))
    assert torch.equal(out.view(torch.int16), want_out.view(torch.int16))
    for t_given in (want_tau, want_tau.float()):
        assert torch.equal(project_mask(x, t_given).view(torch.int16),
                           ref.project_mask_ref(x, t_given).view(torch.int16))
    # a misaligned view reads one entry at a time
    view = x.reshape(-1)[1:]
    o2, t2 = relu_topk(view, t)
    w2, wt2 = ref.relu_topk_ref(view, t)
    assert torch.equal(t2.view(torch.int16), wt2.view(torch.int16))
    assert torch.equal(o2.view(torch.int16), w2.view(torch.int16))


def test_autotune_on_card_records_and_resolves_the_winner(card, tmp_path,
                                                          monkeypatch):
    """A small sweep on the card into a temporary ledger: every candidate
    timed, the winner the least half-step time, and ``resolve_tiles`` and
    ``bsr_spmm(kb=None)`` return it."""
    from repro_torch.kernels import autotune as at

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_LEDGER",
                       str(tmp_path / "ledger.json"))
    at._CACHE.clear()
    entry = at.autotune(600, 400, 40, density=0.05, repeats=2)
    assert entry["source"] == "autotune"
    recs = entry["candidates"]
    assert len(recs) == len(at.legal_candidates(600, 400, 40))
    assert min(r["score_us"] for r in recs) == min(
        r["fused_us"] for r in recs)
    kind = at.device_kind(card)
    key = f"{kind}/{at.shape_bucket(600, 400, 40)}"
    at.update_ledger(key, entry)
    tiles = at.resolve_tiles(600, 400, 40, device=kind)
    assert (tiles.bm, tiles.bk, tiles.kb) == (entry["bm"], entry["bk"],
                                              entry["kb"])
    at._CACHE.clear()
