"""The CUDA BSR kernels' split of the slot stream, on the CPU: the plan fixed
at ingest (``kernels/bsr.py::split_plan``), the plain per-run partial
products it implies, the shared-memory gate of the fused half-step, and
what the kernels' wrapper refuses.

The product bar is 1e-6: the per-run partials of the plain version summed
in run order against the unsplit plain product, both in f64 on the CPU (the
test is of the split's coverage, not of f32 rounding)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.backend.cuda_bsr import CudaBsrBackend
from repro_torch.data import synthetic_journal_corpus
from repro_torch.kernels import bsr, ref
from repro_torch.kernels.autotune import (
    SMEM_BUDGET, fused_max_k, fused_working_set, ring_stage_bytes,
)
from repro_torch.kernels.bsr_spmm import check_operands
from repro_torch.sparse import to_scipy


def _check_plan(nrb, bcap, runs, bounds, rb_runs):
    total = nrb * bcap
    assert len(bounds) == min(runs, total) + 1
    assert bounds[0] == 0 and bounds[-1] == total
    lengths = np.diff(bounds)
    assert lengths.min() >= 1 and lengths.max() - lengths.min() <= 1
    # every (row-block, slot) exactly once, in order
    np.testing.assert_array_equal(
        np.concatenate([np.arange(b0, b1) for b0, b1 in
                        zip(bounds[:-1], bounds[1:])]), np.arange(total))
    run_of_slot = np.repeat(np.arange(len(lengths)), lengths)
    by_rb = run_of_slot.reshape(nrb, bcap)
    np.testing.assert_array_equal(rb_runs[:, 0], by_rb[:, 0])
    np.testing.assert_array_equal(rb_runs[:, 1], by_rb[:, -1])
    # a run holds at most two cut row-blocks: its first and its last
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        rbs = np.arange(b0 // bcap, (b1 - 1) // bcap + 1)
        cut = rb_runs[rbs, 0] != rb_runs[rbs, 1]
        assert not cut[1:-1].any()


@functools.lru_cache(maxsize=None)
def _pubmed_bsr_shapes():
    """(nrb, bcap) of A and of A^T for the synthetic PubMed corpus at the
    port's 128 x 128 tiles, from the occupied blocks alone."""
    a = to_scipy(synthetic_journal_corpus(n_terms=20112, n_docs=7510,
                                          n_journals=5)[0]).tocoo()
    shapes = []
    for rows, cols, (n, m) in ((a.row, a.col, a.shape),
                               (a.col, a.row, a.shape[::-1])):
        ncb = -(-m // 128)
        blocks = np.unique((rows // 128).astype(np.int64) * ncb + cols // 128)
        counts = np.bincount(blocks // ncb, minlength=-(-n // 128))
        shapes.append((-(-n // 128), int(counts.max())))
    return tuple(shapes)


@pytest.mark.parametrize("orientation", [0, 1])
@pytest.mark.parametrize("runs", [132, 264, 7])
def test_pubmed_plan_covers_every_slot_once(orientation, runs):
    nrb, bcap = _pubmed_bsr_shapes()[orientation]
    assert nrb * bcap == 9322  # 158 x 59 (A) and 59 x 158 (A^T)
    bounds, rb_runs = bsr.split_plan(nrb, bcap, runs)
    _check_plan(nrb, bcap, runs, bounds, rb_runs)
    if runs == 132 and orientation == 1:
        # A^T's long row-blocks each span two or three runs
        assert ((rb_runs[:, 1] - rb_runs[:, 0]) >= 1).all()


@pytest.mark.parametrize("nrb,bcap,runs", [
    (1, 1, 1), (1, 1, 132), (3, 1, 132), (2, 300, 132), (5, 7, 1),
    (17, 4, 7), (4, 33, 33), (9, 9, 80), (132, 1, 132), (10, 13, 3)])
def test_small_plans_cover_every_slot_once(nrb, bcap, runs):
    bounds, rb_runs = bsr.split_plan(nrb, bcap, runs)
    _check_plan(nrb, bcap, runs, bounds, rb_runs)


def _matrix(case, rng, n, m, bm, bk):
    a = rng.random((n, m)).astype(np.float32)
    a[rng.random((n, m)) > 0.05] = 0
    if case == "block_diag":
        a = np.zeros((n, m), np.float32)
        for i in range(0, min(n, m), max(bm, bk)):
            a[i:i + bm, i:i + bk] = 1 + rng.random(a[i:i + bm, i:i + bk].shape)
    elif case == "flags_rb0":
        a[:bm] = rng.random((bm, m))
    return a


@pytest.mark.parametrize("case,n,m,bm,bk", [
    ("random", 257, 129, 32, 32), ("random", 50, 2001, 32, 32),
    ("flags_rb0", 300, 517, 64, 32), ("block_diag", 379, 377, 128, 128)])
@pytest.mark.parametrize("runs", [1, 3, 7, 132, 10 ** 6])
def test_run_partials_in_plan_order_make_the_product(case, n, m, bm, bk,
                                                      runs):
    rng = np.random.default_rng(n + m + runs % 1000)
    op = bsr.bsr_operand(_matrix(case, rng, n, m, bm, bk), bm=bm, bk=bk,
                         device="cpu")
    v = torch.from_numpy(rng.standard_normal((m, 5)))
    u = torch.from_numpy(rng.standard_normal((n, 5)))
    for b0, w in ((op.bsr, v), (op.bsr_t, u)):
        b = bsr.replan(b0, runs)
        assert b.plan.runs == min(runs, b.nrb * b.bcap)
        parts = ref.bsr_spmm_run_partials(b, w)
        assert parts.shape == (b.plan.runs, b.shape[0], 5)
        y = functools.reduce(torch.add, parts)   # in run order
        torch.testing.assert_close(y, ref.bsr_spmm_ref(b, w), rtol=1e-6,
                                   atol=1e-6)
        # a run adds nothing outside the row-blocks it streams
        bounds = b.plan.bounds.numpy()
        for r in range(b.plan.runs):
            rb0, rb1 = bounds[r] // b.bcap, (bounds[r + 1] - 1) // b.bcap
            outside = torch.ones(b.shape[0], dtype=torch.bool)
            outside[rb0 * b.bm:(rb1 + 1) * b.bm] = False
            assert not parts[r][outside].any()


def test_plan_is_fixed_at_ingest_and_follows_the_operand():
    rng = np.random.default_rng(0)
    op = bsr.bsr_operand(_matrix("random", rng, 300, 200, 32, 32), bm=32,
                         bk=32, device="cpu")
    for b in (op.bsr, op.bsr_t):
        slots = b.nrb * b.bcap
        assert b.plan.runs == min(bsr.DEFAULT_RUNS, slots)
        assert b.plan.bounds.dtype == torch.int32
        assert b.plan.rb_runs.shape == (b.nrb, 2)
        moved = b.to("cpu")
        assert torch.equal(moved.plan.bounds, b.plan.bounds)
        assert bsr.replan(b, 5).plan.runs == min(5, slots)
    assert bsr.plan_runs("cpu") == bsr.DEFAULT_RUNS


@pytest.mark.parametrize("k,fused", [(1, True), (5, True), (32, True),
                                     (33, True), (40, True), (75, True),
                                     (76, False), (128, False)])
def test_fused_gate_at_the_paper_tiles(k, fused):
    """The fused kernel fits a ring of two (tile, full-rank slab) stages
    and the k x k Gram in a block's shared memory up to k = 75 at 128 x 128
    f32 tiles."""
    rng = np.random.default_rng(k)
    op = bsr.bsr_operand(_matrix("random", rng, 200, 300, 128, 128), bm=128,
                         bk=128, device="cpu")
    x = torch.zeros((300, k))
    assert CudaBsrBackend()._fusable(op.bsr, x) is fused
    assert CudaBsrBackend(fuse_halfstep=False)._fusable(op.bsr, x) is False
    assert (k <= fused_max_k(128, 128)) is fused
    if fused:
        # a two-stage ring of (tile, full-rank slab) and the k x k Gram
        ws = fused_working_set(128, 128, k)
        assert ws <= SMEM_BUDGET
        assert ws >= 2 * (128 * 128 * 4 + 128 * k * 4)
        assert ring_stage_bytes(128, 128, k) % 128 == 0


def test_pubmed_ring_holds_three_stages():
    """At PubMed's k = 5 the ring of the plain and fused kernels holds
    three 64 KB tiles."""
    stage = ring_stage_bytes(128, 128, 5)
    assert 3 * stage + 256 + 128 <= SMEM_BUDGET < 4 * stage


def _tiny(bm, bk):
    rng = np.random.default_rng(1)
    return bsr.bsr_from_dense(_matrix("random", rng, 2 * bm, 2 * bk, bm, bk),
                              bm=bm, bk=bk, device="cpu")


@pytest.mark.parametrize("bm,bk,match", [(8, 6, "multiple of 4"),
                                         (8, 132, "multiple of 4"),
                                         (132, 8, "bm=132")])
def test_check_operands_refuses_tiles_the_kernel_cannot_take(bm, bk, match):
    b = _tiny(bm, bk)
    with pytest.raises(ValueError, match=match):
        check_operands(b, torch.zeros((b.shape[1], 5)))


def test_check_operands_refuses_misaligned_tiles_and_a_stale_plan():
    b = _tiny(32, 32)
    u = torch.zeros((b.shape[1], 5))
    check_operands(b, u)
    flat = torch.empty(b.tiles.numel() + 1)[1:]
    off = dataclasses.replace(b, tiles=flat.view(b.tiles.shape))
    with pytest.raises(ValueError, match="16-byte"):
        check_operands(off, u)
    stale = bsr.SplitPlan(*map(torch.from_numpy,
                               bsr.split_plan(b.nrb + 1, b.bcap, 3)))
    with pytest.raises(ValueError, match="plan"):
        check_operands(dataclasses.replace(b, plan=stale), u)
