#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and hold each
of its hand-written kernels against its plain PyTorch version.

    python3 chip_smoke.py [--out results.json]

Phases (any failed check raises, and the script exits non-zero):

1. build — compile the CUDA sources (one ``nvcc`` each, all started
   together) and print the build time and ``ptxas`` report;
2. per-kernel checks at the paper's PubMed shapes — every kernel against its
   plain version on the card (the epilogue ``relu_topk``, ``tau`` and
   ``out``, and ``project_mask`` bit for bit at PubMed's U and V, a
   Wikipedia-shaped U (one cluster) and a factor beyond the shared memory
   of all SMs (the grid, streaming it), one launch each, each shape's path
   logged; the BSR products to
   rtol/atol 1e-4, the Gram to 1e-4/1e-3 with one launch per call and
   bitwise repeatable, the fused Gram to 1e-5/1e-4); the BSR products
   bitwise repeatable and the fused Y bitwise the plain one;
3. the main path — ``EnforcedNMF(...backend="cuda-bsr").fit`` of the
   synthetic PubMed corpus (20,112 terms x 7,510 documents, k=5, 50
   iterations, 2% of dense kept in each factor), with launch counts read
   around it: the fused kernel 2 * iters + 1 times, the epilogue
   (``relu_topk``) 2 * iters and no other mask launch; the last U must be
   bitwise both ``relu_topk``'s and the eager plain epilogue's output on
   the fit's own pre-epilogue factor;
4. a ``torch-dense`` fit of the same corpus (8 iterations, its epilogue
   the same launch) whose error trace must match the ``cuda-bsr`` one
   within 1e-4;
5. ``transform`` of 751 unseen documents (``bsr_spmm``, and one
   ``relu_topk`` launch for its epilogue), checked against a CPU fold-in of
   the same documents, its V bitwise the unfused epilogue's (relu, eager
   bisection, mask), and timed (on the ingested operand, and from scipy);
6. a 5-iteration ``cuda-bsr-unfused`` fit (``bsr_spmm`` + ``gram``);
7. timings with CUDA events: each kernel, its plain version, its bound, the
   one PyTorch call that computes the same function where there is one, the
   BSR kernels' rate in GB/s per orientation beside a plain ``torch.sum``
   over the same tiles and the spread of their blocks' end times (the
   split's tail); the fit's time per iteration and the epilogue's share
   of it; a profiler
   window gives the card's busy time and kernels per iteration; every
   source's ``ptxas`` registers and spills, the BSR kernels' asynchronous
   copies counted in the built library's SASS (bulk copies and
   ``cp.async``: a kernel without them fails the run) and the epilogue's
   cluster barriers and warp reductions;
8. the flash-attention kernels against their plain version: the llama3.2-1b
   prefill shape (B=4, H=32, Hkv=8, S=T=4096, hd=64, causal), a non-causal
   Sq != T case, an odd S = 1000 and phi4-mini-3.8b's heads (H=24, Hkv=8,
   hd=128, S=2048), each in bf16 (the tensor-core kernel, rtol 1e-2, atol
   2e-3) and f32 (the CUDA-core kernel, rtol 1e-4, atol 1e-5); two bf16
   calls must be bitwise equal; the tensor-core instructions (HGMMA) in the
   built library's SASS are counted, and the bf16 kernel must have some;
9. the LM prefill at full width: llama3.2-1b drawn on the card from a seed,
   ``make_prefill_step`` on 4 x 4096 tokens (finite next-token logits, the
   flash kernel launched exactly n_layers = 16 times), one 1 x 32768
   prefill (finite, peak memory), and an f32 forward over 64 tokens against
   64 f32 decode steps (last-position logits within 2e-3);
10. serving: a full-width ``ServingEngine`` (max_batch 8, max_seq 512)
    drains 16 requests of 32-token prompts, max_new 32, and reports
    tokens/s;
11. LM timings: the flash kernel, its plain version and
    ``F.scaled_dot_product_attention`` at the prefill shape (and the bf16
    kernel against the library call at the hd 128 shape), its bound; the
    prefill's time and tokens/s, a decode tick, and the card's busy share
    in a profiler window around one prefill;
12. the epilogue's timings, after the LM phases: ``relu_topk`` per call and
    per count round (device time, 40 steps against none) on the fit's
    pre-epilogue factors and the two larger checked shapes, beside the mask
    alone, the eager plain epilogue and, for orientation, ``torch.topk``;
13. the streamed fit: ``solver="streaming"`` on ``cuda-bsr`` over the same
    corpus in the default 8 chunks, 10 inner passes a chunk, with launch
    counts (``bsr_spmm_gram`` and ``relu_topk`` 2 x 10 a chunk,
    ``relu_topk`` once more for the fold-in's epilogue, ``bsr_spmm`` once a
    chunk for the fold-in and once for the statistics' seed); bitwise equal with prefetch off and from a ``write_corpus``
    directory; within 1e-4 of the same streamed fit on ``torch-csr`` (the
    traces; U relative to its largest entry); NNZ(V) by the batch fit's
    per-document rule; the time a chunk, the prefetcher's packing and
    stall, each chunk's host ingest, the card's busy share and peak memory;
14. ``partial_fit`` of phase 5's 751 documents onto phase 3's model: the
    statistics continue (gv = seed + V_c^T V_c within 1e-5 relative),
    finite factors, NNZ(U) within t_u up to ties, health -1, launches;
15. a 5-iteration ``torch-csr`` fit against phase 3's trace (1e-4), and
    the sequential solver (block width 1, 10 iterations a block) on
    ``torch-csr`` against ``torch-dense`` (per-block error, 1e-4), each
    with its time an iteration;
16. k = 256: ``gram`` at (20,112, k) for k = 225, 256 and 300 against
    ``u.T @ u`` and its plain version (1e-4 / 1e-3), bitwise repeatable and
    symmetric, and timed at k = 256 beside ``u.T @ u`` and its bound; a
    3-iteration ``cuda-bsr`` fit at k = 256 (the separate launches) against
    ``torch-dense`` (1e-4), and its time an iteration;
17. fault tolerance at PubMed size on ``cuda-bsr`` (snapshots in a
    ``tempfile.mkdtemp()`` directory): phase 3's fit with
    ``checkpoint_every=10`` killed in process at snapshot 30 and resumed,
    bitwise phase 3's (U, V, traces), with its launches, a checkpointed
    fit's time an iteration beside a plain one's, seconds and bytes a
    snapshot and host syncs a fit (``torch.cuda.set_sync_debug_mode``); a
    NaN-poisoned iteration 25 rolled back to finite factors; ``"raise"``
    and an exhausted ``max_rollbacks``; a resume with another seed refused,
    with the BSR fingerprint's time and host bytes; phase 13's streamed fit
    killed at chunk 4 and resumed (bitwise phase 13's), then poisoned at
    chunk 3 and rolled back; the command line killed (exit 73) and resumed
    in subprocesses, printing the uninterrupted run's numbers;
18. a ``TopicServer`` over phase 3's model serving phase 5's 751
    documents, 32 a tick: each request within 1e-4 of a CPU copy of the
    model, one ``bsr_spmm`` and one ``relu_topk`` a tick, ms a tick split
    into host packing, ingest and the card's part, requests/s; a refresh
    made unhealthy on purpose rolls back (U bitwise), and the retry folds
    the 751 documents in on the card (20 ``bsr_spmm_gram``, 20
    ``relu_topk``, health -1).
19. the mesh engines at PubMed size, every rank a process spawned from here
    (this process joins no group): (a) ``solver="distributed"`` on
    ``cuda-bsr`` on a 1x1 mesh under NCCL (world 1), 50 iterations, held
    to the reference's bars against phase 3 (``bsr_spmm_gram`` 2 * iters
    + 1, no ``relu_topk``); (b) the same fit on 2x2 and 4x1 as four gloo
    ranks sharing the card, each rank's launches, ``all_reduce`` calls and
    bytes, peak memory, ms an iteration, NNZ beside the population of
    tau's histogram bin, held to the same bars against (a), and a
    5-iteration ``torch-csr`` 2x2 fit within 1e-4 of ``cuda-bsr``; (c) a
    streamed 2x2 fit (8 chunks through ``PackedChunk`` prefetch) bitwise
    equal with prefetch off; (d) a 2x2 fit checkpointed every 10
    iterations, killed at snapshot 30 and resumed on 4x1, within 1e-4 of
    the uninterrupted 2x2 trace; (e) ``python -m torch.distributed.run
    --nproc-per-node 4 -m repro_torch.launch.nmf_run --solver distributed
    --mesh 2x2 --dist-backend gloo --small`` exits 0;
20. the tile ledger, bf16 and the fused half-step past k = 32: (a)
    ``autotune`` on the card into a temporary ledger at PubMed's shape, at
    k = 5 and k = 256, each candidate's fused and plain half-step pair
    beside its bound, the winner returned by ``resolve_tiles``, and a
    50-iteration fit at the k = 5 winner's tiles against phase 3 (bitwise
    at phase 3's tiles, else 1e-4); (b) bf16 tiles and factors at PubMed
    shapes: ``bsr_spmm`` and ``bsr_spmm_gram`` in both orientations within
    the reference's bar (rtol 5e-2, atol 1e-1) of f32 math, the fused
    product bitwise the plain one, ``gram`` at k = 5 and 256 (f32 out,
    1e-4 / 1e-3), ``relu_topk`` at PubMed's U and V and 4,000,000 x 8
    bitwise its plain bf16 version, each timed beside its f32 time and its
    bound; (c) ``cuda-bsr`` fusing at k = 33 and 40 (128 x 128 tiles) and
    128 (64 x 64): one ``bsr_spmm_gram`` launch, the product bitwise
    ``bsr_spmm``'s at the same ``kb``, the Gram within f32 roundoff, and a
    3-iteration k = 128 fit within 1e-4 of ``cuda-bsr-unfused``.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits non-zero before printing any result.
"""
import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: the card's peaks (HBM bytes/s, float32 FLOP/s outside the tensor cores,
#: dense bf16 tensor-core FLOP/s), from repro_torch.kernels.autotune, the
#: one copy; set in main() once the package is importable
HBM_BYTES_PER_S = F32_FLOPS = BF16_FLOPS = None

N_TERMS, N_DOCS, K, ITERS = 20112, 7510, 5, 50
NUM_STEPS = 40          # the bisection's steps (Sparsity.num_steps)
T_U, T_V = N_TERMS * K // 50, N_DOCS * K // 50     # 2% of dense: 2011, 751
DENSE_ITERS, UNFUSED_ITERS, NEW_DOCS = 8, 5, 751
DEVICE = "cuda"

#: the LM slice: llama3.2-1b at full width (src/repro/configs/llama3_2_1b.py)
LM_ARCH = "llama3.2-1b"
PREFILL_B, PREFILL_S = 4, 4096
LONG_S = 32768          # prefill_32k's length (configs/__init__.py:51), B=1
DECODE_CHECK_S = 64
SERVE = dict(max_batch=8, max_seq=512, requests=16, prompt=32, max_new=32)
#: flash kernel checks: (B, H, Hkv, Sq, T, hd, causal)
FLASH_CASES = {
    "prefill": (PREFILL_B, 32, 8, PREFILL_S, PREFILL_S, 64, True),
    "Sq!=T": (1, 8, 2, 192, 320, 64, False),
    "odd S": (1, 32, 8, 1000, 1000, 64, True),
    # phi4-mini-3.8b's heads (src/repro/configs/phi4_mini_3_8b.py)
    "hd 128": (1, 24, 8, 2048, 2048, 128, True),
}
#: (rtol, atol) of the flash kernel against its plain version.  In bf16
#: both round p to bf16, the kernel against its running max and the plain
#: version against the row's final max, then round the output: one bf16
#: step (2^-8 to 2^-7 of |out|) plus a few 1e-4 where p's rounding differs.
#: Typical outputs are 0.02-0.09 in size, so these limits are a few percent
#: of them.  In f32 only the order of the sums differs.
FLASH_TOL = {"bfloat16": (1e-2, 2e-3), "float32": (1e-4, 1e-5)}

#: the epilogue's checks, (rows, k, t) at 2% of dense: PubMed's U and V, a
#: Wikipedia-shaped U (143,462 terms, the largest cluster) and a factor
#: beyond the shared memory of all SMs (the grid exchange, streamed)
EPILOGUE_SHAPES = {
    "PubMed U": (N_TERMS, K, T_U),
    "PubMed V": (N_DOCS, K, T_V),
    "Wikipedia U": (143462, K, 143462 * K // 50),
    "beyond on-chip": (4_000_000, 8, 4_000_000 * 8 // 50),
}

REPLACES = {
    "project_mask": "src/repro/kernels/project_mask.py:29",
    "gram": "src/repro/kernels/gram.py:33",
    "bsr_spmm": "src/repro/kernels/bsr_spmm.py:67",
    "bsr_spmm_gram": "src/repro/kernels/fused.py:86",
    "flash_attention": "src/repro/kernels/flash_attention.py:73",
}
SOURCES = {
    "project_mask": ("cuda", "src/repro_torch/csrc/project_mask.cu"),
    "gram": ("cuda", "src/repro_torch/csrc/gram.cu"),
    "bsr_spmm": ("cuda", "src/repro_torch/csrc/bsr_spmm.cu"),
    "bsr_spmm_gram": ("cuda", "src/repro_torch/csrc/bsr_spmm.cu"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def close(name, got, want, rtol, atol):
    """Max abs error of ``got`` against ``want``; raises unless every entry
    is within ``atol + rtol * |want|`` (a NaN on either side fails)."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e}, rtol "
                             f"{rtol}, atol {atol})")
    return err


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms: CUDA events around ``reps`` calls
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops, peak_flops=None):
    """The least time the card could take: bytes at the HBM rate or
    operations at ``peak_flops``, whichever is longer, and which it is."""
    if peak_flops is None:
        peak_flops = F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _spmm_bytes(b, w, tiles, k, gram_out=False):
    """Bytes a BSR product must move: the occupied tiles, the block-column
    indices, the factor read once, the product (and a k x k Gram)
    written once."""
    n_out = b.shape[0] * k
    return 4 * (tiles * b.bm * b.bk + b.nrb * b.bcap + w.numel() + n_out
                + (k * k if gram_out else 0))


def _lib_spmm(b, w, sp, dev):
    """One torch.sparse call on the same matrix: a sparse BSR tensor of the
    same stored tiles, or, where PyTorch has no BSR product on the card, a
    sparse CSR tensor of the same nonzeros.  Returns (name, callable)."""
    import torch

    ncb = -(-b.shape[1] // b.bk)
    size = (b.nrb * b.bm, ncb * b.bk)
    w_pad = torch.nn.functional.pad(w, (0, 0, 0, size[1] - w.shape[0]))
    occ_mask = (b.tiles != 0).flatten(2).any(-1)
    counts = occ_mask.sum(1)
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    mat = torch.sparse_bsr_tensor(crow, b.block_cols[occ_mask],
                                  b.tiles[occ_mask], size=size)
    try:
        torch.sparse.mm(mat, w_pad)
        return "torch.sparse.mm(bsr)", lambda: torch.sparse.mm(mat, w_pad)
    except (RuntimeError, NotImplementedError) as exc:
        log(f"[library] no BSR product on the card ({exc}); timing the "
            "CSR product of the same nonzeros instead")
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(sp.indptr.astype(np.int64)),
        torch.from_numpy(sp.indices.astype(np.int64)),
        torch.from_numpy(sp.data), size=sp.shape).to(dev, w.dtype)
    return "torch.sparse.mm(csr)", lambda: torch.sparse.mm(csr, w)


def _fused_rc(b, u, kb):
    """The fused kernel's own answer to a launch at ``u``'s rank, without
    the wrapper's shared-memory check: the return code of its C entry
    point (0: launched; the launch's own stage arithmetic refuses a rank
    whose Gram and two stages do not fit the card's shared memory)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import bsr_spmm as sk

    (n, m), k = b.shape, u.shape[1]
    y = torch.empty((n, k), dtype=u.dtype, device=u.device)
    g = torch.empty((k, k), dtype=torch.float32, device=u.device)
    tickets, part, gram_part = sk.scratch(b, k, kb)
    return sk._lib().bsr_spmm_gram_run(
        b.tiles.data_ptr(), b.block_cols.data_ptr(), b.gram_flags.data_ptr(),
        u.data_ptr(), y.data_ptr(), part.data_ptr(), gram_part.data_ptr(),
        g.data_ptr(), b.plan.bounds.data_ptr(), b.plan.rb_runs.data_ptr(),
        tickets.data_ptr(), None, n, m, k, b.nrb, b.bcap, b.bm, b.bk,
        b.plan.runs, kb, int(u.dtype == torch.bfloat16),
        _build.stream_ptr(u.device))


def gram_flops(n, k):
    """FLOPs of U^T U for U (n, k): G is symmetric, so the function needs
    only its k (k + 1) / 2 distinct entries, 2 n each."""
    return float(n) * k * (k + 1)


def flash_flops(b, h, sq, t, hd, causal):
    """Multiply-add FLOPs of Q K^T and P V over the (row, key) pairs the
    mask keeps: with absolute indices, row i keeps keys 0..min(i, T - 1)."""
    if causal:
        pairs = sum(min(i + 1, t) for i in range(sq))
    else:
        pairs = sq * t
    return 4.0 * b * h * hd * pairs


def profiled(name, fn, calls=1):
    """Device busy share and kernels per call in a profiler window of
    ``calls`` calls of ``fn``; logs the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    by_kernel = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t_us = getattr(evt, "self_device_time_total", None)
            if t_us is None:
                t_us = evt.self_cuda_time_total
            by_kernel.append((t_us, evt.count, evt.key))
    by_kernel.sort(reverse=True)
    dev_us = sum(x for x, _, _ in by_kernel)
    n_kernels = sum(c for _, c, _ in by_kernel)
    busy = dev_us / (window_s * 1e6)
    log(f"[profile] {name}, {calls} call(s): window {window_s * 1e3:.2f} ms, "
        f"device busy {dev_us / 1e3:.2f} ms ({100 * busy:.1f}%, idle "
        f"{100 * (1 - busy):.1f}%), {n_kernels / calls:.0f} device kernels "
        "per call")
    for x, c, k in by_kernel[:8]:
        log(f"[profile]   {x / 1e3:8.3f} ms in {c:5d} launches: {k[:90]}")
    return dict(window_s=window_s, device_busy_us=dev_us,
                device_busy_share=busy, kernels_per_call=n_kernels / calls,
                top_kernels=[dict(us=x, count=c, name=k[:120])
                             for x, c, k in by_kernel[:10]])


def device_us(fn, match, calls=50):
    """Mean device time in us of the kernels whose name contains ``match``
    over ``calls`` calls of ``fn`` (profiler), after one warm-up call: the
    kernel's own time, whatever the host takes to launch it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and match in evt.key):
            t_us = getattr(evt, "self_device_time_total", None)
            total += evt.self_cuda_time_total if t_us is None else t_us
            count += evt.count
    if count == 0:
        raise AssertionError(f"no device kernel matching {match!r} ran")
    return total / count


def sass_counts(library, ops=("HGMMA", "HMMA")):
    """Instructions of the given opcodes per kernel in a built library's
    SASS (``cuobjdump -sass``): ``{function: {op: n}}``."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          check=True, capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {op: 0 for op in ops}
        elif fn is not None:
            for op in ops:
                if op + "." in line or op + " " in line:
                    counts[fn][op] += 1
    return counts


def ptxas_report(log):
    """``{function: {"registers": n, "stack_bytes": n, "spill_stores": n,
    "spill_loads": n}}`` from an ``nvcc -Xptxas -v`` log."""
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            report[fn] = dict(registers=None, stack_bytes=0, spill_stores=0,
                              spill_loads=0)
            continue
        if fn is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("stack_bytes", r"(\d+) bytes (?:cumulative )?stack"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                report[fn][key] = int(m.group(1))
    return report


def run_lm_slice(dev, paths, checks, rows, results):
    """Phases 8-11: the flash kernel against its plain version, the
    full-width llama3.2-1b prefill (the path that launches it), prefill
    against decode, the serving engine, and the timings."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import api, transformer
    from repro_torch.serving import Request, ServingEngine

    cfg = ARCHS[LM_ARCH]
    lm = {}

    # -- 8. the flash kernel against its plain version ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, h, hkv, sq, t, hd, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, h, sq, hd), (b, hkv, t, hd),
                                   (b, hkv, t, hd)))

    sass = sass_counts(_build.library_path("flash_attention"))
    wgmma_fns = {f: c for f, c in sass.items() if "flash_fwd_bf16_wgmma" in f}
    for f, c in sass.items():
        log(f"[sass] {f[:72]}: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA")
    if not wgmma_fns or any(c["HGMMA"] == 0 for c in wgmma_fns.values()):
        raise AssertionError("the bf16 flash kernel has no HGMMA (tensor-"
                             "core) instruction in its SASS")
    lm["flash_sass"] = sass

    errs, sizes, used, repeat = {}, {}, {}, {}
    for name, (b, h, hkv, sq, t, hd, causal) in FLASH_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            rtol, atol = FLASH_TOL[dname]
            q, k, v = qkv(b, h, hkv, sq, t, hd, dtype)
            got = flash_attention(q, k, v, causal=causal, groups=h // hkv)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           groups=h // hkv)
            key = f"{name} {dname}"
            if dtype == torch.bfloat16:
                repeat[key] = torch.equal(
                    flash_attention(q, k, v, causal=causal, groups=h // hkv),
                    got)
                if not repeat[key]:
                    raise AssertionError(f"flash_attention {key}: two calls "
                                         "are not bitwise equal")
            errs[key] = close(f"flash_attention {key}", got, want, rtol, atol)
            wabs = want.float().abs()
            sizes[key] = float(wabs.median())
            used[key] = float(((got.float() - want.float()).abs()
                               / (atol + rtol * wabs)).max())
            log(f"[check] flash_attention {key} (B={b}, H={h}, Hkv={hkv}, "
                f"Sq={sq}, T={t}, hd={hd}, causal={causal}): kernel == "
                f"plain version within rtol {rtol}, atol {atol} (max abs "
                f"err {errs[key]:.3e}, {100 * used[key]:.1f}% of the limit "
                f"at worst; median |out| {sizes[key]:.4f})")
            del q, k, v, got, want, wabs
    checks["flash_attention"] = max(errs.values())
    log(f"[check] flash_attention bf16: two calls bitwise equal in "
        f"{sorted(repeat)}")
    lm.update(flash_checks=errs, flash_median_abs_out=sizes,
              flash_limit_used=used, flash_bitwise_repeat=repeat)

    # -- 9. prefill at full width ----------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[lm] {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab "
        f"{cfg.vocab}): {n_params} parameters in f32, drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    step = api.make_prefill_step(cfg)
    batch = api.make_batch(cfg, ShapeSpec("prefill", PREFILL_S, PREFILL_B,
                                          "prefill"), seed=1, device=dev)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = step(model, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    paths["prefill"] = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all())
    log(f"[prefill] B={PREFILL_B} x S={PREFILL_S}: next-token logits "
        f"{tuple(logits.shape)} {logits.dtype}, finite {finite}, first call "
        f"{first_s:.3f} s (weights cast to bf16 included), peak memory "
        f"{peak / 1e9:.3f} GB, launches {paths['prefill']}")
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab) or not finite:
        raise AssertionError("prefill logits are not finite (B, vocab)")
    if paths["prefill"]["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"prefill launched the flash kernel "
                             f"{paths['prefill']['flash_attention']} times, "
                             f"not n_layers = {cfg.n_layers}")
    lm.update(prefill_first_s=first_s, prefill_peak_mem_bytes=peak)

    long_batch = {"tokens": torch.randint(
        0, cfg.vocab, (1, LONG_S), generator=gen, device=dev,
        dtype=torch.int32)}
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    long_logits = step(model, long_batch)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    long_peak = torch.cuda.max_memory_allocated()
    long_finite = bool(torch.isfinite(long_logits).all())
    paths["prefill_32k"] = _build.launch_counts()
    log(f"[prefill] B=1 x S={LONG_S}: logits {tuple(long_logits.shape)} "
        f"finite {long_finite}, {long_s:.3f} s, peak memory "
        f"{long_peak / 1e9:.3f} GB (the (1, S, vocab) logits are held, as in"
        f" the reference), flash launches "
        f"{paths['prefill_32k']['flash_attention']}")
    if not long_finite:
        raise AssertionError("32k prefill logits are not finite")
    lm.update(long_prefill_s=long_s, long_prefill_peak_mem_bytes=long_peak)
    del long_logits, long_batch

    toks = torch.randint(0, cfg.vocab, (2, DECODE_CHECK_S), generator=gen,
                         device=dev, dtype=torch.int32)
    with torch.no_grad():
        full = transformer.forward(model, toks, cfg,
                                   compute_dtype=torch.float32)[:, -1]
    cache = transformer.init_cache(cfg, 2, DECODE_CHECK_S,
                                   dtype=torch.float32, device=dev)
    for t in range(DECODE_CHECK_S):
        last, cache = transformer.decode_step(model, cache, toks[:, t], t,
                                              cfg, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    dec_err = close("prefill vs decode", last, full, 2e-3, 2e-3)
    log(f"[prefill] f32 forward over {DECODE_CHECK_S} tokens vs "
        f"{DECODE_CHECK_S} f32 decode steps: last-position logits agree "
        f"within 2e-3 (max abs err {dec_err:.3e})")
    lm["prefill_vs_decode_err"] = dec_err
    del cache, full, last

    # -- 10. serving -----------------------------------------------------------
    rng = np.random.default_rng(2)
    engine = ServingEngine(cfg, model, max_batch=SERVE["max_batch"],
                           max_seq=SERVE["max_seq"], device=dev)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab,
                                               SERVE["prompt"]).tolist(),
                    max_new=SERVE["max_new"])
            for i in range(SERVE["requests"])]
    for r in reqs:
        engine.submit(r)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    paths["serve"] = _build.launch_counts()
    emitted = sum(len(r.out) for r in reqs)
    log(f"[serve] ServingEngine (max_batch {SERVE['max_batch']}, max_seq "
        f"{SERVE['max_seq']}) drained {len(done)} of {len(reqs)} requests "
        f"({SERVE['prompt']}-token prompts, max_new {SERVE['max_new']}): "
        f"{emitted} tokens emitted in {serve_s:.3f} s, "
        f"{emitted / serve_s:.1f} tokens/s (prompt tokens, fed one decode "
        f"step each, not counted), launches {paths['serve']}")
    if len(done) != len(reqs) or any(r.error or not r.out for r in reqs):
        raise AssertionError("the serving engine did not drain every "
                             "request with tokens")
    lm.update(serve_s=serve_s, serve_tokens=emitted,
              serve_tokens_per_s=emitted / serve_s)
    del engine

    # -- 11. timings -------------------------------------------------------------
    b, h, hkv, sq, t, hd, causal = FLASH_CASES["prefill"]
    groups = h // hkv
    timing = {}
    for dtype, peak_flops in ((torch.bfloat16, BF16_FLOPS),
                              (torch.float32, F32_FLOPS)):
        q, k, v = qkv(b, h, hkv, sq, t, hd, dtype)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bound, by = bound_ms(nbytes, flash_flops(b, h, sq, t, hd, causal),
                             peak_flops)
        name = str(dtype).split(".")[-1]
        timing[name] = dict(
            ms=cuda_ms(lambda: flash_attention(q, k, v, causal=causal,
                                               groups=groups), reps=10),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, groups=groups), reps=3, warmup=1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps=10),
            bound_ms=bound, bound_by=by)
        tm = timing[name]
        log(f"[time] flash_attention {name} B={b} H={h} Hkv={hkv} S={sq} "
            f"hd={hd}: {tm['ms']:.4f} ms (plain {tm['plain_ms']:.4f} ms, "
            f"scaled_dot_product_attention {tm['library_ms']:.4f} ms, bound "
            f"{bound:.4f} ms by {by})")
        del q, k, v
    b4, h4, hkv4, sq4, t4, hd4, causal4 = FLASH_CASES["hd 128"]
    q, k, v = qkv(b4, h4, hkv4, sq4, t4, hd4, torch.bfloat16)
    bound4, by4 = bound_ms(
        (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
        flash_flops(b4, h4, sq4, t4, hd4, causal4), BF16_FLOPS)
    timing["bfloat16 hd 128"] = dict(
        ms=cuda_ms(lambda: flash_attention(q, k, v, causal=causal4,
                                           groups=h4 // hkv4), reps=10),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal4, enable_gqa=True), reps=10),
        bound_ms=bound4, bound_by=by4)
    tm = timing["bfloat16 hd 128"]
    log(f"[time] flash_attention bfloat16 B={b4} H={h4} Hkv={hkv4} S={sq4} "
        f"hd={hd4}: {tm['ms']:.4f} ms (scaled_dot_product_attention "
        f"{tm['library_ms']:.4f} ms, bound {bound4:.4f} ms by {by4})")
    del q, k, v
    lm["flash_timing"] = timing
    rows["flash_attention"] = dict(timing["bfloat16"],
                                   library_call="F.scaled_dot_product_"
                                   "attention(is_causal=True, "
                                   "enable_gqa=True)")

    prefill_runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, batch)
        torch.cuda.synchronize()
        prefill_runs.append(time.perf_counter() - t0)
    prefill_s = float(np.median(prefill_runs))
    n_tok = PREFILL_B * PREFILL_S
    flash_share = cfg.n_layers * timing["bfloat16"]["ms"] / (1e3 * prefill_s)
    log(f"[time] prefill B={PREFILL_B} x S={PREFILL_S}: {prefill_s * 1e3:.2f}"
        f" ms (median of {[round(1e3 * x, 2) for x in prefill_runs]} ms), "
        f"{n_tok / prefill_s:.0f} tokens/s; {cfg.n_layers} flash launches "
        f"take {100 * flash_share:.1f}% of it")

    cache = transformer.init_cache(cfg, SERVE["max_batch"], SERVE["max_seq"],
                                   device=dev)
    tok = torch.randint(0, cfg.vocab, (SERVE["max_batch"],), generator=gen,
                        device=dev, dtype=torch.int32)
    decode = api.make_decode_step(cfg)
    decode_ms = cuda_ms(lambda: decode(model, cache, tok, 64), reps=20)
    log(f"[time] decode tick (batch {SERVE['max_batch']}, cache "
        f"{SERVE['max_seq']}): {decode_ms:.3f} ms")

    lm["prefill_profile"] = profiled(
        f"prefill B={PREFILL_B} x S={PREFILL_S}", lambda: step(model, batch))
    lm["decode_profile"] = profiled(
        f"decode tick (batch {SERVE['max_batch']})",
        lambda: decode(model, cache, tok, 64), calls=5)
    lm.update(prefill_s=prefill_s, prefill_runs_s=prefill_runs,
              prefill_tokens_per_s=n_tok / prefill_s,
              flash_share_of_prefill=flash_share, decode_tick_ms=decode_ms)
    results["lm"] = lm


def run_stream_slice(dev, corpus, a_sp, op, model, new_sp, u0, paths,
                     results, keep):
    """Phases 13-16: the streamed fit on cuda-bsr (against prefetch off, a
    corpus directory and torch-csr), partial_fit continuing phase 3's
    model, the torch-csr and sequential fits, and the Gram and a fit at
    k = 256.  Returns gram's row at k = 256; ``keep["streamed"]`` holds
    phase 13's factors and traces for phase 17."""
    import tempfile

    import torch

    from repro_torch.backend import get_backend
    from repro_torch.data import ResidentChunks, write_corpus
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.bsr_spmm import bsr_spmm, resolve_kb
    from repro_torch.kernels.gram import gram
    from repro_torch.nmf import (
        EnforcedNMF, NMFConfig, Sparsity, default_chunk_docs,
    )

    out = results["stream_slice"] = {}
    sparsity = Sparsity(t_u=T_U, t_v=T_V)
    scfg = NMFConfig(k=K, iters=ITERS, sparsity=sparsity, solver="streaming",
                     backend="cuda-bsr")
    width = default_chunk_docs(N_DOCS)
    chunks = -(-N_DOCS // width)
    inner = min(ITERS, 10)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def same(name, a, b):
        if not (torch.equal(a.u_, b.u_) and torch.equal(a.v_, b.v_)
                and torch.equal(a.result_.error, b.result_.error)
                and torch.equal(a._av_acc, b._av_acc)):
            raise AssertionError(f"streamed fit: {name} is not bitwise the "
                                 "resident prefetched fit")

    # -- 13. the streamed fit ------------------------------------------------
    EnforcedNMF(scfg.replace(iters=2), device=dev).fit(a_sp, u0=u0)  # warm
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    on, on_s = wall(lambda: EnforcedNMF(scfg, device=dev).fit(a_sp, u0=u0))
    paths["streamed_fit"] = counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    sres = on.result_
    log(f"[stream] cuda-bsr streamed fit, {chunks} chunks of <= {width} "
        f"documents, {inner} inner passes a chunk: {on_s:.3f} s "
        f"({1e3 * on_s / chunks:.1f} ms a chunk, the fold-in, the "
        f"statistics' seed and the corpus index included), launches "
        f"{counts}; per-chunk error {sres.error.tolist()}; NNZ(U) "
        f"{sres.final_nnz_u}, NNZ(V) {int((on.v_ != 0).sum())}, health "
        f"{int(sres.health)}")
    want = 2 * inner * chunks
    if counts["bsr_spmm_gram"] != want or counts["relu_topk"] != want + 1:
        raise AssertionError(f"streamed fit: bsr_spmm_gram / relu_topk "
                             f"launched {counts['bsr_spmm_gram']} / "
                             f"{counts['relu_topk']} times, not 2 x {inner} "
                             f"x {chunks} = {want} (and the fold-in's "
                             "epilogue once)")
    if counts["bsr_spmm"] != 2 * chunks:
        raise AssertionError(f"streamed fit: bsr_spmm launched "
                             f"{counts['bsr_spmm']} times, not once a chunk "
                             f"for the fold-in and once for the statistics' "
                             f"seed ({2 * chunks})")
    if int(sres.health) != -1 or not bool(torch.isfinite(on.u_).all()):
        raise AssertionError("streamed fit: unhealthy")
    off, off_s = wall(lambda: EnforcedNMF(scfg.replace(prefetch=False),
                                          device=dev).fit(a_sp, u0=u0))
    same("prefetch off", on, off)
    with tempfile.TemporaryDirectory() as tmp:
        (path, write_s) = wall(lambda: write_corpus(corpus, tmp))
        disk, disk_s = wall(lambda: EnforcedNMF(scfg, device=dev).fit(
            path, u0=u0))
        same("from a corpus directory", on, disk)
    log(f"[stream] prefetch off {off_s:.3f} s and from a write_corpus "
        f"directory {disk_s:.3f} s (written in {write_s:.3f} s): both "
        "bitwise the prefetched resident fit (U, V, error trace, A V)")
    csr, csr_s = wall(lambda: EnforcedNMF(scfg.replace(backend="torch-csr"),
                                          device=dev).fit(a_sp, u0=u0))
    diffs = {f: float((getattr(csr.result_, f) - getattr(sres, f)
                       ).abs().max()) for f in ("residual", "error")}
    # U is not normalized (entries reach the hundreds), so its bar is
    # relative to its largest entry: f32 summation order alone moves it by
    # a few ulps of that entry through 80 dependent Gram solves
    diffs["u_rel"] = float((csr.u_ - on.u_).abs().max() / on.u_.abs().max())
    log(f"[stream] torch-csr streamed fit (gather / scatter, eager "
        f"bisection) {csr_s:.3f} s; max abs diff against cuda-bsr (U: "
        f"relative to max |U| = {float(on.u_.abs().max()):.4g}): {diffs}")
    if max(diffs.values()) > 1e-4:
        raise AssertionError(f"streamed cuda-bsr and torch-csr differ: "
                             f"{diffs}")
    nnz_s, nnz_b = int((on.v_ != 0).sum()), int((model.v_ != 0).sum())
    log(f"[stream] NNZ(V) streamed {nnz_s} against batch {nnz_b} "
        f"(t_v = {T_V}: rescaled per chunk)")
    if nnz_s > T_V + 5 or abs(nnz_s - nnz_b) > 0.1 * T_V:
        raise AssertionError("streamed NNZ(V) breaks the batch fit's "
                             "per-document rule")
    st = sres.stream_stats["fit"]
    hidden = 1.0 - st["stall_s"] / st["pack_s"] if st["pack_s"] else 0.0
    # each chunk's host ingest into the two BSR orientations, alone
    source = ResidentChunks(corpus, width)
    be = get_backend("cuda-bsr")
    ingest = []
    for i in range(chunks):
        host = source.load(i)
        t0 = time.perf_counter()
        be.prepare(host, device="cpu")
        ingest.append(time.perf_counter() - t0)
    prof = profiled("streamed cuda-bsr fit",
                    lambda: EnforcedNMF(scfg, device=dev).fit(a_sp, u0=u0))
    log(f"[stream] prefetcher (factor pass): pack {st['pack_s']:.3f} s, "
        f"consumer stalled {st['stall_s']:.3f} s, {100 * hidden:.1f}% of "
        f"the packing hidden under compute, max queued "
        f"{st['max_queued']}; fold-in pass {sres.stream_stats['fold_in']}; "
        f"host ingest a chunk {[round(x, 4) for x in ingest]} s; device "
        f"memory peak {peak / 1e9:.3f} GB ({base_mem / 1e9:.3f} GB resident "
        f"before it), the batch fit's (phase 7) "
        f"{results['timing']['fit_peak_mem_bytes'] / 1e9:.3f} GB ("
        f"{results['timing']['resident_before_fit_bytes'] / 1e9:.3f} GB)")
    out["streamed"] = dict(
        chunks=chunks, chunk_docs=width, inner=inner, wall_s=on_s,
        per_chunk_ms=1e3 * on_s / chunks, prefetch_off_s=off_s,
        disk_s=disk_s, write_s=write_s, csr_s=csr_s, csr_diffs=diffs,
        launches=counts, error=sres.error.tolist(),
        residual=sres.residual.tolist(), nnz_v=nnz_s, batch_nnz_v=nnz_b,
        prefetch=st, fold_in=sres.stream_stats["fold_in"],
        hidden_share=hidden, ingest_s=ingest, peak_mem_bytes=peak,
        resident_before_bytes=base_mem, profile=prof)
    keep["streamed"] = dict(u=on.u_, v=on.v_, residual=sres.residual,
                            error=sres.error, wall_s=on_s)
    del on, off, disk, csr

    # -- 14. partial_fit continues phase 3's model ---------------------------
    gv_seed = model._gv_acc.clone()
    _build.reset_launch_counts()
    (_, pf_s) = wall(lambda: model.partial_fit(new_sp))
    paths["partial_fit"] = counts = _build.launch_counts()
    v_c = model.v_
    want_gv = gv_seed + v_c.T @ v_c
    rel = float((model._gv_acc - want_gv).abs().max() / want_gv.abs().max())
    nu = int((model.u_ != 0).sum())
    finite = bool(torch.isfinite(model.u_).all() and torch.isfinite(v_c).all())
    log(f"[partial_fit] {NEW_DOCS} held-out documents onto phase 3's model "
        f"in {1e3 * pf_s:.1f} ms: gv against seed + V_c^T V_c relative "
        f"{rel:.3e}; NNZ(U) {nu}, NNZ(V_c) {int((v_c != 0).sum())}, health "
        f"{int(model.health_)}, launches {counts}")
    if rel > 1e-5 or not finite or int(model.health_) != -1:
        raise AssertionError("partial_fit did not continue the statistics")
    if not nu <= T_U + max(2, T_U // 100):
        raise AssertionError(f"partial_fit NNZ(U) {nu} exceeds t_u")
    if counts["bsr_spmm_gram"] != 2 * inner or counts["relu_topk"] != 2 * inner:
        raise AssertionError("partial_fit did not take the fused kernel and "
                             "the epilogue twice an inner pass")
    out["partial_fit"] = dict(ms=1e3 * pf_s, gv_rel=rel, nnz_u=nu,
                              launches=counts)

    # -- 15. torch-csr and sequential ----------------------------------------
    csr_cfg = NMFConfig(k=K, iters=UNFUSED_ITERS, sparsity=sparsity,
                        backend="torch-csr")
    _build.reset_launch_counts()
    csr_fit, csr_fit_s = wall(lambda: EnforcedNMF(csr_cfg, device=dev).fit(
        a_sp, u0=u0))
    paths["csr_fit"] = _build.launch_counts()
    cdiff = float((csr_fit.result_.error
                   - model.result_.error[:UNFUSED_ITERS]).abs().max())
    log(f"[csr] {UNFUSED_ITERS}-iteration torch-csr fit (cap "
        f"{corpus.cap}): {1e3 * csr_fit_s / UNFUSED_ITERS:.1f} ms an "
        f"iteration (ingest included); error trace against phase 3's "
        f"cuda-bsr max abs diff {cdiff:.3e}; launches {paths['csr_fit']}")
    if cdiff > 1e-4:
        raise AssertionError("torch-csr and cuda-bsr error traces differ")
    seq_iters = 10
    seq_cfg = NMFConfig(k=K, iters=seq_iters, sparsity=sparsity,
                        solver="sequential", block_size=1,
                        backend="torch-csr")
    seq, seq_s = wall(lambda: EnforcedNMF(seq_cfg, device=dev).fit(
        a_sp, u0=u0))
    seq_d = EnforcedNMF(seq_cfg.replace(backend="torch-dense"),
                        device=dev).fit(a_sp, u0=u0)
    sdiff = float((seq.result_.error - seq_d.result_.error).abs().max())
    log(f"[sequential] block_size 1, {seq_iters} iterations a block, {K} "
        f"blocks on torch-csr: {1e3 * seq_s / (K * seq_iters):.2f} ms an "
        f"iteration ({seq_s:.3f} s); per-block error "
        f"{seq.result_.error.tolist()}, against torch-dense max abs diff "
        f"{sdiff:.3e}")
    if sdiff > 1e-4 or seq.result_.error_granularity != "block":
        raise AssertionError("sequential torch-csr and torch-dense differ")
    out["csr"] = dict(iters=UNFUSED_ITERS, wall_s=csr_fit_s,
                      per_iter_ms=1e3 * csr_fit_s / UNFUSED_ITERS,
                      error_diff=cdiff, cap=corpus.cap)
    out["sequential"] = dict(iters_per_block=seq_iters, blocks=K,
                             wall_s=seq_s,
                             per_iter_ms=1e3 * seq_s / (K * seq_iters),
                             error=seq.result_.error.tolist(),
                             dense_diff=sdiff)
    del csr_fit, seq, seq_d

    # -- 16. the Gram and a fit at k = 256 -----------------------------------
    big_k = 256
    gen = torch.Generator().manual_seed(16)
    gram_checks = {}
    for k in (225, big_k, 300):          # 300 = 2 x 128 + 44
        # mean-zero U: off-diagonal entries ~sqrt(n), so the bar separates
        # f32 products from TF32 or bf16 ones
        w = torch.randn((N_TERMS, k), generator=gen).to(dev)
        _build.reset_launch_counts()
        g1 = gram(w)
        if _build.launch_counts()["gram"] != 1:
            raise AssertionError("gram: more than one launch a call")
        if not (torch.equal(gram(w), g1) and torch.equal(g1, g1.T)):
            raise AssertionError(f"gram at k = {k} is not bitwise "
                                 "repeatable and symmetric")
        gram_checks[k] = max(close(f"gram k={k}", g1, w.T @ w, 1e-4, 1e-3),
                             close(f"gram k={k}", g1, ref.gram_ref(w), 1e-4,
                                   1e-3))
    log(f"[k256] gram at ({N_TERMS}, k) against u.T @ u and its plain "
        f"version, one launch, bitwise repeatable and symmetric: max abs "
        f"err {gram_checks}")
    w = torch.randn((N_TERMS, big_k), generator=gen).to(dev)
    turns = [cuda_ms(lambda: gram(w), reps=50),
             cuda_ms(lambda: w.T @ w, reps=50),
             cuda_ms(lambda: w.T @ w, reps=50),
             cuda_ms(lambda: gram(w), reps=50)]
    g_row = dict(ms=(turns[0] + turns[3]) / 2, library_ms=(turns[1] + turns[2]) / 2,
                 plain_ms=cuda_ms(lambda: ref.gram_ref(w), reps=20),
                 turns_ms=turns, max_abs_err=gram_checks)
    g_row["bound_ms"], g_row["bound_by"] = bound_ms(
        4 * (N_TERMS * big_k + big_k * big_k), gram_flops(N_TERMS, big_k))
    log(f"[k256] gram ({N_TERMS} x {big_k}): {g_row['ms']:.4f} ms, u.T @ u "
        f"{g_row['library_ms']:.4f} ms (turns {[round(t, 4) for t in turns]}"
        f" ms), plain {g_row['plain_ms']:.4f} ms, bound "
        f"{g_row['bound_ms']:.4f} ms by {g_row['bound_by']}")
    v_big = torch.rand((N_DOCS, big_k), generator=gen).to(dev)
    # the column chunk from the tile ledger (kernels/autotune_ledger.json)
    big_kb = resolve_kb(op.bsr, v_big, None)
    spmm_ms = cuda_ms(lambda: bsr_spmm(op.bsr, v_big), reps=5)
    close("bsr_spmm k=256", bsr_spmm(op.bsr, v_big),
          ref.bsr_spmm_ref(op.bsr, v_big), 1e-4, 1e-4)
    # its bound and the library call at k = 256 (PERF.md's kernel table)
    tiles = int((op.bsr.tiles != 0).flatten(2).any(-1).sum())
    spmm_bound = bound_ms(_spmm_bytes(op.bsr, v_big, tiles, big_k),
                          2.0 * tiles * op.bsr.bm * op.bsr.bk * big_k)
    lib_call, lib_fn = _lib_spmm(op.bsr, v_big, a_sp.tocsr(), dev)
    spmm_lib_ms = cuda_ms(lib_fn, reps=5)
    log(f"[k256] bsr_spmm A @ V at k = {big_k}, kb = {big_kb} (the tile "
        f"ledger's): {spmm_ms:.4f} ms, bound "
        f"{spmm_bound[0]:.4f} ms by {spmm_bound[1]}, {lib_call} "
        f"{spmm_lib_ms:.4f} ms")
    big_cfg = NMFConfig(k=big_k, iters=3, backend="cuda-bsr",
                        sparsity=Sparsity(t_u=N_TERMS * big_k // 50,
                                          t_v=N_DOCS * big_k // 50))
    u_big = torch.rand((N_TERMS, big_k), generator=gen).to(dev)
    _build.reset_launch_counts()
    big, big_s = wall(lambda: EnforcedNMF(big_cfg, device=dev).fit(
        op, u0=u_big))
    paths["fit_k256"] = counts = _build.launch_counts()
    big_d = EnforcedNMF(big_cfg.replace(backend="torch-dense"),
                        device=dev).fit(a_sp, u0=u_big)
    kdiff = float((big.result_.error - big_d.result_.error).abs().max())
    log(f"[k256] 3-iteration cuda-bsr fit at k = {big_k} (unfused "
        f"half-steps): {1e3 * big_s / 3:.1f} ms an iteration; bsr_spmm "
        f"A @ V at k = {big_k} {spmm_ms:.3f} ms; error "
        f"{big.result_.error.tolist()}, against torch-dense max abs diff "
        f"{kdiff:.3e}; launches {counts}")
    if kdiff > 1e-4 or int(big.result_.health) != -1:
        raise AssertionError("the k = 256 fit disagrees with torch-dense")
    if counts["gram"] < 6 or counts["bsr_spmm"] < 6 or counts["relu_topk"] != 6:
        raise AssertionError("the k = 256 fit did not take bsr_spmm, gram "
                             "and relu_topk")
    out["k256"] = dict(gram=g_row, spmm_ms=spmm_ms, kb=big_kb,
                       spmm_bound_ms=spmm_bound[0],
                       spmm_bound_by=spmm_bound[1],
                       spmm_library=lib_call, spmm_library_ms=spmm_lib_ms,
                       fit_per_iter_ms=1e3 * big_s / 3, error_diff=kdiff,
                       launches=counts)
    return g_row


class _Killed(Exception):
    """Phase 17's in-process kill at a checkpoint commit."""


def _fit_numbers(out):
    """The command line's printed numbers (its last fit line, from the
    final error on: the wall time before it differs run to run)."""
    line = [ln for ln in out.splitlines() if "final error" in ln][-1]
    return line[line.index("final error"):]


def _sync_count(fn):
    """``(fn(), host syncs inside fn)``: the synchronizing CUDA calls
    ``torch.cuda.set_sync_debug_mode("warn")`` reports (a read of a device
    value, a copy to the host, a stream synchronize); the mode's own notice
    that it is a prototype is not one of them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("called a synchronizing CUDA operation" in str(x.message)
                    for x in w)


def run_fault_slice(dev, a_sp, op, model, u0, paths, results, keep):
    """Phase 17: fault tolerance at PubMed size on cuda-bsr: a checkpointed
    fit killed at snapshot 30 and resumed (bitwise phase 3), its costs, a
    poisoned iteration rolled back, the raise and give-up paths, a
    mismatched resume, the streamed fit killed and resumed (bitwise phase
    13) and poisoned, and the command line killed (exit 73) and resumed."""
    import os
    import shutil
    import tempfile
    import warnings

    import torch

    from repro_torch.kernels import _build
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
    from repro_torch.robustness import (
        KILL_EXIT, CheckpointMismatchError, FitHealthError, faults,
    )
    from repro_torch.robustness.snapshot import data_fingerprint

    out = results["fault_slice"] = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    fresh = lambda: tempfile.mkdtemp(dir=root)
    sparsity = Sparsity(t_u=T_U, t_v=T_V)
    cfg = NMFConfig(k=K, iters=ITERS, sparsity=sparsity, backend="cuda-bsr")
    res3 = model.result_          # phase 3's fit (partial_fit left it)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def fit(c, **kw):
        return EnforcedNMF(c, device=dev).fit(op, u0=u0, **kw)

    def bitwise(name, got, want):
        for field in ("u", "v", "residual", "error"):
            if not torch.equal(got[field], want[field]):
                raise AssertionError(f"{name}: {field} is not bitwise the "
                                     "uninterrupted fit's")

    # -- 17(a). killed at snapshot 30, resumed -------------------------------
    ck = cfg.replace(checkpoint_dir=fresh(), checkpoint_every=10)
    with faults.inject("kill", key=30, exc=_Killed):
        try:
            fit(ck)
        except _Killed:
            pass
        else:
            raise AssertionError("the kill fault at snapshot 30 never fired")
    _build.reset_launch_counts()
    resumed, resume_s = wall(lambda: fit(ck, resume=True))
    paths["resumed_fit"] = counts = _build.launch_counts()
    r = resumed.result_
    bitwise("resumed fit", dict(u=resumed.u_, v=resumed.v_,
                                residual=r.residual, error=r.error),
            dict(u=res3.u, v=res3.v, residual=res3.residual,
                 error=res3.error))
    if r.n_iter != ITERS:
        raise AssertionError(f"resumed fit n_iter {r.n_iter} != {ITERS}")
    if counts["bsr_spmm_gram"] != 2 * 20 + 1 or counts["relu_topk"] != 40:
        raise AssertionError(f"the resumed fit's 20 iterations launched "
                             f"{counts}")
    log(f"[fault] cuda-bsr fit killed at snapshot 30 (checkpoint_every 10),"
        f" resumed in {resume_s:.3f} s: U, V, residual and error traces "
        f"bitwise phase 3's, n_iter {r.n_iter}; the resumed run's launches "
        f"bsr_spmm_gram {counts['bsr_spmm_gram']}, relu_topk "
        f"{counts['relu_topk']}")
    # a clean checkpointed fit against the plain fit, in turns
    plain_s, ckpt_s, stats = [], [], None
    for turn in range(3):
        _, t = wall(lambda: fit(cfg))
        plain_s.append(t)
        m, t = wall(lambda: fit(cfg.replace(checkpoint_dir=fresh(),
                                            checkpoint_every=10)))
        ckpt_s.append(t)
        stats = m.result_.checkpoint_stats
    plain_it = 1e3 * float(np.median(plain_s)) / ITERS
    ckpt_it = 1e3 * float(np.median(ckpt_s)) / ITERS
    _, plain_syncs = _sync_count(lambda: fit(cfg))
    _, ckpt_syncs = _sync_count(lambda: fit(cfg.replace(
        checkpoint_dir=fresh(), checkpoint_every=10)))
    snap_ms = 1e3 * stats["save_s"] / stats["saves"]
    snap_bytes = stats["bytes"] / stats["saves"]
    log(f"[fault] checkpointed fit (every 10, {stats['saves']} snapshots) "
        f"{ckpt_it:.3f} ms an iteration against {plain_it:.3f} ms without "
        f"(medians of 3 in turns; phase 7: "
        f"{results['timing']['per_iter_ms']:.3f} ms); a snapshot "
        f"{snap_ms:.3f} ms and {snap_bytes:.0f} bytes; host syncs a fit "
        f"{plain_syncs} without snapshots, {ckpt_syncs} with")
    out["resume"] = dict(seconds=resume_s, launches=counts,
                         plain_ms_per_iter=plain_it,
                         ckpt_ms_per_iter=ckpt_it, plain_runs_s=plain_s,
                         ckpt_runs_s=ckpt_s, snapshot_ms=snap_ms,
                         snapshot_bytes=snap_bytes, saves=stats["saves"],
                         host_syncs_plain=plain_syncs,
                         host_syncs_ckpt=ckpt_syncs)

    # -- 17(b). a poisoned iteration rolls back ------------------------------
    with faults.inject("poison-step", key=25):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            _build.reset_launch_counts()
            rolled, roll_s = wall(lambda: fit(cfg.replace(
                checkpoint_dir=fresh(), checkpoint_every=5)))
            paths["poisoned_fit"] = _build.launch_counts()
    msgs = [str(x.message) for x in w if "rolling back" in str(x.message)]
    rr = rolled.result_
    nu = rr.final_nnz_u
    found = (re.search(r"at iteration (\d+); rolling back to iteration 25 ",
                       msgs[0]) if len(msgs) == 1 else None)
    if found is None:
        raise AssertionError(f"poisoned fit: rollback warnings {msgs}")
    # the warning names the iteration the solver read from the card: the
    # poisoned chunk's start (25, a snapshot boundary) plus its health index
    bad_at = int(found.group(1))
    health = bad_at - 25
    if not 0 <= health < 5:
        raise AssertionError(f"poisoned chunk's health index {health} is "
                             "not inside the chunk")
    if not bool(torch.isfinite(rolled.u_).all() and
                torch.isfinite(rolled.v_).all()) or rr.n_iter != ITERS:
        raise AssertionError("poisoned fit did not end finite at 50 "
                             "iterations")
    if not nu <= T_U + max(2, T_U // 100):
        raise AssertionError(f"poisoned fit NNZ(U) {nu} exceeds t_u")
    log(f"[fault] poison-step at iteration 25 (checkpoint_every 5): "
        f"{msgs[0]!r}; the poisoned chunk's health index, read from the "
        f"card, {health} (iteration {bad_at}); finite, n_iter {rr.n_iter}, "
        f"NNZ(U) {nu}, "
        f"final error {rr.final_error:.6f} (phase 3: {res3.final_error:.6f})"
        f", {roll_s:.3f} s, launches {paths['poisoned_fit']}")
    out["rollback"] = dict(seconds=roll_s, warning=msgs[0], health=health,
                           nnz_u=nu,
                           final_error=rr.final_error,
                           phase3_error=res3.final_error,
                           launches=paths["poisoned_fit"])

    # -- 17(c). raise, and the rollback budget -------------------------------
    with faults.inject("poison-step", key=0):
        try:
            fit(cfg.replace(on_unhealthy="raise"))
        except FitHealthError as e:
            raised = str(e)
        else:
            raise AssertionError("on_unhealthy='raise' did not raise")
    with faults.inject("poison-step", key=10, times=10):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                fit(cfg.replace(max_rollbacks=2, checkpoint_dir=fresh(),
                                checkpoint_every=10))
            except FitHealthError as e:
                gave_up = str(e)
            else:
                raise AssertionError("max_rollbacks=2 did not give up")
    if "gave up after 2" not in gave_up:
        raise AssertionError(f"budget exhaustion: {gave_up}")
    log(f"[fault] 'raise' with poison at 0: {raised!r}; max_rollbacks=2 "
        f"with the poison armed 10 times: {gave_up!r}")

    # -- 17(d). a resume with another seed is refused ------------------------
    try:
        fit(ck.replace(seed=1), resume=True)
    except CheckpointMismatchError:
        pass
    else:
        raise AssertionError("a resume with another seed was not refused")
    fp_s = []
    for _ in range(3):
        fp, t = wall(lambda: data_fingerprint(op))
        fp_s.append(t)
    log(f"[fault] resume with seed 1 refused (CheckpointMismatchError); the "
        f"BSR operand's fingerprint {1e3 * min(fp_s):.3f} ms (min of 3), "
        f"{fp['sampled_bytes']} bytes copied to the host of "
        f"{op.bsr.tiles.numel() * 4 + op.bsr_t.tiles.numel() * 4} tile bytes")
    out["fingerprint"] = dict(ms=1e3 * min(fp_s), runs_s=fp_s,
                              host_bytes=fp["sampled_bytes"],
                              stored_tiles=fp["stored_tiles"])

    # -- 17(e). the streamed fit killed and resumed, then poisoned -----------
    scfg = NMFConfig(k=K, iters=ITERS, sparsity=sparsity, solver="streaming",
                     backend="cuda-bsr", checkpoint_every=2)
    sck = scfg.replace(checkpoint_dir=fresh())
    with faults.inject("kill", key=4, exc=_Killed):
        try:
            EnforcedNMF(sck, device=dev).fit(a_sp, u0=u0)
        except _Killed:
            pass
        else:
            raise AssertionError("the streamed fit's kill never fired")
    _build.reset_launch_counts()
    sres, sres_s = wall(lambda: EnforcedNMF(sck, device=dev).fit(
        a_sp, u0=u0, resume=True))
    paths["resumed_stream"] = _build.launch_counts()
    bitwise("resumed streamed fit",
            dict(u=sres.u_, v=sres.v_, residual=sres.result_.residual,
                 error=sres.result_.error), keep["streamed"])
    with faults.inject("poison-step", key=3):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            spois, spois_s = wall(lambda: EnforcedNMF(
                scfg.replace(checkpoint_dir=fresh()), device=dev).fit(
                    a_sp, u0=u0))
    smsgs = [str(x.message) for x in w if "rolling back" in str(x.message)]
    if (len(smsgs) != 1 or not bool(torch.isfinite(spois.u_).all())
            or int(spois.result_.health) != -1):
        raise AssertionError(f"poisoned streamed fit: {smsgs}, health "
                             f"{int(spois.result_.health)}")
    log(f"[fault] streamed fit (checkpoint_every 2) killed at chunk 4 and "
        f"resumed in {sres_s:.3f} s (phase 13's whole fit "
        f"{keep['streamed']['wall_s']:.3f} s): U, V and traces bitwise "
        f"phase 13's, launches {paths['resumed_stream']}; poison-step at "
        f"chunk 3: {smsgs[0]!r}, finite, {spois_s:.3f} s")
    out["stream"] = dict(resume_s=sres_s, poisoned_s=spois_s,
                         warning=smsgs[0], launches=paths["resumed_stream"])
    del sres, spois

    # -- 17(f). the command line, killed and resumed -------------------------
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    argv = ["--config", "pubmed", "--small", "--backend", "cuda-bsr",
            "--iters", "20", "--checkpoint-dir", fresh(),
            "--checkpoint-every", "5"]
    kill_code = ("import sys\n"
                 "from repro_torch.launch import nmf_run\n"
                 "from repro_torch.robustness import faults\n"
                 "faults.install('kill', key=10)\n"
                 "nmf_run.main(sys.argv[1:])\n"
                 "raise SystemExit('the kill fault never fired')\n")
    module = [sys.executable, "-m", "repro_torch.launch.nmf_run"]
    t0 = time.perf_counter()
    run = lambda cmd: subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    procs = [run([sys.executable, "-c", kill_code] + argv),
             run(module + argv[:-4])]
    outs = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=300)
        finally:
            p.kill()
        outs.append((p.returncode, o, e))
    resumed_cli = subprocess.run(module + argv + ["--resume"], env=env,
                                 capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    (kill_rc, _, kill_err), (full_rc, full_out, full_err) = outs
    if kill_rc != KILL_EXIT:
        raise AssertionError(f"the killed command line exited {kill_rc}, "
                             f"not {KILL_EXIT}: {kill_err[-2000:]}")
    if full_rc != 0 or resumed_cli.returncode != 0:
        raise AssertionError(f"command line: uninterrupted exit {full_rc}, "
                             f"resumed {resumed_cli.returncode}: "
                             f"{full_err[-1000:]} {resumed_cli.stderr[-1000:]}")
    got, want = (_fit_numbers(resumed_cli.stdout), _fit_numbers(full_out))
    if got != want:
        raise AssertionError(f"the resumed command line printed {got!r}, "
                             f"the uninterrupted one {want!r}")
    log(f"[fault] command line (pubmed --small, cuda-bsr, 20 iterations, "
        f"every 5): killed at 10, exit {kill_rc}; --resume exit 0 and "
        f"prints the uninterrupted run's numbers: {got}; three processes "
        f"{cli_s:.1f} s")
    out["cli"] = dict(kill_exit=kill_rc, numbers=got, seconds=cli_s)
    shutil.rmtree(root, ignore_errors=True)


def _tau_bin_population(x, nbins=8192):
    """Entries of the kept factor ``x`` in its lowest occupied bin of
    ``DistTopK``'s log histogram (whose edges depend only on the largest
    magnitude, which the mask keeps): the population of the threshold's
    bin, by which NNZ may exceed t."""
    import torch

    from repro_torch.core.topk import log_histogram

    absx = x.abs()
    hist, _, _ = log_histogram(absx, absx.max(), nbins)
    occupied = torch.nonzero(hist).flatten()
    return int(hist[occupied[0]]) if len(occupied) else 0


def _profile_window(fn, iters):
    """A profiler window around ``fn()`` (a fit of ``iters`` iterations):
    wall, device-busy and collective host time an iteration, and device
    kernels an iteration (the rank's own process; its numbers only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev_us, kernels, coll, top = 0.0, 0, {}, []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t_us = getattr(evt, "self_device_time_total", None)
            if t_us is None:
                t_us = evt.self_cuda_time_total
            dev_us += t_us
            kernels += evt.count
            top.append((t_us, evt.key[:60]))
        elif "allreduce" in evt.key.lower().replace("_", ""):
            # the host time of the collective's own events (gloo's staging
            # and exchange, or the enqueue of NCCL's), by name
            coll[evt.key[:40]] = round(evt.cpu_time_total / 1e3 / iters, 4)
    top.sort(reverse=True)
    return dict(window_ms=1e3 * window_s / iters,
                busy_ms=dev_us / 1e3 / iters,
                busy_share=dev_us / (window_s * 1e6),
                all_reduce_host_ms=coll, kernels=kernels / iters,
                top=[(round(t / 1e3 / iters, 4), k) for t, k in top[:4]])


def _time_engine(a_sp, u0, dev, kw):
    """The batch engine's own time on this rank's block, its ingest left
    out: ``make_sharded_als`` on the mesh, the block distributed once, a
    2-iteration warm-up call, then a timed call of ``kw["iters"]``
    iterations (host clock, synchronized) with its collectives counted, and
    a profiler window of 5 iterations (on the card)."""
    import torch

    from repro_torch.backend.sharded import make_sharded_als
    from repro_torch.core.topk import DistTopK
    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )

    mesh = make_nmf_mesh(*kw["mesh_shape"], device=dev)
    engine = make_sharded_als(
        mesh, sparsify_u=DistTopK(T_U, mesh, ("data",)),
        sparsify_v=DistTopK(T_V, mesh, ("model",)), inner=kw["backend"])
    dist = engine.distribute(a_sp)
    u = torch.from_numpy(u0).to(dev)[mesh.row_block(u0.shape[0])]
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    engine(dist, u, 2)
    sync()
    reset_collective_counts()
    iters = kw["iters"]
    t0 = time.perf_counter()
    engine(dist, u, iters)
    sync()
    iter_ms = 1e3 * (time.perf_counter() - t0) / iters
    c = collective_counts()
    out = dict(iter_ms=iter_ms, all_reduce=c["all_reduce"] / iters,
               bytes=c["bytes"] / iters)
    if card:
        out["profile"] = _profile_window(lambda: engine(dist, u, 5), 5)
    return out


def _mesh_rank(rank, data_dir, device, jobs):
    """One rank of phase 19: each job a fit on the mesh this process
    belongs to, on ``device``, with its launch and collective counts, peak
    memory and wall time read around it (the counts set to 0 just before
    the fit)."""
    import scipy.sparse

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import (
        collective_counts, reset_collective_counts,
    )
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
    from repro_torch.robustness import faults

    class Killed(Exception):
        pass

    dev = torch.device(device)
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    a_sp = scipy.sparse.load_npz(Path(data_dir) / "a.npz")
    u0 = np.load(Path(data_dir) / "u0.npy")
    out = {}
    for name, kw in jobs:
        kw = dict(kw)
        kill_at = kw.pop("kill_at", None)
        resume = kw.pop("resume", None)
        if kw.pop("engine", False):
            out[name] = _time_engine(a_sp, u0, dev, kw)
            continue
        cfg = NMFConfig(sparsity=Sparsity(t_u=T_U, t_v=T_V), **kw)
        sync()
        if card:
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        reset_collective_counts()
        t0 = time.perf_counter()
        model = EnforcedNMF(cfg, device=dev)
        if kill_at is not None:
            try:
                with faults.inject("kill", key=kill_at, exc=Killed):
                    model.fit(a_sp, u0=u0)
                raise AssertionError("the kill fault never fired")
            except Killed:
                out[name] = dict(killed=True)
                continue
        model.fit(a_sp, u0=u0, resume=resume)
        sync()
        wall_s = time.perf_counter() - t0
        r = model.result_
        rec = dict(
            launches=_build.launch_counts(),
            collectives=collective_counts(),
            peak_mb=(torch.cuda.max_memory_allocated() / 2**20 if card
                     else 0.0),
            wall_s=wall_s, ms_per_iter=1e3 * wall_s / r.n_iter,
            err=r.error.tolist(), res=r.residual.tolist(),
            nnz_u=r.nnz_u.tolist(), nnz_v=r.nnz_v.tolist(),
            health=int(r.health), n_iter=int(r.n_iter),
            pop_u=_tau_bin_population(model.u_),
            pop_v=_tau_bin_population(model.v_),
            finite=bool(torch.isfinite(model.u_).all()
                        and torch.isfinite(model.v_).all()),
            u=model.u_.cpu().numpy() if rank == 0 else None,
            v=model.v_.cpu().numpy() if rank == 0 else None)
        if r.stream_stats is not None:
            rec["stream_stats"] = r.stream_stats
        out[name] = rec
    return out


def run_mesh_slice(a_sp, res3, u0, paths, results, device="cuda:0",
                   one_rank_backend="nccl"):
    """Phase 19: the mesh engines on the card.  Every rank is a process
    spawned from here (this process joins no group): a 1x1 mesh under NCCL,
    2x2 and 4x1 meshes as four gloo ranks sharing the card; the streamed fit
    on 2x2; a 2x2 fit killed at snapshot 30 and resumed on 4x1; the command
    line under ``torch.distributed.run``.  (``device="cpu"`` with gloo runs
    the same phase on the CPU, to debug it at a small size.)"""
    import os
    import shutil
    import tempfile

    import scipy.sparse

    from repro_torch.launch.mesh import spawn_mesh

    out = results["phases"].setdefault("mesh", {})
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    scipy.sparse.save_npz(Path(root) / "a.npz", a_sp.tocsr())
    np.save(Path(root) / "u0.npy", u0.cpu().numpy())
    ckpt = str(Path(root) / "ckpt")
    fit = dict(k=K, iters=ITERS, solver="distributed", backend="cuda-bsr")

    def spawn(shape, backend, jobs):
        t0 = time.perf_counter()
        recs = spawn_mesh(_mesh_rank, *shape, backend=backend,
                          device=device, timeout=600.0,
                          init_file=str(Path(root) / f"store-{shape}"),
                          args=(root, device, jobs))
        return recs, time.perf_counter() - t0

    def bars(name, rec, want, what):
        """The reference's bars between two solvers' traces
        (tests/test_sharded_engine.py:65-89); returns the largest
        differences."""
        err, res = np.asarray(rec["err"]), np.asarray(rec["res"])
        w_err, w_res = np.asarray(want["err"]), np.asarray(want["res"])
        d_err = float(np.max(np.abs(err - w_err)))
        d_res = float(np.max(np.abs(res - w_res)))
        if not (d_err < 0.02 and d_res < 0.15
                and res[-1] < max(2 * w_res[-1], 0.15)):
            raise AssertionError(f"{name}: traces outside the bars against "
                                 f"{what} (error {d_err:.3e}, residual "
                                 f"{d_res:.3e})")
        return d_err, d_res

    def same_engine(name, rec, want, what):
        """One engine on two grids (the sums run in another order): the
        traces within 1e-4, the bar of the elastic resume check below;
        returns the largest differences."""
        d_err = float(np.max(np.abs(np.asarray(rec["err"])
                                    - np.asarray(want["err"]))))
        d_res = float(np.max(np.abs(np.asarray(rec["res"])
                                    - np.asarray(want["res"]))))
        if max(d_err, d_res) > 1e-4:
            raise AssertionError(f"{name}: traces differ from {what} by "
                                 f"{d_err:.3e} (error) / {d_res:.3e} "
                                 "(residual) > 1e-4")
        return d_err, d_res

    def check_ranks(name, recs, fused, relu_topk=0):
        for rank, rec in enumerate(recs):
            got = rec["launches"]
            # (on the CPU the plain versions run, and count nothing)
            if device != "cpu" and (got["bsr_spmm_gram"] != fused
                                    or got["relu_topk"] != relu_topk):
                raise AssertionError(
                    f"{name} rank {rank}: bsr_spmm_gram {got['bsr_spmm_gram']}"
                    f" (want {fused}), relu_topk {got['relu_topk']} (want "
                    f"{relu_topk})")
            if rec["health"] != -1 or not rec["finite"]:
                raise AssertionError(f"{name} rank {rank} is unhealthy")
            if rec["err"] != recs[0]["err"]:
                raise AssertionError(f"{name}: ranks disagree on the trace")

    def report(name, recs, secs, timed):
        """Each rank's fit (launches, collectives, peak memory, wall time
        with its ingest) and its engine timed without the ingest."""
        for rank, (rec, t) in enumerate(zip(recs, timed)):
            c = rec["collectives"]
            rec["engine"] = t
            log(f"[mesh] {name} rank {rank}: the fit {rec['wall_s']:.2f} s "
                f"(ingest included), launches {rec['launches']}, all_reduce "
                f"{c['all_reduce']} calls / {c['bytes']} bytes, peak "
                f"{rec['peak_mb']:.1f} MiB; the engine {t['iter_ms']:.3f} ms"
                f" an iteration, {t['all_reduce']:.0f} all_reduce / "
                f"{t['bytes']:.0f} bytes an iteration")
            win = t.get("profile")
            if win:
                log(f"[mesh] {name} rank {rank} profile (5 iterations): "
                    f"{win['window_ms']:.3f} ms wall, {win['busy_ms']:.3f} ms"
                    f" busy ({100 * win['busy_share']:.1f}%), "
                    f"{win['kernels']:.0f} kernels an iteration; collective "
                    f"host ms an iteration {win['all_reduce_host_ms']}; top "
                    f"{win['top']}")
        rec = recs[0]
        log(f"[mesh] {name}: final error {rec['err'][-1]:.6f}, NNZ(U) "
            f"{rec['nnz_u'][-1]} (t_u {T_U}, tau's bin holds "
            f"{rec['pop_u']}), NNZ(V) {rec['nnz_v'][-1]} (t_v {T_V}, tau's "
            f"bin holds {rec['pop_v']}); spawn to result {secs:.1f} s")
        out[name] = dict(
            ranks=[{k: v for k, v in r.items() if k not in ("u", "v")}
                   for r in recs], seconds=secs)

    phase3 = dict(err=res3.error.tolist(), res=res3.residual.tolist())
    # -- 19(a). 1x1 under NCCL (world 1) -------------------------------------
    timed = lambda shape: ("engine", dict(fit, mesh_shape=shape, iters=20,
                                          engine=True))
    (a1,), secs = spawn((1, 1), one_rank_backend,
                        [("fit", fit), timed((1, 1))])
    check_ranks("1x1 nccl", [a1["fit"]], 2 * ITERS + 1)
    d = bars("1x1 nccl", a1["fit"], phase3, "phase 3")
    report("1x1 nccl", [a1["fit"]], secs, [a1["engine"]])
    log(f"[mesh] 1x1 nccl against phase 3: error {d[0]:.3e}, residual "
        f"{d[1]:.3e}")
    paths["mesh_fit_1x1"] = a1["fit"]["launches"]

    # -- 19(b)-(d). 2x2: the fit, torch-csr, the streamed fit, the kill ------
    stream = dict(k=K, iters=10, solver="streaming", backend="cuda-bsr",
                  mesh_shape=(2, 2))
    jobs = [("fit", dict(fit, mesh_shape=(2, 2))), timed((2, 2)),
            ("csr", dict(fit, mesh_shape=(2, 2), iters=UNFUSED_ITERS,
                         backend="torch-csr")),
            ("stream", stream),
            ("stream_off", dict(stream, prefetch=False)),
            ("kill", dict(fit, mesh_shape=(2, 2), checkpoint_dir=ckpt,
                          checkpoint_every=10, kill_at=30))]
    r22, secs = spawn((2, 2), "gloo", jobs)
    fits = [r["fit"] for r in r22]
    check_ranks("2x2 gloo", fits, 2 * ITERS + 1)
    p22 = bars("2x2 gloo", fits[0], phase3, "phase 3")
    d22 = same_engine("2x2 gloo", fits[0], a1["fit"], "19(a)")
    report("2x2 gloo", fits, secs, [r["engine"] for r in r22])
    paths["mesh_fit"] = fits[0]["launches"]
    csr_err = np.asarray(r22[0]["csr"]["err"])
    csr_diff = float(np.max(np.abs(
        csr_err - np.asarray(fits[0]["err"][:UNFUSED_ITERS]))))
    if csr_diff > 1e-4:
        raise AssertionError(f"sharded[torch-csr] 2x2 differs from cuda-bsr "
                             f"by {csr_diff:.3e}")
    streams = [r["stream"] for r in r22]
    n_chunks = streams[0]["n_iter"]
    check_ranks("2x2 stream", streams, 2 * 10 * n_chunks, relu_topk=1)
    for rank, r in enumerate(r22):
        on, off = r["stream"], r["stream_off"]
        same = all(on[key] == off[key] for key in ("err", "res", "nnz_u",
                                                   "nnz_v"))
        if rank == 0:
            same = same and np.array_equal(on["u"], off["u"]) \
                and np.array_equal(on["v"], off["v"])
        if not same:
            raise AssertionError(f"2x2 stream rank {rank}: prefetch on and "
                                 "off differ")
        if not r["kill"].get("killed"):
            raise AssertionError("the 2x2 fit was not killed at 30")
    pf = streams[0]["stream_stats"]["fit"]
    log(f"[mesh] 2x2 against phase 3: error {p22[0]:.3e}, residual "
        f"{p22[1]:.3e}; against 19(a): error {d22[0]:.3e}, residual "
        f"{d22[1]:.3e}; sharded[torch-csr] {UNFUSED_ITERS} iterations "
        f"within {csr_diff:.3e} of cuda-bsr "
        f"({r22[0]['csr']['ms_per_iter']:.2f} ms an iteration, ingest "
        "included)")
    log(f"[mesh] 2x2 streamed fit: {n_chunks} chunks, prefetch on and off "
        f"bitwise equal (U, V, traces); {streams[0]['wall_s']:.2f} s on, "
        f"{r22[0]['stream_off']['wall_s']:.2f} s off; launches per rank "
        f"{streams[0]['launches']}; PackedChunk packing {pf['pack_s']:.2f} "
        f"s, stalled {pf['stall_s']:.2f} s")
    out["stream"] = dict(
        ranks=[{k: v for k, v in r["stream"].items() if k not in ("u", "v")}
               for r in r22],
        off_s=r22[0]["stream_off"]["wall_s"])
    out["csr_diff"] = csr_diff
    paths["mesh_stream"] = streams[0]["launches"]

    # -- 19(b), (d). 4x1, and the 2x2 kill resumed there --------------------
    r41, secs = spawn((4, 1), "gloo",
                      [("fit", dict(fit, mesh_shape=(4, 1))), timed((4, 1)),
                       ("resumed", dict(fit, mesh_shape=(4, 1),
                                        checkpoint_dir=ckpt,
                                        checkpoint_every=10, resume=True))])
    fits41 = [r["fit"] for r in r41]
    check_ranks("4x1 gloo", fits41, 2 * ITERS + 1)
    p41 = bars("4x1 gloo", fits41[0], phase3, "phase 3")
    d41 = same_engine("4x1 gloo", fits41[0], a1["fit"], "19(a)")
    report("4x1 gloo", fits41, secs, [r["engine"] for r in r41])
    log(f"[mesh] 4x1 against phase 3: error {p41[0]:.3e}, residual "
        f"{p41[1]:.3e}; against 19(a): error {d41[0]:.3e}, residual "
        f"{d41[1]:.3e}")
    resumed = [r["resumed"] for r in r41]
    check_ranks("resumed 2x2 -> 4x1", resumed, 2 * (ITERS - 30) + 1)
    d_res = float(np.max(np.abs(np.asarray(resumed[0]["err"])
                                - np.asarray(fits[0]["err"]))))
    d_rres = float(np.max(np.abs(np.asarray(resumed[0]["res"])
                                 - np.asarray(fits[0]["res"]))))
    if resumed[0]["n_iter"] != ITERS or max(d_res, d_rres) > 1e-4:
        raise AssertionError(f"killed on 2x2, resumed on 4x1: n_iter "
                             f"{resumed[0]['n_iter']}, traces differ from the"
                             f" uninterrupted 2x2 fit by {d_res:.3e} / "
                             f"{d_rres:.3e}")
    log(f"[mesh] killed on 2x2 at snapshot 30, resumed on 4x1: traces "
        f"within {d_res:.3e} (error) / {d_rres:.3e} (residual) of the "
        f"uninterrupted 2x2 fit; resumed launches "
        f"{resumed[0]['launches']}")
    out["against_1x1"] = {"2x2": d22, "4x1": d41}
    out["elastic"] = dict(err_diff=d_res, res_diff=d_rres,
                          launches=resumed[0]["launches"])

    # -- 19(e). the command line under torch.distributed.run ----------------
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--standalone", "--nproc-per-node", "4",
           "-m", "repro_torch.launch.nmf_run", "--solver", "distributed",
           "--backend", "cuda-bsr", "--mesh", "2x2", "--dist-backend",
           "gloo", "--small"] + (["--device", "cpu"] if device == "cpu"
                                  else [])
    t0 = time.perf_counter()
    cli = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    cli_s = time.perf_counter() - t0
    if cli.returncode != 0:
        raise AssertionError(f"torch.distributed.run of the command line "
                             f"exited {cli.returncode}: {cli.stderr[-3000:]}")
    fit_line = [ln for ln in cli.stdout.splitlines()
                if ln.startswith("solver=")]
    log(f"[mesh] python -m torch.distributed.run --nproc-per-node 4 -m "
        f"repro_torch.launch.nmf_run --solver distributed --backend cuda-bsr"
        f" --mesh 2x2 --dist-backend gloo --small: exit 0 in {cli_s:.1f} s;"
        f" {fit_line}")
    out["cli"] = dict(seconds=cli_s, line=fit_line)
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] phase 19 took {out['seconds']:.1f} s (four ranks share one "
        "card over gloo: the 2x2 / 4x1 times are not a multi-card result)")


def run_topic_slice(dev, model, new_sp, paths, results):
    """Phase 18: a TopicServer over phase 3's model (as phase 14 left it)
    serves phase 5's held-out documents, against a CPU copy of the model;
    then refresh folds them in on the card, once made unhealthy on purpose
    (rolled back) and once for real."""
    import warnings

    import torch

    from repro_torch.convert import estimator_from_reference
    from repro_torch.kernels import _build
    from repro_torch.serving import TopicRequest, TopicServer

    out = results["topic_slice"] = {}
    csc = new_sp.tocsc()
    docs = [list(zip(csc.indices[csc.indptr[j]:csc.indptr[j + 1]].tolist(),
                     csc.data[csc.indptr[j]:csc.indptr[j + 1]].tolist()))
            for j in range(csc.shape[1])]
    cpu_model = estimator_from_reference(
        model.u_.cpu().numpy(), model.v_.cpu().numpy(), model._m_ref,
        model.config, device="cpu", av=model._av_acc.cpu().numpy(),
        gv=model._gv_acc.cpu().numpy(), n_docs_seen=model.n_docs_seen_)

    def serve(server):
        for rid, terms in enumerate(docs):
            server.submit(TopicRequest(rid=rid, terms=terms, top=K))
        return {r.rid: r.topics for r in server.run_until_drained()}

    warm = TopicServer(model, max_batch=32)
    for rid in range(min(64, len(docs))):
        warm.submit(TopicRequest(rid=rid, terms=docs[rid], top=K))
    warm.run_until_drained()
    srv = TopicServer(model, max_batch=32)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = serve(srv)
    serve_s = time.perf_counter() - t0
    paths["topic_ticks"] = counts = _build.launch_counts()
    ticks = srv.stats["ticks"]
    want = serve(TopicServer(cpu_model, max_batch=32))
    worst, with_topics = 0.0, 0
    for rid, picks in want.items():
        g, w = dict(got[rid]), dict(picks)
        diff = max([abs(g.get(t, 0.0) - w.get(t, 0.0))
                    for t in set(g) | set(w)] or [0.0])
        worst = max(worst, diff)
        rank = {t: i for i, (t, _) in enumerate(got[rid])}
        for a in w:
            for b in w:
                if w[a] - w[b] > 1e-4 and a in rank and b in rank \
                        and rank[a] > rank[b]:
                    raise AssertionError(f"request {rid}: topics {a}, {b} "
                                         "ordered unlike the CPU copy")
        with_topics += bool(picks)
    if worst > 1e-4:
        raise AssertionError(f"TopicServer loadings differ from the CPU "
                             f"copy by {worst:.3e} > 1e-4")
    if ticks != -(-len(docs) // 32) or counts["bsr_spmm"] != ticks \
            or counts["relu_topk"] != ticks:
        raise AssertionError(f"{ticks} ticks launched {counts}, not one "
                             "bsr_spmm and one relu_topk a tick")
    st = srv.stats
    tick_ms = 1e3 * serve_s / ticks
    split = {k: 1e3 * st[k] / ticks for k in ("pack_s", "ingest_s",
                                              "device_s")}
    log(f"[topics] TopicServer, {len(docs)} requests, max_batch 32: {ticks} "
        f"ticks in {serve_s:.3f} s, {tick_ms:.3f} ms a tick (host packing "
        f"{split['pack_s']:.3f} + ingest {split['ingest_s']:.3f} ms, the "
        f"card's part {split['device_s']:.3f} ms), "
        f"{len(docs) / serve_s:.0f} requests/s; launches {counts} (one "
        f"bsr_spmm and one relu_topk a tick); loadings within {worst:.3e} "
        f"of a CPU copy, topic ids alike; {with_topics} requests got a topic"
        f" (t_v = {T_V} over {N_DOCS} documents: ~0.1 a document)")
    # refresh, made unhealthy on purpose: rolled back, U bitwise as before
    u_before = model.u_.clone()
    orig = model.partial_fit

    def poisoned_fit(*args, **kwargs):
        orig(*args, **kwargs)
        model.u_ = model.u_ * float("nan")
        model.health_ = torch.zeros((), dtype=torch.int32, device=dev)

    model.partial_fit = poisoned_fit
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            folded = srv.refresh()
    finally:
        model.partial_fit = orig
    if (folded != 0 or srv.refresh_failures != 1
            or not torch.equal(model.u_, u_before)
            or not any("rolled back" in str(x.message) for x in w)):
        raise AssertionError("the unhealthy refresh was not rolled back")
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    folded = srv.refresh()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    paths["refresh"] = rc = _build.launch_counts()
    health = int(model.health_)
    if folded != len(docs) or health != -1:
        raise AssertionError(f"refresh folded {folded} documents, health "
                             f"{health}")
    if rc["bsr_spmm_gram"] != 20 or rc["relu_topk"] != 20:
        raise AssertionError(f"refresh launched {rc}, not 20 bsr_spmm_gram "
                             "and 20 relu_topk")
    log(f"[topics] refresh made unhealthy on purpose: rolled back (U bitwise"
        f" as before, refresh_failures {srv.refresh_failures}); the retry "
        f"folded {folded} documents in {refresh_s:.3f} s on the card, health "
        f"{health}, launches {rc}")
    out.update(ticks=ticks, serve_s=serve_s, tick_ms=tick_ms,
               split_ms=split, requests_per_s=len(docs) / serve_s,
               launches=counts, max_loading_diff=worst,
               requests_with_topics=with_topics, refresh_s=refresh_s,
               refresh_launches=rc)


def run_tile_slice(dev, a_sp, op, res3, u0, paths, results, rows):
    """Phase 20: the tile sweep on the card into a temporary ledger at
    PubMed's shape (k = 5 and k = 256) and a fit at the winner's tiles;
    bf16 operands against their plain versions at PubMed shapes; the fused
    half-step at k = 33, 40 and 128 and a k = 128 fit against the unfused
    one.  Adds the bf16 and wide-k numbers to ``rows``."""
    import os
    import tempfile

    import torch

    from repro_torch.backend import get_backend
    from repro_torch.kernels import _build, autotune, ref
    from repro_torch.kernels.bsr import bsr_operand
    from repro_torch.kernels.bsr_spmm import bsr_spmm, resolve_kb
    from repro_torch.kernels.fused import bsr_spmm_gram
    from repro_torch.kernels.gram import gram
    from repro_torch.kernels.project_mask import relu_topk
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity

    out = results["phases"].setdefault("tiles", {})
    t_phase = time.perf_counter()
    bf16 = torch.bfloat16

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def bits(x):
        return x.contiguous().view(torch.int16 if x.dtype == bf16
                                   else torch.int32)

    # -- 20(a). the sweep, into a temporary ledger ----------------------------
    ledger = Path(tempfile.mkdtemp()) / "ledger.json"
    saved = os.environ.get("REPRO_TORCH_AUTOTUNE_LEDGER")
    os.environ["REPRO_TORCH_AUTOTUNE_LEDGER"] = str(ledger)
    autotune._CACHE.clear()
    kind = autotune.device_kind(dev)
    sweeps = {}
    try:
        for k in (K, 256):
            def show(rec, k=k):
                fused = ("not fused" if rec["fused_us"] is None
                         else f"fused {rec['fused_us']:.1f} us")
                log(f"[tiles] k={k} bm={rec['bm']} bk={rec['bk']} "
                    f"kb={rec['kb']}: {fused}, plain {rec['spmm_us']:.1f} "
                    f"us, bound {rec['roofline_us']:.1f} us (the half-step "
                    "pair A @ V + A^T @ U)")

            t0 = time.perf_counter()
            entry = autotune.autotune(N_TERMS, N_DOCS, k, a=a_sp, repeats=3,
                                      device=dev, log=show)
            if entry["source"] != "autotune":
                raise AssertionError(f"the sweep at k = {k} timed nothing")
            keys = [f"{kind}/{autotune.shape_bucket(N_TERMS, N_DOCS, k)}"]
            if k == K:  # the ingest bucket: PubMed's own rank's winner
                keys.append(f"{kind}/"
                            f"{autotune.shape_bucket(N_TERMS, N_DOCS, None)}")
            for key in keys:
                autotune.update_ledger(key, entry)
            won = autotune.resolve_tiles(N_TERMS, N_DOCS, k, device=kind)
            if (won.bm, won.bk, won.kb) != (entry["bm"], entry["bk"],
                                            entry["kb"]):
                raise AssertionError(f"resolve_tiles at k = {k} returned "
                                     f"{won}, not the sweep's winner")
            sweeps[k] = dict(entry, seconds=time.perf_counter() - t0)
            log(f"[tiles] k={k}: winner bm={entry['bm']} bk={entry['bk']} "
                f"kb={entry['kb']} ({entry['swept']} candidates, "
                f"{sweeps[k]['seconds']:.1f} s); resolve_tiles returns it")
        # a 50-iteration PubMed fit at the k = 5 winner's tiles
        cfg = NMFConfig(k=K, iters=ITERS, backend="cuda-bsr",
                        sparsity=Sparsity(t_u=T_U, t_v=T_V))
        fit = EnforcedNMF(cfg, device=dev).fit(a_sp, u0=u0)
        win = sweeps[K]
        default = (win["bm"], win["bk"]) == (op.bsr.bm, op.bsr.bk)
        derr = float((fit.result_.error - res3.error).abs().max())
        dres = float((fit.result_.residual - res3.residual).abs().max())
        if default:
            if not (torch.equal(fit.result_.error, res3.error)
                    and torch.equal(fit.result_.residual, res3.residual)):
                raise AssertionError("the fit at the default tiles is not "
                                     "bitwise phase 3's")
        elif max(derr, dres) > 1e-4:
            raise AssertionError(f"the fit at the winner's tiles parts from "
                                 f"phase 3's by {derr:.3e} / {dres:.3e}")
        log(f"[tiles] 50-iteration fit at the k = {K} winner's tiles "
            f"({win['bm']} x {win['bk']}): error / residual traces against "
            f"phase 3's {derr:.3e} / {dres:.3e}"
            + (" (bitwise: phase 3's tiles)" if default else ""))
        out["sweep"] = {str(k): v for k, v in sweeps.items()}
        out["fit_at_winner"] = dict(error_diff=derr, residual_diff=dres)
        out["ledger"] = json.loads(ledger.read_text())
    finally:
        if saved is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_LEDGER", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_LEDGER"] = saved
        autotune._CACHE.clear()

    # -- 20(b). bf16 against the plain versions at PubMed shapes ------------
    gen = torch.Generator().manual_seed(20)
    op16 = get_backend("cuda-bsr").prepare(a_sp, dtype=bf16, device=dev)
    u16 = torch.rand((N_TERMS, K), generator=gen).to(dev, bf16)
    v16 = torch.rand((N_DOCS, K), generator=gen).to(dev, bf16)
    bf = {}
    # each kernel against its plain bf16 version (the same f32 math, one
    # rounding to bf16 at the end: a bf16 ulp, 2^-7 relative, apart at the
    # most) and against f32 math at the reference's bar
    errs = {"bsr_spmm": [], "bsr_spmm_gram": [], "gram": [],
            "project_mask": []}
    f32_errs = {"bsr_spmm": [], "bsr_spmm_gram": []}
    per = {"bsr_spmm": [], "bsr_spmm_gram": []}
    lib_bf = []
    for o, b, w in (("A@V", op16.bsr, v16), ("A^T@U", op16.bsr_t, u16)):
        f32_math = ref.bsr_spmm_ref(
            dataclasses.replace(b, tiles=b.tiles.float()), w.float())
        _build.reset_launch_counts()
        y = bsr_spmm(b, w)
        y_f, g_f = bsr_spmm_gram(b, w)
        if _build.launch_counts()["bsr_spmm_gram"] != 1:
            raise AssertionError("bf16 bsr_spmm_gram: not one launch")
        if y.dtype != bf16 or not torch.equal(bits(y_f), bits(y)):
            raise AssertionError("bf16 bsr_spmm_gram's product is not "
                                 "bitwise bsr_spmm's")
        plain_y, plain_g = ref.bsr_spmm_gram_ref(b, w)
        errs["bsr_spmm"].append(close(f"bf16 bsr_spmm {o}", y,
                                      ref.bsr_spmm_ref(b, w), 1e-2, 1e-3))
        errs["bsr_spmm_gram"] += [
            close(f"bf16 bsr_spmm_gram y {o}", y_f, plain_y, 1e-2, 1e-3),
            close(f"bf16 bsr_spmm_gram gram {o}", g_f, plain_g, 1e-5, 1e-4)]
        f32_errs["bsr_spmm"].append(close(f"bf16 bsr_spmm {o} (f32 math)", y,
                                          f32_math, 5e-2, 1e-1))
        f32_errs["bsr_spmm_gram"].append(close(
            f"bf16 bsr_spmm_gram y {o} (f32 math)", y_f, f32_math, 5e-2,
            1e-1))
        tiles = int((b.tiles != 0).flatten(2).any(-1).sum())
        flops = 2.0 * tiles * b.bm * b.bk * K
        nbytes = 2 * (tiles * b.bm * b.bk + w.numel() + b.shape[0] * K) + (
            4 * b.nrb * b.bcap)
        flagged = int((b.gram_flags != 0).sum())
        per["bsr_spmm"].append(dict(
            ms=cuda_ms(lambda: bsr_spmm(b, w)),
            plain_ms=cuda_ms(lambda: ref.bsr_spmm_ref(b, w), reps=5),
            bound=bound_ms(nbytes, flops, BF16_FLOPS)))
        per["bsr_spmm_gram"].append(dict(
            ms=cuda_ms(lambda: bsr_spmm_gram(b, w)),
            plain_ms=cuda_ms(lambda: ref.bsr_spmm_gram_ref(b, w), reps=5),
            bound=bound_ms(nbytes + 4 * K * K,
                           flops + 2.0 * flagged * b.bk * K * K,
                           BF16_FLOPS)))
        try:
            call, fn = _lib_spmm(b, w, a_sp, dev)
            lib_bf.append((call, cuda_ms(fn, reps=5)))
        except (RuntimeError, NotImplementedError) as exc:
            log(f"[library] no bf16 sparse product on the card ({exc})")
            lib_bf.append((None, None))
    for name, items in per.items():
        bf[name] = dict(
            ms=float(np.mean([i["ms"] for i in items])),
            plain_ms=float(np.mean([i["plain_ms"] for i in items])),
            bound_ms=float(np.mean([i["bound"][0] for i in items])),
            bound_by=items[0]["bound"][1], f32_ms=rows[name]["ms"],
            library_ms=None,
            max_abs_err_f32_math=max(f32_errs[name]))
    if all(t is not None for _, t in lib_bf):
        bf["bsr_spmm"]["library_ms"] = float(np.mean([t for _, t in lib_bf]))
    bf["bsr_spmm"]["library_call"] = [c for c, _ in lib_bf]
    # gram at k = 5 and 256
    g_bf = {}
    for k in (K, 256):
        w = torch.randn((N_TERMS, k), generator=gen).to(dev, bf16)
        g = gram(w)
        if g.dtype != torch.float32 or not torch.equal(gram(w), g):
            raise AssertionError(f"bf16 gram at k = {k}: not f32 or not "
                                 "bitwise repeatable")
        errs["gram"].append(close(f"bf16 gram k={k}", g, ref.gram_ref(w),
                                  1e-4, 1e-3))
        wf = w.float()
        g_bf[k] = dict(
            ms=cuda_ms(lambda: gram(w), reps=50),
            plain_ms=cuda_ms(lambda: ref.gram_ref(w), reps=20),
            f32_ms=cuda_ms(lambda: gram(wf), reps=50),
            library_ms=cuda_ms(lambda: w.T @ w, reps=50))
        g_bf[k]["bound_ms"], g_bf[k]["bound_by"] = bound_ms(
            2 * N_TERMS * k + 4 * k * k, gram_flops(N_TERMS, k), BF16_FLOPS)
    bf["gram"] = dict(g_bf[K], k256=g_bf[256])
    # relu_topk at PubMed's U and V and at 4,000,000 x 8 (the grid)
    epi = {}
    for name in ("PubMed U", "PubMed V", "beyond on-chip"):
        n, k, t = EPILOGUE_SHAPES[name]
        x = (torch.randn((n, k), generator=gen) - 0.25).to(dev, bf16)
        want_out, want_tau = ref.relu_topk_ref(x, t)
        _build.reset_launch_counts()
        got_out, got_tau = relu_topk(x, t)
        if _build.launch_counts()["relu_topk"] != 1:
            raise AssertionError("bf16 relu_topk: not one launch")
        if not (torch.equal(bits(got_tau), bits(want_tau))
                and torch.equal(bits(got_out), bits(want_out))):
            raise AssertionError(f"bf16 relu_topk {name}: tau or out is not "
                                 "bitwise the plain version's")
        errs["project_mask"].append(float(
            (got_out.float() - want_out.float()).abs().max()))
        xf = x.float()
        epi[name] = dict(ms=cuda_ms(lambda: relu_topk(x, t)),
                         f32_ms=cuda_ms(lambda: relu_topk(xf, t)),
                         plain_ms=cuda_ms(lambda: ref.relu_topk_ref(x, t),
                                          reps=3),
                         bound_ms=1e3 * 4 * n * k / HBM_BYTES_PER_S,
                         tau=float(want_tau))
        log(f"[bf16] relu_topk {name} ({n} x {k}): tau and out bitwise the "
            f"plain bf16 version's, one launch; {epi[name]['ms']:.4f} ms "
            f"(f32 {epi[name]['f32_ms']:.4f} ms, plain "
            f"{epi[name]['plain_ms']:.4f} ms, bound "
            f"{epi[name]['bound_ms']:.6f} ms)")
        del x, xf, want_out, got_out
    bf["project_mask"] = dict(
        ms=float(np.mean([epi[n]["ms"] for n in ("PubMed U", "PubMed V")])),
        f32_ms=float(np.mean([epi[n]["f32_ms"]
                              for n in ("PubMed U", "PubMed V")])),
        plain_ms=float(np.mean([epi[n]["plain_ms"]
                                for n in ("PubMed U", "PubMed V")])),
        bound_ms=float(np.mean([epi[n]["bound_ms"]
                                for n in ("PubMed U", "PubMed V")])),
        bound_by="bytes", library_ms=None, grid_4m_x8=epi["beyond on-chip"])
    for name, r in bf.items():
        r["max_abs_err"] = max(errs[name])
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"[bf16] {name}: {r['ms']:.4f} ms (f32 {r['f32_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.6f} ms by {r.get('bound_by', 'bytes')}); max "
            f"abs err against the plain bf16 version {r['max_abs_err']:.3e} "
            "(bar rtol 1e-2, atol 1e-3 for the products, 1e-4 / 1e-3 for "
            "gram, 1e-5 / 1e-4 for the fused Gram, bitwise for the mask)"
            + (f"; against f32 math {r['max_abs_err_f32_math']:.3e} (bar "
               "rtol 5e-2, atol 1e-1)" if "max_abs_err_f32_math" in r
               else ""))
    log(f"[bf16] gram at k = 256: {g_bf[256]['ms']:.4f} ms (f32 "
        f"{g_bf[256]['f32_ms']:.4f} ms, u.T @ u {g_bf[256]['library_ms']:.4f}"
        f" ms, bound {g_bf[256]['bound_ms']:.4f} ms)")
    del op16
    out["bf16"] = bf

    # -- 20(c). the fused half-step past k = 32 -----------------------------
    # k = 128 fuses in both orientations at 64 x 64 tiles (up to k = 168;
    # at 128 x 64 A^T's 64 x 128 tiles take k <= 112)
    op64 = bsr_operand(a_sp, bm=64, bk=64, device=dev)
    be, unf = get_backend("cuda-bsr"), get_backend("cuda-bsr-unfused")
    wide = {}
    for k, o in ((33, op), (40, op), (128, op64)):
        v = torch.rand((N_DOCS, k), generator=gen).to(dev)
        b = o.bsr
        kb = resolve_kb(b, v, None)
        _build.reset_launch_counts()
        y, g = be.matmul_with_gram(o, v)
        counts = _build.launch_counts()
        if counts["bsr_spmm_gram"] != 1 or counts["gram"] != 0:
            raise AssertionError(f"cuda-bsr did not fuse at k = {k}: "
                                 f"{counts}")
        y_p = bsr_spmm(b, v, kb=kb)
        if not torch.equal(y, y_p):
            raise AssertionError(f"the fused product at k = {k} is not "
                                 "bitwise bsr_spmm's")
        err = close(f"fused gram k={k}", g, ref.gram_ref(v), 1e-5, 1e-4)
        wide[k] = dict(
            tiles=[b.bm, b.bk], kb=kb, gram_err=err,
            fused_ms=cuda_ms(lambda: bsr_spmm_gram(b, v, kb=kb), reps=5),
            unfused_ms=cuda_ms(lambda: unf.matmul_with_gram(o, v), reps=5),
            plain_ms=cuda_ms(lambda: bsr_spmm(b, v, kb=kb), reps=5))
        log(f"[wide] k={k} at {b.bm} x {b.bk}, kb={kb}: one bsr_spmm_gram "
            f"launch, "
            f"product bitwise bsr_spmm's, Gram max abs err {err:.3e}; fused "
            f"{wide[k]['fused_ms']:.4f} ms, unfused (bsr_spmm + gram) "
            f"{wide[k]['unfused_ms']:.4f} ms, bsr_spmm alone "
            f"{wide[k]['plain_ms']:.4f} ms (A @ V)")
    k = 128
    kcfg = NMFConfig(k=k, iters=3, sparsity=Sparsity(t_u=N_TERMS * k // 50,
                                                     t_v=N_DOCS * k // 50))
    u_k = torch.rand((N_TERMS, k), generator=gen).to(dev)
    fits = {}
    for name in ("cuda-bsr", "cuda-bsr-unfused"):
        _build.reset_launch_counts()
        fits[name], secs = wall(lambda: EnforcedNMF(
            kcfg.replace(backend=name), device=dev).fit(op64, u0=u_k))
        counts = _build.launch_counts()
        fits[name + "_s"], fits[name + "_launches"] = secs, counts
        if (counts["bsr_spmm_gram"] == 7) != (name == "cuda-bsr"):
            raise AssertionError(f"the k = 128 fit on {name}: launches "
                                 f"{counts}")
    kdiff = float((fits["cuda-bsr"].result_.error
                   - fits["cuda-bsr-unfused"].result_.error).abs().max())
    if kdiff > 1e-4 or int(fits["cuda-bsr"].result_.health) != -1:
        raise AssertionError(f"the fused k = 128 fit parts from the unfused "
                             f"one by {kdiff:.3e}")
    paths["fit_k128"] = fits["cuda-bsr_launches"]
    log(f"[wide] 3-iteration k = 128 fit at 64 x 64 tiles: cuda-bsr "
        f"{1e3 * fits['cuda-bsr_s'] / 3:.1f} ms an iteration (launches "
        f"{fits['cuda-bsr_launches']}), cuda-bsr-unfused "
        f"{1e3 * fits['cuda-bsr-unfused_s'] / 3:.1f} ms; error traces "
        f"within {kdiff:.3e}")
    k256 = results["stream_slice"]["k256"]
    log(f"[wide] k = 256 does not fuse (its Gram partial alone is 256 KB); "
        f"phase 16's k = 256 iteration {k256['fit_per_iter_ms']:.1f} ms at "
        f"kb = {k256['kb']}")
    out["wide"] = {str(k): v for k, v in wide.items()}

    # the widest rank the fused kernel takes at each tile shape and dtype,
    # launched there against the plain versions; one rank more is refused
    # by the wrapper and by the launch's own stage arithmetic
    widest = {}
    for bm, bk in ((128, 128), (128, 64), (128, 32), (64, 64)):
        b32 = {(128, 128): op.bsr, (64, 64): op64.bsr}.get((bm, bk))
        if b32 is None:
            b32 = bsr_operand(a_sp, bm=bm, bk=bk, device=dev).bsr
        for dt in (torch.float32, bf16):
            b = dataclasses.replace(b32, tiles=b32.tiles.to(dt))
            kmax = autotune.fused_max_k(bm, bk, b.tiles.element_size())
            v = torch.rand((N_DOCS, kmax + 1), generator=gen).to(dev, dt)
            vk = v[:, :kmax].contiguous()
            kb = resolve_kb(b, vk, None)
            name = f"{bm}x{bk} {str(dt).split('.')[1]}"
            _build.reset_launch_counts()
            y, g = bsr_spmm_gram(b, vk, kb=kb)
            if _build.launch_counts()["bsr_spmm_gram"] != 1:
                raise AssertionError(f"fused {name} k = {kmax}: not one "
                                     "launch")
            if not torch.equal(bits(y), bits(bsr_spmm(b, vk, kb=kb))):
                raise AssertionError(f"fused {name} k = {kmax}: the product "
                                     "is not bitwise bsr_spmm's")
            plain_y, plain_g = ref.bsr_spmm_gram_ref(b, vk)
            err = max(close(f"fused {name} k={kmax} y", y, plain_y,
                            *((1e-2, 1e-3) if dt == bf16 else (1e-5, 1e-4))),
                      close(f"fused {name} k={kmax} gram", g, plain_g, 1e-5,
                            1e-4))
            try:
                bsr_spmm_gram(b, v, kb=kb)
            except ValueError:
                pass
            else:
                raise AssertionError(f"fused {name}: the wrapper took k = "
                                     f"{kmax + 1}")
            rc = _fused_rc(b, v, kb)
            torch.cuda.synchronize()
            if rc == 0:
                raise AssertionError(f"fused {name}: the kernel launched at "
                                     f"k = {kmax + 1}")
            widest[name] = dict(k=kmax, kb=kb, max_abs_err=err,
                                refused_rc=rc,
                                ms=cuda_ms(lambda: bsr_spmm_gram(b, vk, kb=kb),
                                           reps=3, warmup=1))
            log(f"[wide] {name} tiles: fused at k = {kmax} (kb = {kb}), one "
                f"launch, product bitwise bsr_spmm's, max abs err against "
                f"the plain version {err:.3e}, {widest[name]['ms']:.4f} ms "
                f"(A @ V); k = {kmax + 1} refused by the wrapper and by the "
                f"launch (rc {rc})")
            del b, v, vk, y, g, plain_y, plain_g
        del b32
    out["widest_fused_k"] = widest
    out["fit_k128"] = dict(
        fused_ms_per_iter=1e3 * fits["cuda-bsr_s"] / 3,
        unfused_ms_per_iter=1e3 * fits["cuda-bsr-unfused_s"] / 3,
        error_diff=kdiff)
    del op64

    # the new fields of rows 1-4 of the kernels line
    for name in ("bsr_spmm", "bsr_spmm_gram", "gram", "project_mask"):
        rows[name].setdefault("extra", {})["bf16"] = {
            key: bf[name][key] for key in ("ms", "f32_ms", "plain_ms",
                                           "bound_ms", "library_ms",
                                           "max_abs_err")}
    rows["bsr_spmm_gram"]["extra"]["widest_fused_k"] = {
        name: w["k"] for name, w in widest.items()}
    rows["bsr_spmm_gram"]["extra"]["wide_k_ms"] = {
        str(k): wide[k]["fused_ms"] for k in wide}
    rows["bsr_spmm"]["extra"]["k256"] = dict(
        ms=k256["spmm_ms"], kb=k256["kb"], bound_ms=k256["spmm_bound_ms"],
        library_ms=k256["spmm_library_ms"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[tiles] phase 20 took {out['seconds']:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs the "
              "port on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    global HBM_BYTES_PER_S, F32_FLOPS, BF16_FLOPS
    from repro_torch.kernels.autotune import (
        BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S,
    )

    from repro_torch.backend import get_backend
    from repro_torch.convert import estimator_from_reference
    from repro_torch.core.nmf import init_u0, solve_gram
    from repro_torch.core.topk import FusedReluTopK, topk_project_bisect
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.device import configure_numerics
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.fused import bsr_spmm_gram
    from repro_torch.kernels.gram import gram
    from repro_torch.kernels.project_mask import (
        STEPS_PER_ROUND, project_mask, relu_topk, relu_topk_plan,
    )
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
    from repro_torch.sparse import to_scipy

    configure_numerics()
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    results = {"card": smi, "phases": {}}

    # -- 1. build ------------------------------------------------------------
    # a fresh build, so that ptxas reports every kernel of this checkout
    for source in _build.CSRC_DIR.glob("*.cu"):
        _build._target(source).unlink(missing_ok=True)
    t0 = time.perf_counter()
    report = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, rep in report.items():
        log(f"[build] {name}.cu: {rep['seconds']:.2f} s")
        for line in rep["log"].splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "Compiling" in line):
                log(f"[build]   {line.strip()}")
    log(f"[build] CUDA sources built in {build_s:.2f} s")
    results["phases"]["build_s"] = build_s

    # -- corpus and operand ---------------------------------------------------
    t0 = time.perf_counter()
    corpus, _ = synthetic_journal_corpus(n_terms=N_TERMS, n_docs=N_DOCS,
                                         n_journals=5)
    a_sp = to_scipy(corpus)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = get_backend("cuda-bsr").prepare(a_sp, device=dev)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    occ = {name: int((b.tiles != 0).flatten(2).any(-1).sum())
           for name, b in (("A", op.bsr), ("At", op.bsr_t))}
    log(f"[data] PubMed-shaped corpus {a_sp.shape}, nnz={a_sp.nnz}, "
        f"generated in {gen_s:.2f} s, BSR ingest {ingest_s:.2f} s; "
        f"A: nrb={op.bsr.nrb} bcap={op.bsr.bcap} occupied tiles={occ['A']}; "
        f"A^T: nrb={op.bsr_t.nrb} bcap={op.bsr_t.bcap} "
        f"occupied tiles={occ['At']}; coverage full: "
        f"{op.bsr.uncovered_rows is None and op.bsr_t.uncovered_rows is None}")
    results["data"] = dict(shape=list(a_sp.shape), nnz=int(a_sp.nnz),
                           gen_s=gen_s, ingest_s=ingest_s,
                           bcap_a=op.bsr.bcap, bcap_at=op.bsr_t.bcap,
                           occupied_tiles=occ)

    gen = torch.Generator().manual_seed(0)
    u0 = init_u0(gen, N_TERMS, K, device=dev)
    v_test = init_u0(gen, N_DOCS, K, device=dev)

    # -- 2. per-kernel checks at PubMed shapes -------------------------------
    checks = {}

    # the epilogue: relu_topk (tau and out) and project_mask bit for bit
    # their plain versions, one launch per call
    def bits(x):
        return x.contiguous().view(torch.int32)

    epi_checks = {}
    for name, (n, k, t) in EPILOGUE_SHAPES.items():
        x = (torch.randn((n, k), generator=gen) - 0.25).to(dev)
        want_out, want_tau = ref.relu_topk_ref(x, t)
        plan = relu_topk_plan(x.numel())
        _build.reset_launch_counts()
        out, tau = relu_topk(x, t)
        launches = _build.launch_counts()["relu_topk"]
        torch.cuda.synchronize()
        if launches != 1:
            raise AssertionError(f"relu_topk launched {launches} kernels in "
                                 "one call, not 1")
        if not (torch.equal(bits(tau), bits(want_tau))
                and torch.equal(bits(out), bits(want_out))):
            raise AssertionError(f"relu_topk {name}: tau or out is not "
                                 "bitwise the plain version's")
        mask = project_mask(x, want_tau)
        torch.cuda.synchronize()
        if not torch.equal(bits(mask),
                           bits(ref.project_mask_ref(x, want_tau))):
            raise AssertionError(f"project_mask {name} is not bitwise its "
                                 "plain version")
        nnz = int((out != 0).sum())
        epi_checks[name] = dict(shape=[n, k], t=t, nnz=nnz,
                                tau=float(want_tau), **plan)
        log(f"[check] relu_topk {name} ({n} x {k}, t={t}): {plan['path']} "
            f"path, {plan['exchange']} exchange over {plan['blocks']} blocks "
            f"({plan['resident']} of {plan['slice']} floats a block in shared"
            f" memory); tau and out bitwise the plain version's, one launch "
            f"(tau {float(want_tau):.9g}, NNZ {nnz}); project_mask bitwise")
        del x, want_out, want_tau, out, tau, mask
    if {c["path"] for c in epi_checks.values()} != {"resident", "streamed"}:
        raise AssertionError("the epilogue checks did not take both paths")
    checks["project_mask"] = 0.0
    errs = []
    for w in (u0, v_test):
        _build.reset_launch_counts()
        g1 = gram(w)
        if _build.launch_counts()["gram"] != 1:
            raise AssertionError(f"gram launched "
                                 f"{_build.launch_counts()['gram']} kernels "
                                 "in one call, not 1")
        if not torch.equal(gram(w), g1):
            raise AssertionError("gram is not bitwise repeatable")
        errs.append(close("gram", g1, ref.gram_ref(w), 1e-4, 1e-3))
    checks["gram"] = max(errs)
    errs = []
    for b, w in ((op.bsr, v_test), (op.bsr_t, u0)):
        y = bsr_spmm(b, w)
        if not torch.equal(bsr_spmm(b, w), y):
            raise AssertionError("bsr_spmm is not bitwise repeatable")
        errs.append(close("bsr_spmm", y, ref.bsr_spmm_ref(b, w), 1e-4, 1e-4))
    checks["bsr_spmm"] = max(errs)
    errs = []
    for b, w in ((op.bsr, v_test), (op.bsr_t, u0)):
        y, g = bsr_spmm_gram(b, w)
        y2, g2 = bsr_spmm_gram(b, w)
        if not (torch.equal(y2, y) and torch.equal(g2, g)):
            raise AssertionError("bsr_spmm_gram is not bitwise repeatable")
        if not torch.equal(y, bsr_spmm(b, w)):
            raise AssertionError("bsr_spmm_gram's product is not bitwise "
                                 "bsr_spmm's")
        y_ref, g_ref = ref.bsr_spmm_gram_ref(b, w)
        errs.append(close("bsr_spmm_gram y", y, y_ref, 1e-4, 1e-4))
        errs.append(close("bsr_spmm_gram gram", g, ref.gram_ref(w),
                          1e-5, 1e-4))
        errs.append(close("bsr_spmm_gram gram", g, g_ref, 1e-5, 1e-4))
    checks["bsr_spmm_gram"] = max(errs)
    torch.cuda.synchronize()
    for name, err in checks.items():
        log(f"[check] {name}: kernel == plain version at PubMed shapes "
            f"(max abs err {err:.3e})")
    log("[check] bsr_spmm and bsr_spmm_gram: two calls bitwise equal in "
        "both orientations; the fused Y bitwise bsr_spmm's")
    results["checks"] = checks
    results["epilogue_checks"] = epi_checks

    # -- 3. the main path: PubMed fit on cuda-bsr -----------------------------
    cfg = NMFConfig(k=K, iters=ITERS, sparsity=Sparsity(t_u=T_U, t_v=T_V),
                    backend="cuda-bsr")
    paths = {}
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = EnforcedNMF(cfg, device=dev).fit(a_sp, u0=u0)
    torch.cuda.synchronize()
    fit_wall_s = time.perf_counter() - t0
    paths["fit"] = _build.launch_counts()
    res = model.result_
    nu, nv = res.final_nnz_u, res.final_nnz_v
    finite = bool(torch.isfinite(model.u_).all() and
                  torch.isfinite(model.v_).all())
    health = int(res.health)
    log(f"[fit] cuda-bsr fit of {a_sp.shape} in {fit_wall_s:.2f} s (ingest "
        f"included): final error {res.final_error:.6f}, NNZ(U)={nu}, "
        f"NNZ(V)={nv}, health={health}, launches {paths['fit']}")
    if not finite or health != -1:
        raise AssertionError(f"unhealthy fit: finite={finite} "
                             f"health={health}")
    for nnz, t in ((nu, T_U), (nv, T_V)):
        if not t <= nnz <= t + max(2, t // 100):
            raise AssertionError(f"final NNZ {nnz} is not {t} up to ties")
    if paths["fit"]["bsr_spmm_gram"] != 2 * ITERS + 1:
        raise AssertionError(f"fused launches {paths['fit']['bsr_spmm_gram']}"
                             f" != 2 * iters + 1 = {2 * ITERS + 1}")
    if (paths["fit"]["relu_topk"] != 2 * ITERS
            or paths["fit"]["project_mask"] != 0):
        raise AssertionError(
            f"epilogue launches {paths['fit']['relu_topk']} != 2 * iters, "
            f"or {paths['fit']['project_mask']} other mask launches")
    # the fit's own epilogue against the eager bisection: its last U is
    # the epilogue of A V (V^T V)^-1 on its final V.  Recomputed with the
    # same kernels, relu_topk and the plain epilogue must both give it bit
    # for bit
    av, gv = get_backend("cuda-bsr").matmul_with_gram(op, model.v_)
    x_pre = solve_gram(gv, av)
    fit_out = relu_topk(x_pre, T_U)[0]
    plain_out = ref.relu_topk_ref(x_pre, T_U)[0]
    if not (torch.equal(bits(fit_out), bits(plain_out))
            and torch.equal(bits(plain_out), bits(model.u_))):
        raise AssertionError("the fit's last U is not bitwise the eager "
                             "plain epilogue of its own pre-epilogue factor")
    log("[fit] the last U is bitwise relu_topk's and the eager plain "
        "epilogue's output on the fit's own pre-epilogue factor "
        "A V (V^T V)^-1")
    del av, gv, x_pre, fit_out, plain_out

    # -- 4. cross-check against torch-dense -----------------------------------
    _build.reset_launch_counts()
    dense = EnforcedNMF(cfg.replace(iters=DENSE_ITERS, backend="torch-dense"),
                        device=dev).fit(a_sp, u0=u0)
    paths["dense_fit"] = _build.launch_counts()
    diff = (dense.result_.error - res.error[:DENSE_ITERS]).abs().max()
    diff = float(diff)
    log(f"[dense] torch-dense {DENSE_ITERS}-iteration error trace vs cuda-bsr:"
        f" max abs diff {diff:.3e}, launches {paths['dense_fit']}")
    if paths["dense_fit"]["relu_topk"] != 2 * DENSE_ITERS:
        raise AssertionError("the torch-dense fit did not run its epilogue "
                             "through relu_topk")
    if diff > 1e-4:
        raise AssertionError(f"cuda-bsr and torch-dense error traces differ "
                             f"by {diff:.3e} > 1e-4")
    results["dense_error_diff"] = diff
    del dense

    # -- 5. fold-in of unseen documents ---------------------------------------
    new_docs, _ = synthetic_journal_corpus(n_terms=N_TERMS, n_docs=NEW_DOCS,
                                           n_journals=5, seed=1)
    new_sp = to_scipy(new_docs)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    v_new = model.transform(new_sp)
    torch.cuda.synchronize()
    paths["transform"] = _build.launch_counts()
    cpu_model = estimator_from_reference(model.u_.cpu().numpy(),
                                         model.v_.cpu().numpy(), N_DOCS, cfg,
                                         device="cpu")
    v_cpu = cpu_model.transform(new_sp)
    fold_diff = float((v_new.cpu() - v_cpu).abs().max())
    log(f"[transform] {NEW_DOCS} unseen documents: V_new {tuple(v_new.shape)}"
        f", NNZ {int((v_new != 0).sum())}, max abs diff vs CPU fold-in "
        f"{fold_diff:.3e}, launches {paths['transform']}")
    if v_new.shape != (NEW_DOCS, K) or fold_diff > 1e-4:
        raise AssertionError("fold-in disagrees with the CPU fold-in")
    if paths["transform"]["bsr_spmm"] < 1:
        raise AssertionError("transform did not launch bsr_spmm")
    # the fold-in's epilogue is one relu_topk launch; V_new must be bitwise
    # the unfused epilogue (relu, then the eager bisection and mask) of the
    # same pre-epilogue loadings
    if paths["transform"]["relu_topk"] != 1:
        raise AssertionError("transform's epilogue was not one relu_topk "
                             "launch")
    be = get_backend("cuda-bsr")
    new_op = be.prepare(new_sp, device=dev)
    u_fit = model.u_
    raw = solve_gram(u_fit.T @ u_fit, be.matmul_t(new_op, u_fit))
    t_new = max(1, round(T_V * NEW_DOCS / N_DOCS))
    unfused_v = topk_project_bisect(torch.clamp_min(raw, 0.0), t_new)
    if not torch.equal(bits(v_new), bits(unfused_v)):
        raise AssertionError("transform's fused epilogue is not bitwise the "
                             "unfused one")
    fold = dict(
        ms=cuda_ms(lambda: model.transform(new_op), reps=20),
        eager_epilogue_ms=cuda_ms(lambda: topk_project_bisect(
            torch.clamp_min(raw, 0.0), t_new), reps=5),
        fused_epilogue_ms=cuda_ms(lambda: FusedReluTopK(t_new)(raw),
                                  reps=20))
    ingest_runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.transform(new_sp)
        torch.cuda.synchronize()
        ingest_runs.append(time.perf_counter() - t0)
    fold["with_ingest_s"] = float(np.median(ingest_runs))
    log(f"[transform] V_new bitwise the unfused epilogue (eager bisection, "
        f"t = {t_new}); fold-in of {NEW_DOCS} documents on the ingested "
        f"operand {fold['ms']:.4f} ms a call (its epilogue, one relu_topk "
        f"launch, {fold['fused_epilogue_ms']:.4f} ms; the eager epilogue it "
        f"replaces {fold['eager_epilogue_ms']:.4f} ms); from scipy, ingest "
        f"included, {fold['with_ingest_s']:.4f} s (median of 3)")
    results["fold_in"] = fold
    del new_op, raw, unfused_v

    # -- 6. unfused fit --------------------------------------------------------
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    unfused = EnforcedNMF(cfg.replace(iters=UNFUSED_ITERS,
                                      backend="cuda-bsr-unfused"),
                          device=dev).fit(op, u0=u0)
    torch.cuda.synchronize()
    paths["unfused_fit"] = _build.launch_counts()
    udiff = float((unfused.result_.error - res.error[:UNFUSED_ITERS]
                   ).abs().max())
    log(f"[unfused] {UNFUSED_ITERS}-iteration cuda-bsr-unfused fit: error "
        f"trace vs fused max abs diff {udiff:.3e}, launches "
        f"{paths['unfused_fit']}")
    if udiff > 1e-4:
        raise AssertionError("unfused and fused error traces differ")
    for name in ("bsr_spmm", "gram"):
        if paths["unfused_fit"][name] != 2 * UNFUSED_ITERS + 1:
            raise AssertionError(f"unfused fit launched {name} "
                                 f"{paths['unfused_fit'][name]} times")
    if paths["unfused_fit"]["relu_topk"] != 2 * UNFUSED_ITERS:
        raise AssertionError("the unfused fit did not run its epilogue "
                             "through relu_topk")
    results["paths"] = paths

    # -- 7. timings ------------------------------------------------------------
    u_fit, v_fit = model.u_, model.v_
    timing = {}
    # the BSR products: one call per orientation per half-step, so each
    # figure is the mean of the A @ V and A^T @ U calls of one iteration
    pairs = ((op.bsr, v_fit, occ["A"], a_sp.tocsr()),
             (op.bsr_t, u_fit, occ["At"], a_sp.T.tocsr()))

    spmm_bytes = lambda b, w, tiles, gram_out=False: _spmm_bytes(
        b, w, tiles, K, gram_out)
    lib_spmm = lambda b, w, sp: _lib_spmm(b, w, sp, dev)

    rows = {}
    per = {"bsr_spmm": [], "bsr_spmm_gram": []}
    lib_times, lib_calls = [], []
    for b, w, tiles, sp in pairs:
        flops = 2.0 * tiles * b.bm * b.bk * K
        per["bsr_spmm"].append(dict(
            ms=cuda_ms(lambda: bsr_spmm(b, w)),
            plain_ms=cuda_ms(lambda: ref.bsr_spmm_ref(b, w), reps=5),
            bound=bound_ms(spmm_bytes(b, w, tiles), flops)))
        flagged = int((b.gram_flags != 0).sum())
        per["bsr_spmm_gram"].append(dict(
            ms=cuda_ms(lambda: bsr_spmm_gram(b, w)),
            plain_ms=cuda_ms(lambda: ref.bsr_spmm_gram_ref(b, w), reps=5),
            bound=bound_ms(spmm_bytes(b, w, tiles, True),
                           flops + 2.0 * flagged * b.bk * K * K)))
        call, fn = lib_spmm(b, w, sp)
        lib_calls.append(call)
        lib_times.append(cuda_ms(fn, reps=5))
    for name, items in per.items():
        rows[name] = dict(
            ms=float(np.mean([i["ms"] for i in items])),
            plain_ms=float(np.mean([i["plain_ms"] for i in items])),
            bound_ms=float(np.mean([i["bound"][0] for i in items])),
            bound_by=items[0]["bound"][1],
            by_orientation={o: {"ms": i["ms"], "plain_ms": i["plain_ms"],
                                "bound_ms": i["bound"][0]}
                            for o, i in zip(("A@V", "A^T@U"), items)})
    for name in per:
        for (o, t), b, tiles in zip(rows[name]["by_orientation"].items(),
                                    (op.bsr, op.bsr_t),
                                    (occ["A"], occ["At"])):
            t["gb_per_s"] = 4 * tiles * b.bm * b.bk / (t["ms"] * 1e6)
            t["bound_share"] = t["bound_ms"] / t["ms"]
            log(f"[time] {name} {o}: {t['ms']:.4f} ms (plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; "
                f"{t['gb_per_s']:.1f} GB/s of occupied tiles, "
                f"{100 * t['bound_share']:.1f}% of the byte bound)")
    for o, t, lt in zip(("A@V", "A^T@U"), per["bsr_spmm"], lib_times):
        rows["bsr_spmm"]["by_orientation"][o]["library_ms"] = lt
        fused = rows["bsr_spmm_gram"]["by_orientation"][o]["ms"]
        log(f"[time] bsr_spmm {o}: {t['ms'] / lt:.3f}x the library call; "
            f"fused / plain {fused / t['ms']:.3f}")
    log(f"[time] library bsr_spmm {lib_calls}: "
        f"{[round(t, 4) for t in lib_times]} ms (A@V, A^T@U)")
    # the split's tail: each block's start and end (%globaltimer) in one
    # call per kernel and orientation
    tails = {}
    for name, fn in (("bsr_spmm", bsr_spmm), ("bsr_spmm_gram", bsr_spmm_gram)):
        for o, b, w in (("A@V", op.bsr, v_fit), ("A^T@U", op.bsr_t, u_fit)):
            st = torch.zeros((b.plan.runs, 2), dtype=torch.int64, device=dev)
            fn(b, w, stamps=st)
            torch.cuda.synchronize()
            t = st.cpu().numpy()
            end = (t[:, 1] - t[:, 0].min()) / 1e3
            tails[f"{name} {o}"] = tl = dict(
                runs=b.plan.runs, end_min_us=float(end.min()),
                end_median_us=float(np.median(end)),
                end_mean_us=float(end.mean()), end_max_us=float(end.max()),
                start_spread_us=float((t[:, 0].max() - t[:, 0].min()) / 1e3))
            log(f"[tail] {name} {o}: {tl['runs']} blocks end "
                f"{tl['end_min_us']:.1f} / {tl['end_median_us']:.1f} / "
                f"{tl['end_mean_us']:.1f} / {tl['end_max_us']:.1f} us (min /"
                f" median / mean / max) after the first start; starts "
                f"spread {tl['start_spread_us']:.1f} us; the mean end is "
                f"{100 * (1 - tl['end_mean_us'] / tl['end_max_us']):.1f}% "
                "short of the last")
    timing["bsr_tails"] = tails

    # a plain read of every stored tile: the rate this card reaches on
    # these bytes without any product
    read = [(cuda_ms(lambda: b.tiles.sum()), 4 * b.tiles.numel())
            for b in (op.bsr, op.bsr_t)]
    log(f"[time] torch.sum over the stored tiles (A, A^T): "
        f"{[round(t, 4) for t, _ in read]} ms, "
        f"{[round(nb / (t * 1e6), 1) for t, nb in read]} GB/s")
    timing["tiles_sum_ms"] = [t for t, _ in read]

    # what the BSR kernels were built into: registers and spills (ptxas),
    # asynchronous copies in the SASS (bulk copy UBLKCP, TMA UTMALDG,
    # cp.async LDGSTS); every kernel must stream its tiles by bulk copy, and
    # the f32 ones their slabs by cp.async (bf16 slabs are widened by the
    # producer lanes on their way to shared memory)
    bsr_sass = sass_counts(_build.library_path("bsr_spmm"),
                           ("UBLKCP", "UTMALDG", "LDGSTS"))
    bsr_ptxas = ptxas_report(report["bsr_spmm"]["log"])
    for fn, c in bsr_sass.items():
        p = bsr_ptxas.get(fn, {})
        log(f"[sass] {fn[-40:]}: {c['UBLKCP']} UBLKCP, {c['UTMALDG']} "
            f"UTMALDG, {c['LDGSTS']} LDGSTS; ptxas: {p.get('registers')} "
            f"registers, {p.get('stack_bytes')} bytes stack, "
            f"{p.get('spill_stores')} / {p.get('spill_loads')} bytes spill "
            "stores / loads")
    if not bsr_sass or any(
            c["UBLKCP"] + c["UTMALDG"] == 0
            or (c["LDGSTS"] == 0 and "bfloat16" not in fn)
            for fn, c in bsr_sass.items()):
        raise AssertionError("a BSR kernel has no bulk copy, or an f32 one "
                             "no cp.async, in its SASS")
    results["bsr_sass"] = bsr_sass
    results["bsr_ptxas"] = bsr_ptxas
    # the epilogue's instantiations: cluster barriers (UCGABAR), warp
    # reductions (REDUX) and shared loads (LDS) in the SASS, and ptxas
    mask_sass = sass_counts(_build.library_path("project_mask"),
                            ("UCGABAR_ARV", "UCGABAR_WAIT", "REDUX", "LDS"))
    mask_ptxas = ptxas_report(report["project_mask"]["log"])
    for fn, c in mask_sass.items():
        pr = mask_ptxas.get(fn, {})
        log(f"[sass] {fn[-48:]}: {c} ; ptxas: {pr.get('registers')} "
            f"registers, {pr.get('stack_bytes')} bytes stack, "
            f"{pr.get('spill_stores')} / {pr.get('spill_loads')} bytes spill "
            "stores / loads")
    results["mask_sass"] = mask_sass
    results["mask_ptxas"] = mask_ptxas
    rows["bsr_spmm"]["library_ms"] = float(np.mean(lib_times))
    rows["bsr_spmm"]["library_call"] = lib_calls
    rows["bsr_spmm_gram"]["library_ms"] = None

    # gram and u.T @ u are host-bound per call: 200 calls each, in turns
    # (kernel, library, library, kernel), so both see the same host load
    items = []
    for name, w in (("U", u_fit), ("V", v_fit)):
        n = w.shape[0]
        turns = [cuda_ms(lambda: gram(w), reps=200),
                 cuda_ms(lambda: w.T @ w, reps=200),
                 cuda_ms(lambda: w.T @ w, reps=200),
                 cuda_ms(lambda: gram(w), reps=200)]
        item = dict(ms=(turns[0] + turns[3]) / 2,
                    lib=(turns[1] + turns[2]) / 2,
                    plain_ms=cuda_ms(lambda: ref.gram_ref(w)),
                    bound=bound_ms(4 * (n * K + K * K), gram_flops(n, K)),
                    turns_ms=turns)
        items.append(item)
        log(f"[time] gram {name} ({n} x {K}): {item['ms']:.5f} ms, u.T @ u "
            f"{item['lib']:.5f} ms ({item['ms'] / item['lib']:.3f}x; turns "
            f"{[round(x, 5) for x in turns]} ms), plain "
            f"{item['plain_ms']:.5f} ms, bound {item['bound'][0]:.6f} ms")
    rows["gram"] = dict(ms=float(np.mean([i["ms"] for i in items])),
                        plain_ms=float(np.mean([i["plain_ms"] for i in items])),
                        library_ms=float(np.mean([i["lib"] for i in items])),
                        library_call="u.T @ u",
                        bound_ms=float(np.mean([i["bound"][0] for i in items])),
                        bound_by=items[0]["bound"][1],
                        by_shape={nm: {"ms": i["ms"], "library_ms": i["lib"],
                                       "turns_ms": i["turns_ms"]}
                                  for nm, i in zip(("U", "V"), items)})
    # the two epilogues of an iteration, FusedReluTopK on pre-epilogue
    # factors of the fit's shapes (mixed signs), for the fit's share below;
    # the epilogue's own timings come after the LM phases (phase 12)
    pre = {"U": (u_fit - 0.5 * u_fit.max(), T_U),
           "V": (v_fit - 0.5 * v_fit.max(), T_V)}
    epilogue = [cuda_ms(lambda xw=xw, t=t: FusedReluTopK(t)(xw), reps=200)
                for xw, t in pre.values()]

    # the fit itself, on the already-ingested operand: one warm-up, then
    # three timed fits (host clock, ending in a synchronize)
    timed = EnforcedNMF(cfg, device=dev)
    timed.fit(op, u0=u0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    fit_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        timed.fit(op, u0=u0)
        torch.cuda.synchronize()
        fit_runs.append(time.perf_counter() - t0)
    fit_s = float(np.median(fit_runs))
    per_iter_ms = 1e3 * fit_s / ITERS
    timing.update(fit_s=fit_s, fit_runs_s=fit_runs, per_iter_ms=per_iter_ms,
                  epilogue_ms=epilogue, epilogue_ms_per_iter=sum(epilogue),
                  epilogue_share=sum(epilogue) / per_iter_ms,
                  fit_peak_mem_bytes=torch.cuda.max_memory_allocated(),
                  resident_before_fit_bytes=base_mem)
    log(f"[time] cuda-bsr fit ({ITERS} iterations, operand ingested): "
        f"{fit_s * 1e3:.2f} ms (median of "
        f"{[round(1e3 * t, 2) for t in fit_runs]} ms), {per_iter_ms:.3f} ms "
        f"per iteration; its two epilogues (one relu_topk launch each, "
        f"bisection included) take {sum(epilogue):.4f} ms "
        f"({100 * sum(epilogue) / per_iter_ms:.1f}% of an iteration); "
        f"device memory peak during the fit "
        f"{timing['fit_peak_mem_bytes'] / 1e9:.3f} GB ({base_mem / 1e9:.3f} "
        f"GB resident before it)")

    # profiler window: device busy share and kernel launches per iteration
    prof_iters = 5
    prof_cfg = cfg.replace(iters=prof_iters)
    EnforcedNMF(prof_cfg, device=dev).fit(op, u0=u0)
    torch.cuda.synchronize()
    prof = profiled(f"{prof_iters}-iteration fit (set-up included)",
                    lambda: EnforcedNMF(prof_cfg, device=dev).fit(op, u0=u0))
    busy_ms = prof["device_busy_us"] / 1e3 / prof_iters
    log(f"[time] NMF iteration: device busy {busy_ms:.3f} ms per iteration "
        f"(profiler window, set-up included) beside {per_iter_ms:.3f} ms of "
        "wall time")
    timing.update(profile=prof, busy_ms_per_iter=busy_ms,
                  kernels_per_iter=prof["kernels_per_call"] / prof_iters)
    results["timing"] = timing

    # -- 8.-11. the LM serving slice ----------------------------------------------
    run_lm_slice(dev, paths, checks, rows, results)

    # -- 12. the epilogue's timings -------------------------------------------
    # after the LM phases, so that its profiler windows do not run before
    # them.  On the fit's pre-epilogue factors (U, V) and on the two checked
    # shapes beyond them: relu_topk per call (CUDA events) and on the device
    # (profiler), 40 steps against none (1 + ceil(40 / 3) barriers against
    # 2: the time per count round); the mask alone (tau given); the eager
    # plain epilogue (the bisection launched op by op, as FusedReluTopK ran
    # before this kernel); and, for orientation only, torch.topk of the
    # relu'd factor (exactly t, no ties: not the same function)
    rounds = 1 + max(1, -(-NUM_STEPS // STEPS_PER_ROUND))
    for name in ("Wikipedia U", "beyond on-chip"):
        n, k, t = EPILOGUE_SHAPES[name]
        pre[name] = ((torch.randn((n, k), generator=gen) - 0.25).to(dev), t)
    epi = {}
    for name, (xw, t) in pre.items():
        n = xw.numel()
        reps = 200 if n < 1_000_000 else 20
        _, tw = relu_topk(xw, t)
        full_us = device_us(lambda: relu_topk(xw, t), "relu_topk_kernel")
        none_us = device_us(lambda: relu_topk(xw, t, 0), "relu_topk_kernel")
        item = dict(
            shape=list(xw.shape), t=t, plan=relu_topk_plan(n),
            ms=cuda_ms(lambda: relu_topk(xw, t), reps=reps),
            device_us=full_us, zero_steps_device_us=none_us,
            barriers=rounds,
            per_round_ms=1e-3 * (full_us - none_us) / (rounds - 2),
            mask_ms=cuda_ms(lambda: project_mask(xw, tw), reps=reps),
            plain_ms=cuda_ms(lambda: ref.relu_topk_ref(xw, t),
                             reps=10 if n < 1_000_000 else 3),
            topk_ms=cuda_ms(lambda: torch.topk(
                torch.clamp_min(xw, 0.0).flatten(), t), reps=reps),
            bound=bound_ms(4 * (2 * n + 1), (NUM_STEPS + 2.0) * n))
        item["latency_floor_ms"] = item["per_round_ms"] * rounds
        epi[name] = item
        log(f"[time] relu_topk {name} ({' x '.join(map(str, xw.shape))}, "
            f"t={t}, {item['plan']['path']}, {item['plan']['exchange']} of "
            f"{item['plan']['blocks']}): {item['ms']:.5f} ms a call (device "
            f"{full_us:.3f} us, none of the 40 steps {none_us:.3f} us; "
            f"{rounds} barriers, {1e3 * item['per_round_ms']:.3f} us a round,"
            f" latency floor {item['latency_floor_ms']:.5f} ms); the mask "
            f"alone {item['mask_ms']:.5f} ms; eager plain epilogue "
            f"{item['plain_ms']:.5f} ms ({item['plain_ms'] / item['ms']:.1f}x"
            f" the kernel); torch.topk {item['topk_ms']:.5f} ms (orientation "
            f"only); bound {item['bound'][0]:.6f} ms by {item['bound'][1]}")
    results["epilogue_timing"] = {
        nm: {k: v for k, v in i.items() if k != "bound"}
        | {"bound_ms": i["bound"][0]} for nm, i in epi.items()}
    items = [epi["U"], epi["V"]]
    rows["project_mask"] = dict(
        function="relu_topk",
        ms=float(np.mean([i["ms"] for i in items])),
        plain_ms=float(np.mean([i["plain_ms"] for i in items])),
        library_ms=None,
        library_note="none computes the same function; torch.topk of the "
                     "relu'd factor (exactly t, no ties) for orientation: "
                     f"{float(np.mean([i['topk_ms'] for i in items]))} ms",
        bound_ms=float(np.mean([i["bound"][0] for i in items])),
        bound_by=items[0]["bound"][1],
        per_round_ms=float(np.mean([i["per_round_ms"] for i in items])),
        latency_floor_ms=float(np.mean([i["latency_floor_ms"]
                                        for i in items])),
        mask_only_ms=float(np.mean([i["mask_ms"] for i in items])))

    # -- 13.-16. the streamed and sequential solvers, k = 256 ---------------
    keep = {}
    gram_k256 = run_stream_slice(dev, corpus, a_sp, op, model, new_sp, u0,
                                 paths, results, keep)
    # -- 17.-18. fault tolerance and the TopicServer ---------------------------
    t0 = time.perf_counter()
    run_fault_slice(dev, a_sp, op, model, u0, paths, results, keep)
    run_topic_slice(dev, model, new_sp, paths, results)
    results["phases"]["fault_topic_s"] = time.perf_counter() - t0
    log(f"[fault] phases 17-18 took {results['phases']['fault_topic_s']:.1f} "
        "s")
    # -- 19. the mesh engines ------------------------------------------------
    run_mesh_slice(a_sp, res, u0, paths, results)
    # -- 20. the tile sweep, bf16, the fused half-step past k = 32 ---------
    run_tile_slice(dev, a_sp, op, res, u0, paths, results, rows)
    rows["gram"]["k_range"] = ("any k: one output tile up to k = 224, "
                               "128 x 128 tiles above")
    rows["gram"]["k256"] = {key: gram_k256[key] for key in
                            ("ms", "library_ms", "plain_ms", "bound_ms",
                             "bound_by")}

    owner = {"project_mask": "fit", "bsr_spmm_gram": "fit",
             "bsr_spmm": "transform", "gram": "unfused_fit",
             "flash_attention": "prefill"}
    # the TPU kernel project_mask runs on the fit path as relu_topk, the
    # function of csrc/project_mask.cu that finds tau in the same launch
    counter = {"project_mask": "relu_topk"}
    kernels = []
    for name in REPLACES:
        route, source = SOURCES[name]
        r = rows[name]
        key = counter.get(name, name)
        launches = paths[owner[name]][key]
        if launches < 1:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append(dict(
            name=name, route=route, source=source, replaces=REPLACES[name],
            launches=launches, max_abs_err=checks[name], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            path=owner[name], function=key,
            **({"k_range": r["k_range"], "k256": r["k256"]}
               if name == "gram" else {}),
            **r.get("extra", {}),
            launches_by_path={p: c[key] for p, c in paths.items()},
            launched=True, checked=True))
        log(f"[kernel] {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library "
            f"{r['library_ms']}), {launches} launches on the {owner[name]} "
            "path")
    results["kernels"] = kernels
    results["rows"] = rows
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
