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
5. ``transform`` of 751 unseen documents (``bsr_spmm``), checked against a
   CPU fold-in of the same documents;
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
    alone, the eager plain epilogue and, for orientation, ``torch.topk``.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits non-zero before printing any result.
"""
import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
#: float32 FLOP/s outside the tensor cores, dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

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


def bound_ms(nbytes, flops, peak_flops=F32_FLOPS):
    """The least time the card could take: bytes at the HBM rate or
    operations at ``peak_flops``, whichever is longer, and which it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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

    from repro_torch.backend import get_backend
    from repro_torch.convert import estimator_from_reference
    from repro_torch.core.nmf import init_u0, solve_gram
    from repro_torch.core.topk import FusedReluTopK
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

    def spmm_bytes(b, w, tiles, gram_out=False):
        n_out = b.shape[0] * K
        return 4 * (tiles * b.bm * b.bk + b.nrb * b.bcap + w.numel() + n_out
                    + (K * K if gram_out else 0))

    def lib_spmm(b, w, sp):
        """One torch.sparse call on the same matrix: a sparse BSR tensor of
        the same stored tiles, or, where PyTorch has no BSR product on the
        card, a sparse CSR tensor of the same nonzeros."""
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
            torch.from_numpy(sp.data), size=sp.shape).to(dev)
        return "torch.sparse.mm(csr)", lambda: torch.sparse.mm(csr, w)

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
    # cp.async LDGSTS); every kernel must stream through one of them
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
    if not bsr_sass or any(c["UBLKCP"] + c["UTMALDG"] == 0 or
                           c["LDGSTS"] == 0 for c in bsr_sass.values()):
        raise AssertionError("a BSR kernel has no bulk copy or no cp.async "
                             "in its SASS")
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
                    bound=bound_ms(4 * (n * K + K * K), 2.0 * n * K * K),
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
