#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and hold each
of its hand-written kernels against its plain PyTorch version.

    python3 chip_smoke.py [--out results.json]

Phases (any failed check raises, and the script exits non-zero):

1. build — compile the CUDA sources (one ``nvcc`` each, all started
   together) and print the build time and ``ptxas`` report;
2. per-kernel checks at the paper's PubMed shapes — every kernel against its
   plain version on the card (``project_mask`` bitwise, the BSR products to
   rtol/atol 1e-4, the Gram to 1e-4/1e-3, the fused Gram to 1e-5/1e-4);
3. the main path — ``EnforcedNMF(...backend="cuda-bsr").fit`` of the
   synthetic PubMed corpus (20,112 terms x 7,510 documents, k=5, 50
   iterations, 2% of dense kept in each factor), with launch counts read
   around it: the fused kernel 2 * iters + 1 times, the mask 2 * iters;
4. a ``torch-dense`` fit of the same corpus (8 iterations) whose error trace
   must match the ``cuda-bsr`` one within 1e-4;
5. ``transform`` of 751 unseen documents (``bsr_spmm``), checked against a
   CPU fold-in of the same documents;
6. a 5-iteration ``cuda-bsr-unfused`` fit (``bsr_spmm`` + ``gram``);
7. timings with CUDA events: each kernel, its plain version, its bound, the
   one PyTorch call that computes the same function where there is one, the
   fit's time per iteration and the bisection epilogue's share of it; a
   profiler window gives the card's busy share.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits non-zero before printing any result.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

N_TERMS, N_DOCS, K, ITERS = 20112, 7510, 5, 50
T_U, T_V = N_TERMS * K // 50, N_DOCS * K // 50     # 2% of dense: 2011, 751
DENSE_ITERS, UNFUSED_ITERS, NEW_DOCS = 8, 5, 751
DEVICE = "cuda"

REPLACES = {
    "project_mask": "src/repro/kernels/project_mask.py:29",
    "gram": "src/repro/kernels/gram.py:33",
    "bsr_spmm": "src/repro/kernels/bsr_spmm.py:67",
    "bsr_spmm_gram": "src/repro/kernels/fused.py:86",
}
SOURCES = {
    "project_mask": ("triton", "src/repro_torch/kernels/project_mask.py"),
    "gram": ("triton", "src/repro_torch/kernels/gram.py"),
    "bsr_spmm": ("cuda", "src/repro_torch/csrc/bsr_spmm.cu"),
    "bsr_spmm_gram": ("cuda", "src/repro_torch/csrc/bsr_spmm.cu"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from repro_torch.core.nmf import init_u0
    from repro_torch.core.topk import FusedReluTopK, topk_threshold_bisect
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.device import configure_numerics
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.fused import bsr_spmm_gram
    from repro_torch.kernels.gram import gram
    from repro_torch.kernels.project_mask import project_mask
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

    def close(name, got, want, rtol, atol):
        err = float((got - want).abs().max())
        bad = (got - want).abs() > atol + rtol * want.abs()
        if bool(bad.any()):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {err:.3e}, rtol "
                                 f"{rtol}, atol {atol})")
        return err

    t0 = time.perf_counter()
    x = torch.randn((N_TERMS, K), generator=gen).to(dev)
    tau = topk_threshold_bisect(torch.clamp_min(x, 0.0), T_U)
    got = project_mask(x, tau)
    torch.cuda.synchronize()
    triton_first_s = time.perf_counter() - t0
    if not torch.equal(got, ref.project_mask_ref(x, tau)):
        raise AssertionError("project_mask is not bitwise its plain version")
    checks["project_mask"] = 0.0
    t0 = time.perf_counter()
    errs = [close("gram", gram(w), ref.gram_ref(w), 1e-4, 1e-3)
            for w in (u0, v_test)]
    torch.cuda.synchronize()
    triton_first_s += time.perf_counter() - t0
    checks["gram"] = max(errs)
    errs = []
    for b, w in ((op.bsr, v_test), (op.bsr_t, u0)):
        errs.append(close("bsr_spmm", bsr_spmm(b, w), ref.bsr_spmm_ref(b, w),
                          1e-4, 1e-4))
    checks["bsr_spmm"] = max(errs)
    errs = []
    for b, w in ((op.bsr, v_test), (op.bsr_t, u0)):
        y, g = bsr_spmm_gram(b, w)
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
    log(f"[build] Triton kernels compiled at first launch in "
        f"{triton_first_s:.2f} s")
    results["checks"] = checks

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
    if paths["fit"]["project_mask"] != 2 * ITERS:
        raise AssertionError(f"project_mask launches "
                             f"{paths['fit']['project_mask']} != 2 * iters")

    # -- 4. cross-check against torch-dense -----------------------------------
    dense = EnforcedNMF(cfg.replace(iters=DENSE_ITERS, backend="torch-dense"),
                        device=dev).fit(a_sp, u0=u0)
    diff = (dense.result_.error - res.error[:DENSE_ITERS]).abs().max()
    diff = float(diff)
    log(f"[dense] torch-dense {DENSE_ITERS}-iteration error trace vs cuda-bsr:"
        f" max abs diff {diff:.3e}")
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
    results["paths"] = paths

    # -- 7. timings ------------------------------------------------------------
    def cuda_ms(fn, reps=20, warmup=3):
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

    def bound_ms(nbytes, flops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")

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
        for o, t in rows[name]["by_orientation"].items():
            log(f"[time] {name} {o}: {t['ms']:.4f} ms (plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms)")
    log(f"[time] library bsr_spmm {lib_calls}: "
        f"{[round(t, 4) for t in lib_times]} ms (A@V, A^T@U)")
    rows["bsr_spmm"]["library_ms"] = float(np.mean(lib_times))
    rows["bsr_spmm"]["library_call"] = lib_calls
    rows["bsr_spmm_gram"]["library_ms"] = None

    items = []
    for w in (u_fit, v_fit):
        n = w.shape[0]
        items.append(dict(ms=cuda_ms(lambda: gram(w)),
                          plain_ms=cuda_ms(lambda: ref.gram_ref(w)),
                          lib=cuda_ms(lambda: w.T @ w),
                          bound=bound_ms(4 * (n * K + K * K), 2.0 * n * K * K)))
    rows["gram"] = dict(ms=float(np.mean([i["ms"] for i in items])),
                        plain_ms=float(np.mean([i["plain_ms"] for i in items])),
                        library_ms=float(np.mean([i["lib"] for i in items])),
                        library_call="u.T @ u",
                        bound_ms=float(np.mean([i["bound"][0] for i in items])),
                        bound_by=items[0]["bound"][1])
    items = []
    epilogue = []
    for w, t in ((u_fit, T_U), (v_fit, T_V)):
        xw = w - 0.5 * w.max()  # a pre-epilogue factor: mixed signs
        tw = topk_threshold_bisect(torch.clamp_min(xw, 0.0), t)
        n = xw.numel()
        items.append(dict(ms=cuda_ms(lambda: project_mask(xw, tw)),
                          plain_ms=cuda_ms(lambda: ref.project_mask_ref(xw,
                                                                        tw)),
                          bound=bound_ms(4 * (2 * n + 1), 2.0 * n)))
        epilogue.append(cuda_ms(lambda: FusedReluTopK(t)(xw), reps=10))
    rows["project_mask"] = dict(
        ms=float(np.mean([i["ms"] for i in items])),
        plain_ms=float(np.mean([i["plain_ms"] for i in items])),
        library_ms=None, bound_ms=float(np.mean([i["bound"][0]
                                                 for i in items])),
        bound_by=items[0]["bound"][1])

    # the fit itself, on the already-ingested operand
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
    bisect_ms = sum(epilogue) - 2 * rows["project_mask"]["ms"]
    timing.update(fit_s=fit_s, fit_runs_s=fit_runs, per_iter_ms=per_iter_ms,
                  epilogue_ms=epilogue, bisection_ms_per_iter=bisect_ms,
                  bisection_share=bisect_ms / per_iter_ms,
                  fit_peak_mem_bytes=torch.cuda.max_memory_allocated(),
                  resident_before_fit_bytes=base_mem)
    log(f"[time] cuda-bsr fit ({ITERS} iterations, operand ingested): "
        f"{fit_s * 1e3:.2f} ms (median of "
        f"{[round(1e3 * t, 2) for t in fit_runs]} ms), {per_iter_ms:.3f} ms "
        f"per iteration; the two bisection epilogues take "
        f"{sum(epilogue):.3f} ms of it, {bisect_ms:.3f} ms of that outside "
        f"the mask kernel ({100 * bisect_ms / per_iter_ms:.1f}% of an "
        f"iteration); device memory peak during the fit "
        f"{timing['fit_peak_mem_bytes'] / 1e9:.3f} GB ({base_mem / 1e9:.3f} "
        f"GB resident before it)")

    # profiler window: device busy share and kernel launches per iteration
    from torch.profiler import ProfilerActivity, profile

    prof_iters = 5
    prof_cfg = cfg.replace(iters=prof_iters)
    EnforcedNMF(prof_cfg, device=dev).fit(op, u0=u0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        EnforcedNMF(prof_cfg, device=dev).fit(op, u0=u0)
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
    dev_us = sum(t for t, _, _ in by_kernel)
    n_kernels = sum(c for _, c, _ in by_kernel)
    busy = dev_us / (window_s * 1e6)
    timing.update(profile_window_s=window_s, device_busy_us=dev_us,
                  device_busy_share=busy, device_kernels=n_kernels,
                  kernels_per_iter=n_kernels / prof_iters,
                  top_kernels=[dict(us=t, count=c, name=k[:120])
                               for t, c, k in by_kernel[:10]])
    log(f"[profile] {prof_iters}-iteration fit: window {window_s * 1e3:.2f} "
        f"ms, device busy {dev_us / 1e3:.2f} ms ({100 * busy:.1f}%, idle "
        f"{100 * (1 - busy):.1f}%), {n_kernels} device kernels "
        f"({n_kernels / prof_iters:.0f} per iteration, set-up included)")
    for t, c, k in by_kernel[:10]:
        log(f"[profile]   {t / 1e3:8.3f} ms in {c:5d} launches: {k[:90]}")
    results["timing"] = timing

    owner = {"project_mask": "fit", "bsr_spmm_gram": "fit",
             "bsr_spmm": "transform", "gram": "unfused_fit"}
    kernels = []
    for name in _build.KERNELS:
        route, source = SOURCES[name]
        r = rows[name]
        launches = paths[owner[name]][name]
        if launches < 1:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append(dict(
            name=name, route=route, source=source, replaces=REPLACES[name],
            launches=launches, max_abs_err=checks[name], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            path=owner[name],
            launches_by_path={p: c[name] for p, c in paths.items()},
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
