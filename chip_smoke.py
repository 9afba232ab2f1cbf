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
    drains 16 requests of 16-token prompts, max_new 16, and reports
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
    in subprocesses, printing the uninterrupted run's numbers (run beside
    the build since phase 29 came, its kernels waiting on the build);
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
    ranks sharing the card (one set of ranks holds both grids, each rank
    at its share of the host's cores), with the share of the host's
    cores the ranks kept busy and the load average around each set,
    each rank's launches, ``all_reduce`` calls and
    bytes, peak memory, ms an iteration, NNZ beside the population of
    tau's histogram bin, held to the same bars against (a), and a
    5-iteration ``torch-csr`` 2x2 fit within 1e-4 of ``cuda-bsr``; (c) a
    streamed 2x2 fit (8 chunks through ``PackedChunk`` prefetch) bitwise
    equal with prefetch off (5 passes a chunk, 10 until phase 28 came);
    (d) a 2x2 fit checkpointed every 10
    iterations, killed at snapshot 30 and resumed on 4x1, within 1e-4 of
    the uninterrupted 2x2 trace; (e) ``python -m torch.distributed.run
    --nproc-per-node 4 -m repro_torch.launch.nmf_run --solver distributed
    --mesh 2x2 --dist-backend gloo --small`` exits 0, run beside phase
    25's untimed work (a run's time limit; no timed window shares the host
    with it); (f) the fit on a
    2x2x2 (pod, data, model) grid of eight gloo ranks sharing the card,
    rows over ``("pod", "data")`` through ``make_sharded_als``, bitwise
    the same ranks' 4x2 fit (one row group of the ranks that share a
    column), 20 iterations (50 until phase 28 came), its last error
    within 0.02 of (a)'s at the same iteration, ``bsr_spmm_gram`` 2 *
    iters a rank, ms an iteration and ``all_reduce`` calls;
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
21. the LM training half: (a) llama3.2-1b at full width and depth, f32
    parameters from a seed, ``make_train_step`` (bf16 compute, remat, two
    microbatches) on train_4k's sequence of 4096 at a global batch of 8
    (cut from 256), a warm-up step and 1 timed one: ms a step, tokens/s,
    model FLOPs, peak memory, the card's busy share in a profiler window,
    a microbatch's time split (forward, backward with its recompute, the
    loss chunks, the optimizer); every loss finite, step 0's equal to the
    cross-entropy of the serving path's logits on the same batch (the
    reference's bf16 bar), no hand-written kernel launched (the plain
    attention, as the reference trains); (b) at full width with 2 layers
    and a batch of 2 x 1024: the chunked loss against an unchunked
    ``log_softmax`` (f32, 1e-4 / 1e-5), one step's gradient with 2
    microbatches against 1 (f32, 1e-4), the q-chunked attention at S =
    4096 against the whole path (output and input gradients), and the
    flash kernel against the plain path (the reference's bars); (c)
    ``python -m repro_torch.launch.train --smoke --deterministic`` stopped
    at 6 steps and rerun to 9, its state bitwise an uninterrupted run's,
    with the ``AsyncCheckpointer`` seconds a save, for llama3.2-1b and for
    the smoke configs of phases 22 and 24 (olmoe-1b-7b,
    seamless-m4t-large-v2), all in the same two waves, run beside the
    build (phase 1), which no metric reads (a run's time limit; they need
    no kernel of it and end before the corpus is made); (d)
    ``make_compressed_grad_fn`` on four gloo ranks sharing the card at
    density 0.25, conservation within 1e-5 (the ranks run beside the build
    since phase 29 came).
22. the moe family (olmoe-1b-7b, f32 parameters from a seed): (a) serving
    at full width and depth: ``make_prefill_step`` on 4 x 4096 tokens
    (finite, the flash kernel launched n_layers = 16 times, first call and
    the median of 3, tokens/s, peak memory, busy share), a
    ``ServingEngine`` (max_batch 8, max_seq 512) draining 8 requests
    (prompts of 16, 16 new tokens each; 32 and 32 until 25(f) came) and
    a decode tick; one full-width MoE layer (d 2048, 64 experts, top 8) on
    256 tokens in f32 against the same layer on the CPU (routing and kept
    pairs equal, output within 1e-4) and at capacity 8.0 against the dense
    mixture (rtol 2e-2, atol 2e-3); the flash attention against the plain
    path on the first 2 layers' inputs (bf16, 5e-2); (b) training at full
    width with the depth cut to 4: ``make_train_step`` (bf16, remat,
    AdamW) on 2 x 4096 tokens in two microbatches, ms a step, tokens/s,
    model FLOPs counting the active experts and their share of the bf16
    peak, peak memory; every loss finite, step 0's equal to the serving
    path's cross-entropy (the reference's bf16 bar), no hand-written
    kernel launched (the train launcher at the smoke olmoe config is
    killed and resumed in 21(c)); (c) ``moe_ffn_ep`` on four gloo ranks
    sharing the card, grids 2x2 and 2x1x2, one full-width layer on 4 x
    256 tokens in f32: every rank's block within 1e-5 of the plain
    single-process body, ``all_to_all`` calls and bytes, ms a layer.
23. the hybrid and ssm families (zamba2-7b and xlstm-125m, f32 parameters
    from a seed): (a) zamba2-7b serving at full width and depth (81 Mamba2
    layers, the shared block 13 times): ``make_prefill_step`` on 4 x 4096
    (first call, then one timed call (a median of 3 until 25(f) came),
    tokens/s, peak memory; the flash kernel launched 13 times; the busy share and 13 launches of its hd-112
    instantiation in a profiler window of a 4 x 1024 prefill), 1 x 32768, a ``ServingEngine``
    (max_batch 8) draining 16 requests of 8-token prompts and 4 new
    tokens (8 until 25(f) came; half of them admitted into freed slots), an f32 forward over 64 tokens (the f32 kernel
    at hd 112) against 64 f32 decode steps (2e-2); (b) one full-width
    Mamba block and the shared block on 256 tokens in f32, card against
    CPU (1e-4), the block's decode against its forward (2e-2); (c)
    zamba2-7b training at full width, depth cut to 15 and batch to 2 x
    4096 (bf16, remat, AdamW, two microbatches; the first step timed
    itself: ms a step, tokens/s, model
    FLOPs and their share of the bf16 peak, peak memory; step 0's loss
    against the serving path's cross-entropy, no hand-written kernel
    launched); (d) xlstm-125m serving at full width and depth: prefills
    at 4 x 4096 (the profiler window at 4 x 1024) and 1 x 4096 with the
    sLSTM layers' share of the time, the engine (prompts of 8, 8 new
    tokens each), one long_500k decode
    step at position 524,287 (state bytes constant), an mLSTM and an
    sLSTM block card against CPU (1e-4) and the mLSTM decode against its
    parallel form (5e-2); (e) xlstm-125m training at full depth, batch
    cut to 4 x 1024 in one microbatch (4 x 4096 until 25(f) came); (f)
    the flash kernel at
    zamba2's shape (B=4, H=32, S=4096, hd=112) against its bound, its
    plain version and ``scaled_dot_product_attention``, and the last two
    at olmoe's heads (hd 128).
24. the encdec family (seamless-m4t-large-v2, f32 parameters from a
    seed, 2,034,784,256 of them): (a) serving at full width and depth:
    ``make_prefill_step`` (the encoder) on 4 x 4096 frames (first call,
    the median of 3, frames/s, peak memory, busy share; the flash kernel
    launched 24 times, not causal, and 24 launches in the profiler
    window), one 1 x 32768 encode (prefill_32k, batch cut from 32 to 1), a
    generation (``prefill`` of 8 x 4096 frames with every layer's cross K
    / V, 32 greedy ``decode_step`` s from token 0: ms a step, tokens/s, 24
    flash launches a step at one query row, the unembedding's share, a
    profiler window of one step), one decode step at decode_32k's lengths
    (enc_len 32768, max_dec 4096, batch cut from 128 to 8, the cross K / V
    from a seed); (b) in f32 at full width, one encoder layer, one decoder
    layer and ``_cross_kv`` on the card against the CPU (1e-4), and an f32
    prefill of 64 frames with 16 decode steps against ``decode_train``
    (2e-3); (c) training at full width and depth, 8 x 4096 frames and 8 x
    512 tokens (global batch cut from 256 to 8) in two microbatches: a
    warm-up and 1 timed step, tokens/s, model FLOPs and their share of the
    bf16 peak, peak memory; every loss finite, step 0's equal to
    ``seq2seq_loss`` on the serving path's memory (the bf16 bar), no
    hand-written kernel launched (the train launcher at the smoke config
    is killed and resumed in 21(c)); (d) the flash kernel at the encoder's
    shape (B=4, H=Hkv=16, S=T=4096, hd=64, not causal) and at one query
    row against 4096 and 32768 frames of a cache (B=8), each against its
    plain version, its bound and ``scaled_dot_product_attention``, and in
    f32 with fewer rows; its log-sum-exp output (``lse=True``) at one
    query row (B=8, H=16, hd 64; T = 4096 and a 16,384-key slice; bf16 and
    f32): the output bitwise the one without it, the lse against the plain
    version's (atol 1e-3 bf16, 1e-5 f32), two launches over the halves of
    T merged by their lse against one launch over T (rtol 1e-2 / atol 2e-3
    bf16), the ms with and without it.
25. parameter sharding (``training/sharding.py``: FSDP over ``"data"``,
    tensor parallelism over ``"model"``) on a 2x2 grid of four gloo ranks
    sharing the card: (a) llama3.2-1b at full width, depth cut from 16 to
    2, a global batch of 4 x 1024 in bf16 with remat, a warm-up step and 1
    timed one (3 before (d) came, 2 before (f)): ms a step, tokens/s, each
    rank's peak
    memory, each rank's parameter + moment bytes against the 1x1 run's
    (equal to the reference's per-device shard bytes), ``all_reduce``
    calls and bytes a
    step; every loss finite and equal on every rank, step 0's the 1x1
    loss on the same parameters and batch within the bf16 bar, no
    hand-written kernel launched; (b) in f32 at full width with 2 layers
    on 2 x 256 tokens: the sharded loss and gradients, gathered whole,
    against the 1x1 step's (1e-4 / 1e-5, 1e-3 / 1e-5); (c) ``python -m
    torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train
    --smoke --deterministic --data 2 --model 2 --dist-backend gloo``
    stopped at 6 and rerun to 9, bitwise an uninterrupted 2x2 run, and its
    step-6 checkpoint resumed on 4x1 within 1e-4, its runs beside the
    build with 21(c)'s (19(e)'s start once the ranks' timed steps of (a)
    and (d) are done, beside (b), (e) and the checks in this process); (d)
    in the same ranks,
    the moe, hybrid, ssm and encdec families at full width (olmoe-1b-7b at
    2 layers, its experts over ``"model"`` through the differentiable
    ``all_to_all``; zamba2-7b at one group of 6 Mamba2 blocks and the
    shared block, split by SSM heads; xlstm-125m at full depth, split by
    heads; seamless-m4t-large-v2 at 2 encoder + 2 decoder layers), each
    drawn by the launcher's init, a global batch of 4 x 512 (seamless 4 x
    512 frames and 4 x 64 tokens) in bf16 with remat, a warm-up and 1 timed
    step (2 before (f)): ms a step, tokens/s, each rank's peak memory and
    parameter +
    moment bytes (exactly the reference's per-device shard bytes,
    ``dryrun.spec_bytes``), ``all_reduce`` and ``all_to_all`` calls and
    bytes a step; every loss finite and equal on every rank, step 0's the
    1x1 loss on the same parameters and batch within atol 1e-2 (bf16), no
    hand-written kernel launched; (e) in the same ranks, (b) again for
    olmoe-1b-7b at 2 layers (its experts through the exchange; the 1x1
    step's experts grouped as the grid's, ``moe_ffn_ep_plain``) and for
    zamba2-7b at 2 layers with the shared block after each, on 2 x 256
    tokens in f32: the loss (1e-4 / 1e-5) and every gradient, gathered
    whole, against the 1x1 step's (1e-3 / 1e-5).  (d) takes one timed step
    since (f) came.  (f) in the same ranks, before (b) and (e), the
    sharded serving steps (``serving/sharding.py``) of llama3.2-1b at 2
    layers and of (d)'s families at (d)'s depths, full width, bf16, drawn
    by the launcher's init: a warm-up and a timed prefill of 2 x 4096
    tokens (seamless 2 x 4096 frames, xlstm 2 x 2048), two timed decode
    steps at batch 4 from a state drawn from a seed at decode_32k's length
    of 32,768 (xlstm at long_500k's position 524,287), one at a position
    in the last ``"model"`` block and one in the first (7): ms a call, a
    rank's state bytes (exactly the reference's per-device bytes),
    ``all_reduce`` / ``all_to_all`` calls and bytes, flash launches (every
    attention layer of a prefill, every cross-attention of an encdec
    decode step, a slice of keys each, merged by the log-sum-exp), peak
    memory above what was resident; each rank's logits (encdec prefill:
    memory) and written KV rows against the unsharded steps on its batch
    block (whole parameters from the same seed, the block's whole rows of
    the same state; a moe prefill on the whole batch, its experts grouped
    as the grid's; a moe's experts pinned to the sharded steps' choices,
    each within the bar of the unsharded router's own top k) within the
    bf16 bar (rtol 5e-2, atol 1e-1); xlstm-125m, whose bf16 logits differ
    from its own f32 logits by more than that bar (printed), in f32 within
    2e-3 (the same steps again, untimed).
26. the dry-run on the ``meta`` device (``launch/dryrun.py``,
    ``launch/cost_analysis.py``) against what phases 3/7, 9/11 and 25
    measured, no new card run: (a) phase 3's PubMed fit on ``cuda-bsr``
    with the ingested operand moved to ``meta`` (its occupied-tile counts
    kept): launches by kernel, as the dry-run's counter records them,
    equal to phase 3's exactly, the predicted peak beside phase 7's, each
    kernel's FLOPs and bytes as a bound and a roofline share of its phase
    7 time; (b) the llama3.2-1b prefill at 4 x 4096: 16 flash launches
    exactly, the counted FLOPs beside phase 11's prefill time, the
    predicted peak beside phase 9's; (c) phase 25's cell on a fake 2x2
    grid: a rank's parameter + moment bytes and its ``all_reduce`` calls
    and bytes a step equal to phase 25's exactly, the predicted peak
    beside its ranks'; (d) phase 25(d)'s olmoe-1b-7b cell on a fake 2x2
    grid the same way, its ``all_to_all`` calls and bytes too; (e) 25(f)'s
    llama3.2-1b prefill and seamless-m4t-large-v2 decode cells on a fake
    2x2 grid: collective calls and bytes a call, flash launches and a
    rank's state bytes equal to 25(f)'s exactly, the predicted peak beside
    its ranks'.  Each predicted peak must be within 10% of the
    measured one (for (a) and (b) ``analysis.memory_guard``'s of phase
    7's warm-up fit and phase 9's first prefill: ``max_memory_allocated``
    less what was resident before the call, plus the call's argument
    bytes; for (c), (d) and (e) each rank's ``max_memory_allocated``, (d)
    and (e) above what was resident before the family's init).  The meta
    branches launch nothing: the card's launch counts stay as they were.
27. the analyzer's runtime guards (``repro_torch.analysis.runtime``) on
    the card: (a) ``memory_guard`` of the IR targets ``als[cuda-bsr]`` and
    ``als[torch-csr]`` (``analysis/ir/targets.py``) on the card and on
    ``meta``, at the canonical size (the IR gate's 512 x 384 operand; the
    ratio printed: the allocator rounds each block to 512 bytes) and at
    PubMed size on phase 7's operand (and its padded-CSR form), 3
    iterations at k = 5, the planner's peak within 10% of the card's;
    (b) a second identical fit under ``recompile_guard()``: zero ``nvcc``
    builds, its kernels launched.  No kernel is added: the ``kernels``
    line is unchanged.
28. the paper's Wikipedia configuration (``NMF_CONFIGS["wikipedia"]``:
    143,462 terms x 12,439 pages, k = 5, 50 iterations, t_u = 14,346 and
    t_v = 1,243, 2% of each factor), its synthetic corpus made beside the
    build and the train launchers (its 13.3 GB padded ``SpCSR`` dropped
    there, its scipy CSR kept): (a) the host ingest of both orientations
    (seconds, peak RSS above the input against the tiles' bytes, the
    host's ``MemTotal``), one copy to the card (seconds, bytes); the
    whole-batch ``cuda-bsr`` fit from an explicit u0 with
    ``bsr_spmm_gram`` 2 * iters + 1 and ``relu_topk`` 2 * iters launches
    and no other mask launch, NNZ within the budgets up to ties, its
    error and residual traces within 1e-4 of a ``torch-dense`` fit on the
    card from the same u0; a ``transform`` of the corpus (one ``bsr_spmm``,
    one ``relu_topk``) within 1e-4 of the dense fold-in; (b) the streamed
    fit (resident chunks, the default 8, prefetch on): its launches, each
    pass's host ingest (``Prefetcher`` stats of the factor, fold-in and
    seed passes), within 1e-4 of the same streamed fit on ``torch-dense``
    carved from (a)'s dense operand (traces; U relative to its largest
    entry), and the bytes a
    ``write_corpus`` spill would take (not written); (c) ``python -m
    repro_torch.launch.nmf_run --config wikipedia --backend cuda-bsr
    --iters 3 --sparsity frac_u=0.02,frac_v=0.02`` exits 0 with a finite
    error and NNZ within the budgets, run beside the build and the train
    launchers' runs once the corpus above is made (its kernels' first use
    waits for the build); (d) ms an iteration and the busy share (a
    profiler window of 5 iterations), the meta planner's peak within 10%
    of the card's (``memory_guard``), ``bsr_spmm`` and the fused launch in
    each orientation against their plain versions (1e-4), their bounds
    over the occupied tiles, ``torch.sparse.mm`` on a BSR tensor and the
    fused kernel's ``[tail]``, ``relu_topk`` on both pre-epilogue factors
    bitwise its plain version, and the error path's ``bsr_dot_uv`` (every
    slot of A) as a share of an iteration.
29. the port's examples (``examples/torch_*.py``): (a) each as a
    subprocess, as its docstring runs it and with no ``--device`` (the
    card): ``torch_quickstart.py``, ``torch_topic_modeling_pipeline.py`` at
    its defaults and with ``--stream`` (each into a fresh ``--ckpt``),
    ``torch_serving.py``, ``torch_lm_training.py --arch llama3.2-1b --steps
    20`` and ``--arch olmoe-1b-7b --compress``: exit 0, every stage's line
    with finite numbers, the card named; the LM ones beside the build (they
    need no kernel), the NMF ones started with it (their kernels wait on
    its locks), all ended before the corpus is made; (b) in this process
    the pipeline's ``main`` at the docstring's PubMed size (``--terms 20112
    --docs 7510 --iters 200``), in batch mode from a fresh ``--ckpt``
    seeded with a ``factors.npz`` of a known U, and with ``--stream``:
    ``bsr_spmm_gram``, ``relu_topk``, ``bsr_spmm`` and ``gram`` launched
    exactly as worked out from the code (:func:`pipeline_launches`), all
    64 requests answered and folded back by ``refresh``, each stage's
    seconds; the batch checkpoint against the same rounds replayed on
    ``torch-dense`` from the same U: V within 1e-4, U within 1e-4 of its
    largest entry (as phase 13 holds a streamed fit's U), each round's final
    error and residual within 1e-4.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits non-zero before printing any result.
"""
import argparse
import concurrent.futures
import dataclasses
import json
import os
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
#: the engine drains (phase 10; the xlstm and zamba2 drains set their own
#: prompts): prompts of 16 and 16 new tokens (32 and 32 until 25(f) came:
#: the script's time limit; the tokens/s are host-bound)
SERVE = dict(max_batch=8, max_seq=512, requests=16, prompt=16, max_new=16)
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
#: (rtol, atol) of the flash kernel against the plain attention path the
#: train step takes, the reference's bars between its flash kernel and a
#: plain path: bf16 ``tests/test_kernels.py:221`` (the plain path rounds
#: the scores to bf16 before the softmax, the kernel keeps them in f32),
#: f32 ``tests/test_kernels.py:243``
FLASH_VS_PLAIN_TOL = {"bfloat16": (5e-2, 5e-2), "float32": (2e-3, 2e-3)}

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


def beside(fn, *args) -> concurrent.futures.Future:
    """``fn(*args)`` started in a thread beside the caller's work (a run's
    time limit): for checks that run subprocesses and only wait on them,
    started only where the caller times nothing.  The future's
    ``result()`` joins it (and raises what it raised); at exit the
    interpreter joins it too, so its subprocesses end as it ends them."""
    return concurrent.futures.ThreadPoolExecutor(1).submit(fn, *args)


def after(first, fn, *args):
    """``fn(*args)`` once the future ``first`` is done, whatever it gave
    (its caller collects that)."""
    first.exception()
    return fn(*args)


def once(path, stop, fn, *args):
    """``fn(*args)`` once the file ``path`` exists; None if ``stop`` (a
    ``threading.Event``) is set first."""
    while not os.path.exists(path):
        if stop.wait(0.2):
            if not os.path.exists(path):
                return None
            break
    return fn(*args)


def host_cpu():
    """CPU seconds of this process and of its reaped children
    (``os.times``), the wall clock and the host's one-minute load average:
    two readings around a window give the share of the host's cores this
    script and its ranks kept busy in it, beside the load of every task
    on the host (``/proc/stat``'s totals stand still on the card's
    machine)."""
    t = os.times()
    return dict(ours=t.user + t.system + t.children_user + t.children_system,
                wall=time.monotonic(), load=os.getloadavg()[0])


def host_share(before, after):
    """``host_cpu`` readings around a window: its seconds, the share of
    the host's cores this script and its ranks used, the load average at
    its end."""
    wall = max(after["wall"] - before["wall"], 1e-9)
    cores = os.cpu_count() or 1
    return dict(seconds=wall, cores=cores, load=after["load"],
                ours=(after["ours"] - before["ours"]) / (wall * cores))


def close(name, got, want, rtol, atol):
    """Max abs error of ``got`` against ``want``; raises unless every entry
    is within ``atol + rtol * |want|`` (a NaN on either side fails)."""
    got, want = got.detach().float(), want.detach().float()
    diff = (got - want).abs()
    err = float(diff.max())
    if not bool((diff <= atol + rtol * want.abs()).all()):
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


def host_ms(fn, reps, sync):
    """Host-clock ms of each of ``reps`` calls of ``fn``, each between two
    calls of ``sync`` (the card's synchronize, or nothing on the CPU)."""
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


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
    """FLOPs of U^T U for U (n, k), the kernel module's own count
    (``kernels.gram.cost``: its k (k + 1) / 2 distinct entries)."""
    import torch

    from repro_torch.kernels.gram import cost

    return cost(torch.empty((n, k), device="meta"))[0]


def flash_flops(b, h, sq, t, hd, causal):
    """Multiply-add FLOPs of Q K^T and P V over the (row, key) pairs the
    mask keeps, the kernel module's own count
    (``kernels.flash_attention.cost``)."""
    import torch

    from repro_torch.kernels.flash_attention import cost

    kv = torch.empty((b, 1, t, hd), device="meta")
    return cost(torch.empty((b, h, sq, hd), device="meta"), kv, kv,
                causal)[0]


PROFILE_ATTEMPTS = 3


def _trace(fn, calls, cpu, warmup):
    """One profiler window of ``calls`` calls of ``fn``: the device kernels
    as ``(us, launches, name)``, largest first, and the window's seconds.
    ``warmup`` traces one more call of ``fn`` first and drops it (the
    profiler's warm-up step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                            else [])
    steps = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup \
        else None
    with profile(activities=activities, schedule=steps) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        if warmup:
            prof.step()
    by_kernel = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t_us = getattr(evt, "self_device_time_total", None)
            if t_us is None:
                t_us = evt.self_cuda_time_total
            by_kernel.append((t_us, evt.count, evt.key))
    by_kernel.sort(reverse=True)
    return by_kernel, window_s


def _matching(by_kernel, match):
    """Launches and device us of the kernels whose name holds ``match``."""
    hits = [(x, c) for x, c, k in by_kernel if match in k]
    return sum(c for _, c in hits), sum(x for x, _ in hits)


def profiled(name, fn, calls=1, expect=None, cpu=True, warmup=False):
    """Device busy share and kernels per call in a profiler window of
    ``calls`` calls of ``fn``; logs the top kernels.  ``expect`` (names'
    substrings, each to the launches the window must hold) adds the
    launches of the kernels whose name holds each; the caller checks them.
    ``cpu=False`` traces the device alone: a window of ~10^5 host ops
    takes minutes to summarise.  ``warmup`` traces one more call of
    ``fn`` first and drops it (the profiler's warm-up step).  A window
    can lose kernel records (the launch counters saw 24 flash launches
    where a window held 23, three windows in a row; a window of 50
    epilogue calls held none): a window that holds fewer launches of a
    name than ``expect`` gives is traced again, up to
    ``PROFILE_ATTEMPTS`` windows, and the last one is returned."""
    expect = expect or {}
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        by_kernel, window_s = _trace(fn, calls, cpu, warmup)
        seen = {m: _matching(by_kernel, m)[0] for m in expect}
        short = {m: (c, expect[m]) for m, c in seen.items() if c < expect[m]}
        if not short:
            break
        log(f"[profile] {name}: window {attempt} of {PROFILE_ATTEMPTS} lost "
            f"kernel records (launches seen, expected: {short})")
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
                             for x, c, k in by_kernel[:10]],
                launches_matching=seen, windows=attempt)


def device_us(fn, match, calls=50):
    """Mean device time in us of the kernels whose name contains ``match``
    over ``calls`` calls of ``fn`` (profiler, after a traced warm-up call
    that is dropped): the kernel's own time, whatever the host takes to
    launch it.  A window that holds no such kernel is traced again, up to
    ``PROFILE_ATTEMPTS`` windows (see :func:`profiled`)."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        count, total = _matching(_trace(fn, calls, False, True)[0], match)
        if count:
            return total / count
        log(f"[profile] {match}: window {attempt} of {PROFILE_ATTEMPTS} of "
            f"{calls} calls holds no such kernel")
    raise AssertionError(f"no device kernel matching {match!r} ran in "
                         f"{PROFILE_ATTEMPTS} profiler windows")


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

    from repro_torch.analysis import memory_guard
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
    kept = []

    def prefill(m, b):
        # memory_guard drops the call's result: keep the logits
        kept.append(step(m, b))
        return kept[0]

    t0 = time.perf_counter()
    # the call's peak (the arguments plus what it added to what was
    # resident) is phase 26's measured peak
    guard = memory_guard(prefill, model, batch)
    first_s = time.perf_counter() - t0
    logits = kept.pop()
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
    lm.update(prefill_first_s=first_s, prefill_peak_mem_bytes=peak,
              prefill_guard_peak_bytes=guard.peak_bytes)

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


def command_line_kill_and_resume(card):
    """Phase 17(f): ``python -m repro_torch.launch.nmf_run --config pubmed
    --small --backend cuda-bsr --iters 20`` with a snapshot every 5
    iterations, killed at 10 (exit ``KILL_EXIT``) and rerun with
    ``--resume``, beside an uninterrupted run: the resumed run prints the
    uninterrupted run's numbers.  Run beside untimed work only (the build:
    its kernels' first use waits on the build's lock of each library)."""
    import shutil
    import tempfile

    from repro_torch.robustness import KILL_EXIT

    root = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    base = ["--config", "pubmed", "--small", "--backend", "cuda-bsr",
            "--iters", "20"] + ([] if card else ["--device", "cpu"])
    argv = base + ["--checkpoint-dir", root, "--checkpoint-every", "5"]
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
             run(module + base)]
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
    shutil.rmtree(root, ignore_errors=True)
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
    return dict(kill_exit=kill_rc, numbers=got, seconds=cli_s)


def run_fault_slice(dev, a_sp, op, model, u0, paths, results, keep, cli):
    """Phase 17: fault tolerance at PubMed size on cuda-bsr: a checkpointed
    fit killed at snapshot 30 and resumed (bitwise phase 3), its costs, a
    poisoned iteration rolled back, the raise and give-up paths, a
    mismatched resume, the streamed fit killed and resumed (bitwise phase
    13) and poisoned, and the command line killed (exit 73) and resumed
    (``cli``: the future of :func:`command_line_kill_and_resume`, started
    beside the build)."""
    import shutil
    import tempfile
    import warnings

    import torch

    from repro_torch.kernels import _build
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
    from repro_torch.robustness import (
        CheckpointMismatchError, FitHealthError, faults,
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

    # -- 17(f). the command line, killed and resumed (run beside the build) --
    c = out["cli"] = cli.result()
    log(f"[fault] command line (pubmed --small, cuda-bsr, 20 iterations, "
        f"every 5): killed at 10, exit {c['kill_exit']}; --resume exit 0 "
        f"and prints the uninterrupted run's numbers: {c['numbers']}; three "
        f"processes {c['seconds']:.1f} s (beside the build)")
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
    # each job's start on this rank's clock, and the loop's end: the jobs'
    # seconds, by group, when several grids share one spawn
    starts = []
    for name, kw in jobs:
        starts.append((name, time.perf_counter()))
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
    ends = [t for _, t in starts[1:]] + [time.perf_counter()]
    out["job_s"] = {name: end - t for (name, t), end in zip(starts, ends)}
    return out


def _pod_rank(rank, data_dir, device, iters):
    """One rank of phase 19(f): the PubMed batch fit on ``cuda-bsr``
    through ``make_sharded_als`` on a 2x2x2 grid (rows over ``("pod",
    "data")``) and on the same eight ranks as a 4x2 grid (rows over
    ``"data"``): each block ingested, a 2-iteration warm-up, then an
    ``iters``-iteration run (after a barrier, host clock ending in a
    synchronize) with its launches and collectives counted from 0."""
    import scipy.sparse

    import torch

    from repro_torch.backend.sharded import make_sharded_als
    from repro_torch.core.topk import DistTopK
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )

    dev = torch.device(device)
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    a_sp = scipy.sparse.load_npz(Path(data_dir) / "a.npz")
    u0 = np.load(Path(data_dir) / "u0.npy")
    out = {}
    for name, pods, rows, rows_axes in (("2x2x2", 2, 2, ("pod", "data")),
                                        ("4x2", 1, 4, ("data",))):
        mesh = make_nmf_mesh(rows, 2, device=dev, pods=pods)
        engine = make_sharded_als(
            mesh, rows_axes, "model",
            sparsify_u=DistTopK(T_U, mesh, rows_axes),
            sparsify_v=DistTopK(T_V, mesh, ("model",)), inner="cuda-bsr")
        dist = engine.distribute(a_sp)
        u = torch.from_numpy(u0).to(dev)[mesh.row_block(u0.shape[0])]
        engine(dist, u, 2)
        mesh.barrier()
        sync()
        _build.reset_launch_counts()
        reset_collective_counts()
        t0 = time.perf_counter()
        r = engine(dist, u, iters)
        sync()
        wall = time.perf_counter() - t0
        out[name] = dict(
            launches=_build.launch_counts(), collectives=collective_counts(),
            iter_ms=1e3 * wall / iters, err=r.error.tolist(),
            res=r.residual.tolist(), nnz_u=r.nnz_u.tolist(),
            nnz_v=r.nnz_v.tolist(), health=int(r.health),
            finite=bool(torch.isfinite(r.u).all()
                        and torch.isfinite(r.v).all()),
            u=r.u.cpu().numpy(), v=r.v.cpu().numpy(),
            peak_mb=(torch.cuda.max_memory_allocated() / 2**20 if card
                     else 0.0))
    return out


#: inner passes a chunk of 19(c)'s streamed 2x2 fit (10 before the
#: Wikipedia phase came: the script's time limit), and iterations of
#: 19(f)'s 2x2x2 and 4x2 engine fits (50 before it)
MESH_STREAM_INNER, POD_ITERS = 5, 20


def rank_threads(world):
    """Intra-op threads of each of ``world`` ranks that share this host: its
    cores split between them (the ranks' default, every core each,
    oversubscribes the host ``world`` times)."""
    return max(1, (os.cpu_count() or 1) // world)


def run_mesh_slice(a_sp, res3, u0, paths, results, device="cuda:0",
                   one_rank_backend="nccl"):
    """Phase 19: the mesh engines on the card.  Every rank is a process
    spawned from here (this process joins no group): a 1x1 mesh under NCCL,
    2x2 and 4x1 meshes as four gloo ranks sharing the card; the streamed fit
    on 2x2; a 2x2 fit killed at snapshot 30 and resumed on 4x1; a 2x2x2
    grid (rows over ``("pod", "data")``) of eight gloo ranks against the
    same ranks as 4x2 (the command line under ``torch.distributed.run``,
    19(e), runs later, beside phase 25's untimed work:
    :func:`nmf_command_line`).
    (``device="cpu"`` with gloo runs the same phase on the CPU, to debug it
    at a small size.)"""
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
        t0, cpu0 = time.perf_counter(), host_cpu()
        recs = spawn_mesh(_mesh_rank, *shape, backend=backend,
                          device=device, timeout=600.0,
                          init_file=str(Path(root) / f"store-{shape}"),
                          args=(root, device, jobs),
                          threads=rank_threads(shape[0] * shape[1]))
        load = host_share(cpu0, host_cpu())
        out.setdefault("host", {})["x".join(map(str, shape))] = load
        log(f"[mesh] {shape[0]}x{shape[1]} spawn: this script and its "
            f"ranks kept {100 * load['ours']:.1f}% of the host's "
            f"{load['cores']} cores busy; load average {load['load']:.1f}")
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

    def report(name, recs, secs, timed, spawn_s=None):
        """Each rank's fit (launches, collectives, peak memory, wall time
        with its ingest) and its engine timed without the ingest; ``secs``
        from spawn to result, or, where grids share a spawn of
        ``spawn_s`` seconds, this grid's jobs on the slowest rank."""
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
            f"bin holds {rec['pop_v']}); "
            + (f"spawn to result {secs:.1f} s" if spawn_s is None else
               f"its jobs {secs:.1f} s of the shared spawn's "
               f"{spawn_s:.1f} s"))
        out[name] = dict(
            ranks=[{k: v for k, v in r.items() if k not in ("u", "v")}
                   for r in recs], seconds=secs)
        if spawn_s is not None:
            out[name]["spawn_s"] = spawn_s

    def jobs_s(recs, names):
        """The seconds of the jobs ``names`` on the slowest rank."""
        return max(sum(r["job_s"][n] for n in names) for r in recs)

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

    # -- 19(b)-(d). 2x2: the fit, torch-csr, the streamed fit, the kill; then
    # 4x1 in the same four ranks (a world holds a mesh of each shape), and
    # the 2x2 kill resumed there ---------------------------------------------
    stream = dict(k=K, iters=MESH_STREAM_INNER, solver="streaming",
                  backend="cuda-bsr", mesh_shape=(2, 2))
    jobs = [("fit", dict(fit, mesh_shape=(2, 2))), timed((2, 2)),
            ("csr", dict(fit, mesh_shape=(2, 2), iters=UNFUSED_ITERS,
                         backend="torch-csr")),
            ("stream", stream),
            ("stream_off", dict(stream, prefetch=False)),
            ("kill", dict(fit, mesh_shape=(2, 2), checkpoint_dir=ckpt,
                          checkpoint_every=10, kill_at=30)),
            ("fit41", dict(fit, mesh_shape=(4, 1))),
            ("engine41", timed((4, 1))[1]),
            ("resumed", dict(fit, mesh_shape=(4, 1), checkpoint_dir=ckpt,
                             checkpoint_every=10, resume=True))]
    r22, secs = spawn((2, 2), "gloo", jobs)
    fits = [r["fit"] for r in r22]
    check_ranks("2x2 gloo", fits, 2 * ITERS + 1)
    p22 = bars("2x2 gloo", fits[0], phase3, "phase 3")
    d22 = same_engine("2x2 gloo", fits[0], a1["fit"], "19(a)")
    grid41 = ("fit41", "engine41", "resumed")
    report("2x2 gloo", fits,
           jobs_s(r22, [n for n, _ in jobs if n not in grid41]),
           [r["engine"] for r in r22], spawn_s=secs)
    paths["mesh_fit"] = fits[0]["launches"]
    csr_err = np.asarray(r22[0]["csr"]["err"])
    csr_diff = float(np.max(np.abs(
        csr_err - np.asarray(fits[0]["err"][:UNFUSED_ITERS]))))
    if csr_diff > 1e-4:
        raise AssertionError(f"sharded[torch-csr] 2x2 differs from cuda-bsr "
                             f"by {csr_diff:.3e}")
    streams = [r["stream"] for r in r22]
    n_chunks = streams[0]["n_iter"]
    check_ranks("2x2 stream", streams, 2 * MESH_STREAM_INNER * n_chunks,
                relu_topk=1)
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

    # -- 19(b), (d). 4x1 (the same ranks), and the 2x2 kill resumed there ---
    fits41 = [r["fit41"] for r in r22]
    check_ranks("4x1 gloo", fits41, 2 * ITERS + 1)
    p41 = bars("4x1 gloo", fits41[0], phase3, "phase 3")
    d41 = same_engine("4x1 gloo", fits41[0], a1["fit"], "19(a)")
    report("4x1 gloo", fits41, jobs_s(r22, grid41),
           [r["engine41"] for r in r22], spawn_s=secs)
    log(f"[mesh] 4x1 against phase 3: error {p41[0]:.3e}, residual "
        f"{p41[1]:.3e}; against 19(a): error {d41[0]:.3e}, residual "
        f"{d41[1]:.3e}")
    resumed = [r["resumed"] for r in r22]
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

    # -- 19(f). 2x2x2: rows over ("pod", "data"), eight gloo ranks ---------
    t0, cpu0 = time.perf_counter(), host_cpu()
    r222 = spawn_mesh(_pod_rank, 2, 2, pods=2, backend="gloo", device=device,
                      init_file=str(Path(root) / "store-2x2x2"),
                      args=(root, device, POD_ITERS), timeout=600.0,
                      threads=rank_threads(8))
    secs = time.perf_counter() - t0
    out.setdefault("host", {})["2x2x2"] = load = host_share(cpu0, host_cpu())
    log(f"[mesh] 2x2x2 spawn: this script and its ranks kept "
        f"{100 * load['ours']:.1f}% of the host's {load['cores']} cores "
        f"busy; load average {load['load']:.1f}")
    for rank, rec in enumerate(r222):
        pod, flat = rec["2x2x2"], rec["4x2"]
        same = all(pod[key] == flat[key] for key in ("err", "res", "nnz_u",
                                                     "nnz_v"))
        if not (same and np.array_equal(pod["u"], flat["u"])
                and np.array_equal(pod["v"], flat["v"])):
            raise AssertionError(f"2x2x2 rank {rank}: the fit is not bitwise "
                                 "the same ranks' 4x2 fit")
        if pod["health"] != -1 or not pod["finite"]:
            raise AssertionError(f"2x2x2 rank {rank} is unhealthy")
        if (device != "cpu"
                and pod["launches"]["bsr_spmm_gram"] != 2 * POD_ITERS):
            raise AssertionError(f"2x2x2 rank {rank}: bsr_spmm_gram "
                                 f"{pod['launches']['bsr_spmm_gram']} (want "
                                 f"{2 * POD_ITERS})")
    pod = r222[0]["2x2x2"]
    # the 1x1 fit's error at the same iteration
    err_1x1 = a1["fit"]["err"][POD_ITERS - 1]
    d_last = abs(pod["err"][-1] - err_1x1)
    if d_last >= 0.02:
        raise AssertionError(f"2x2x2: last error {pod['err'][-1]:.6f} is "
                             f"{d_last:.3e} from the 1x1 fit's (bar 0.02)")
    for name in ("2x2x2", "4x2"):
        for rank, rec in enumerate(r222):
            c = rec[name]["collectives"]
            log(f"[mesh] {name} rank {rank}: {rec[name]['iter_ms']:.3f} ms "
                f"an iteration (the engine, {POD_ITERS} iterations, ingest "
                f"excluded), launches {rec[name]['launches']}, all_reduce "
                f"{c['all_reduce'] / POD_ITERS:.0f} calls / "
                f"{c['bytes'] / POD_ITERS:.0f} bytes an iteration, peak "
                f"{rec[name]['peak_mb']:.1f} MiB")
    log(f"[mesh] 2x2x2 (rows over (pod, data); eight gloo ranks share one "
        f"card: host round trips, not a multi-card result): traces, NNZ and "
        f"factors bitwise the same ranks' 4x2 fit on every rank; final "
        f"error {pod['err'][-1]:.6f} after {POD_ITERS} iterations, "
        f"{d_last:.3e} from the 1x1 fit's {err_1x1:.6f} at the same "
        f"iteration (bar 0.02); NNZ(U) {pod['nnz_u'][-1]}, "
        f"NNZ(V) {pod['nnz_v'][-1]}; spawn to result {secs:.1f} s")
    paths["mesh_fit_2x2x2"] = pod["launches"]
    out["2x2x2"] = dict(
        ranks=[{n: {k: v for k, v in rec[n].items() if k not in ("u", "v")}
                for n in ("2x2x2", "4x2")} for rec in r222],
        last_err_diff_1x1=d_last, seconds=secs)

    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[mesh] phase 19 took {out['seconds']:.1f} s (four ranks share one "
        "card over gloo: the 2x2 / 4x1 times are not a multi-card result)")


def nmf_command_line(device):
    """Phase 19(e), run beside phase 25's untimed work (a run's time
    limit): ``python -m torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.nmf_run --solver distributed --backend cuda-bsr
    --mesh 2x2 --dist-backend gloo --small`` exits 0; its fit line."""
    import os

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
        f" --mesh 2x2 --dist-backend gloo --small: exit 0 in {cli_s:.1f} s"
        f" (beside phase 25's untimed work); {fit_line}")
    return dict(seconds=cli_s, line=fit_line)


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


#: phase 21: llama3.2-1b training at full width and depth on train_4k's
#: sequence (4096), the global batch cut from 256 to 8 (one card, a run's
#: time limit) in two microbatches of 4, 1 timed step (5 until phase 23
#: came, 3 until phase 25(d), 2 until 25(f): the script's time limit);
#: the held checks at full width with 2
#: layers; four gloo ranks for the compressed gradients
TRAIN = dict(batch=8, microbatches=2, timed=1, check_layers=2,
             check_batch=2, check_seq=1024, attn_seq=4096, density=0.25,
             cli=("--batch", "2", "--seq", "32"))


def train_flops(cfg, b, s):
    """Model FLOPs of one train step (forward + backward = 3 x forward,
    no recompute): every layer's projections (of a mixture of experts, the
    router and the ``moe_top_k`` experts a token runs: its active
    parameters), attention over the causal (row, key) pairs, and the
    unembedding, at 2 FLOPs a multiply-add."""
    ffn = 3 * cfg.d_model * cfg.d_ff * max(cfg.moe_top_k, 1) \
        + cfg.d_model * cfg.n_experts
    proj = 2 * (cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
                + cfg.q_dim * cfg.d_model + ffn)
    fwd = float(b) * s * (cfg.n_layers * proj + 2 * cfg.d_model * cfg.vocab)
    fwd += cfg.n_layers * 4.0 * b * cfg.n_heads * cfg.hd * s * (s + 1) / 2
    return 3.0 * fwd


def _compress_rank(rank, arrays, device, density):
    """One rank of phase 21(d): two calls of ``make_compressed_grad_fn``
    on a 4x1 grid (a data axis of 4) for the least-squares loss of
    ``tests/test_distributed.py:108-141``, the error slot carried."""
    import torch

    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )
    from repro_torch.training import init_error_state, make_compressed_grad_fn

    dev = torch.device(device)
    mesh = make_nmf_mesh(4, 1, device=dev)

    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    params = {"w": torch.from_numpy(arrays["w"]).to(dev)}
    batch = {k: torch.from_numpy(arrays[k]).to(dev) for k in ("x", "y")}
    grad_fn = make_compressed_grad_fn(loss_fn, mesh, ("data",), density)
    err = init_error_state(params, 4)
    reset_collective_counts()
    out = []
    for _ in range(2):
        loss, g, new = grad_fn(params, batch, err)
        out.append(dict(loss=float(loss), g=g["w"].cpu().numpy(),
                        err_in=err["w"].cpu().numpy(),
                        err=new["w"].cpu().numpy()))
        err = new
    return out, collective_counts()


def compressed_grads_on_ranks(card, density):
    """Phase 21(d)'s ranks: :func:`_compress_rank` on four gloo ranks (on
    the card, sharing it, unless ``card`` is false).  It needs no kernel and
    times nothing a metric reads, so it runs beside the build (a run's
    time limit).  Returns the problem, each rank's result and the
    seconds."""
    from repro_torch.launch.mesh import spawn_mesh

    # the least-squares problem of tests/test_distributed.py:108-141
    arrays = {"w": np.random.default_rng(0).standard_normal((8, 4))
              .astype(np.float32),
              "x": np.random.default_rng(1).standard_normal((16, 8))
              .astype(np.float32),
              "y": np.random.default_rng(2).standard_normal((16, 4))
              .astype(np.float32)}
    device = "cuda:0" if card else "cpu"
    t0 = time.perf_counter()
    rank_out = spawn_mesh(_compress_rank, 4, 1, backend="gloo",
                          device=device, args=(arrays, device, density),
                          timeout=300.0)
    return arrays, rank_out, time.perf_counter() - t0


def launcher_kill_and_resume(archs, cli, card):
    """For each of ``archs``: ``python -m repro_torch.launch.train --arch
    ARCH --smoke --deterministic`` stopped at 6 steps (checkpoints every 3)
    and rerun to 9, against an uninterrupted 9-step run: the step-9 states
    must be bitwise equal.  Every architecture's runs go in the same two
    waves (the stopped and the uninterrupted runs, then the reruns).
    Returns, by architecture, the seconds of the waves, the checkpointer's
    lines and the leaf count."""
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint import load_checkpoint_arrays

    root = tempfile.mkdtemp(prefix="train-ck-")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))

    def run(arch, *a):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               arch, "--smoke", "--ckpt-every", "3", "--deterministic",
               *cli, *a] + ([] if card else ["--device", "cpu"])
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def finish(p):
        try:
            o, e = p.communicate(timeout=300)
        finally:
            p.kill()
        if p.returncode != 0:
            raise AssertionError(f"the train launcher exited {p.returncode}: "
                                 f"{e[-3000:]}")
        return o

    t0 = time.perf_counter()
    dirs = {arch: (os.path.join(root, arch, "a"), os.path.join(root, arch,
                                                               "b"))
            for arch in archs}
    wave = {arch: (run(arch, "--steps", "6", "--ckpt-dir", a),
                   run(arch, "--steps", "9", "--ckpt-dir", b))
            for arch, (a, b) in dirs.items()}
    outs = {arch: [finish(p) for p in ps] for arch, ps in wave.items()}
    wave = {arch: run(arch, "--steps", "9", "--ckpt-dir", a)
            for arch, (a, _) in dirs.items()}
    for arch, p in wave.items():
        outs[arch].append(finish(p))
    cli_s = time.perf_counter() - t0
    result = {}
    for arch, (a_dir, b_dir) in dirs.items():
        first_out, whole_out, resumed_out = outs[arch]
        if "resuming from checkpoint step 6" not in resumed_out:
            raise AssertionError(f"the {arch} rerun did not resume from step "
                                 f"6: {resumed_out[-2000:]}")
        got, _ = load_checkpoint_arrays(a_dir, 9)
        want, _ = load_checkpoint_arrays(b_dir, 9)
        differ = [n for n in want if not np.array_equal(got[n], want[n])]
        if got.keys() != want.keys() or differ:
            raise AssertionError(f"the {arch} resumed run's step-9 state "
                                 f"differs from the uninterrupted run's in "
                                 f"{differ}")
        saves = [ln for ln in (first_out + resumed_out + whole_out
                               ).splitlines() if ln.startswith("checkpoints:")]
        log(f"[train] python -m repro_torch.launch.train --arch {arch} "
            f"--smoke --deterministic: stopped at 6 steps, rerun to 9 "
            f"(\"resuming from checkpoint step 6\"); parameters, mu, nu and "
            f"step at step 9 bitwise the uninterrupted 9-step run's "
            f"({len(want)} leaves, torch.use_deterministic_algorithms on); "
            f"{3 * len(dirs)} runs of {len(dirs)} architectures in two waves"
            f" {cli_s:.1f} s; AsyncCheckpointer {saves}")
        result[arch] = dict(seconds=cli_s, saves=saves, leaves=len(want))
    shutil.rmtree(root, ignore_errors=True)
    return result


def run_train_slice(dev, paths, results, cli, compress, cfg=None,
                    sizes=TRAIN):
    """Phase 21: the LM training half.  (a) llama3.2-1b at full width and
    depth: ``make_train_step`` (bf16 compute, remat, two microbatches) on
    train_4k's sequence at a cut batch, a warm-up step and ``timed`` timed
    ones, the launch counts of those steps, peak memory, a profiler window
    and a split of a microbatch's time; (b) the held checks at full width
    with 2 layers; (c) the train launcher killed and resumed in
    subprocesses (``cli``: the future of the runs :func:`main` started
    beside the build); (d) compressed gradients on four gloo ranks sharing
    the card (``compress``: the future of :func:`compressed_grads_on_ranks`,
    started beside the build too).  ``cfg`` and ``sizes`` shrink it for
    a rehearsal on the CPU."""
    import math

    import torch

    from repro_torch.configs import ARCHS, SHAPES, ShapeSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import api, common, transformer
    from repro_torch.training import AdamW
    from repro_torch.training.optimizer import value_and_grad

    t_phase = time.perf_counter()
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    cfg = cfg or ARCHS[LM_ARCH]
    out = {}
    if card:
        torch.cuda.empty_cache()

    # -- 21(a). train steps at full width ------------------------------------
    full = SHAPES["train_4k"]
    shape = ShapeSpec("train_4k cut", sizes.get("seq", full.seq_len),
                      sizes["batch"], "train")
    m = sizes["microbatches"]
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, tied embeddings {cfg.tie_embeddings}; f32 "
        f"parameters from seed 0, bf16 compute, remat; train_4k's sequence "
        f"{shape.seq_len}, global batch {shape.global_batch} (cut from "
        f"{full.global_batch}: one card, a run's time limit), {m} "
        f"microbatches of {shape.global_batch // m}")
    model = api.init_params(cfg, 0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW()
    state = opt.init(model)
    step = api.make_train_step(cfg, opt, microbatches=m)
    batches = [synthetic_batch(cfg, shape, i, dev)
               for i in range(sizes["timed"] + 2)]
    # step 0's loss must be the cross-entropy of the serving path's f32
    # logits (the flash kernel's forward) on the same batch and parameters;
    # the mean logit of each position's own token says how far the tied
    # unembedding lifts the loss above ln(vocab)
    ce, own = [], []
    with torch.no_grad():
        for r in range(shape.global_batch):
            tok = batches[0]["tokens"][r:r + 1]
            logits = transformer.forward(model, tok, cfg)[0]     # (S, V)
            y = batches[0]["labels"][r, 1:].long()
            ce.append(-torch.log_softmax(logits[:-1], -1).gather(
                -1, y[:, None]).mean())
            own.append(logits.gather(-1, tok[0].long()[:, None]).mean())
            del logits
    ce0, own0 = float(torch.stack(ce).mean()), float(torch.stack(own).mean())
    losses, step_s = [], []
    sync()
    t0 = time.perf_counter()
    model, state, loss = step(model, state, batches[0])
    losses.append(float(loss))
    warm_s = time.perf_counter() - t0
    if card:
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    for i in range(1, sizes["timed"] + 1):
        sync()
        t0 = time.perf_counter()
        model, state, loss = step(model, state, batches[i])
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    paths["train_step"] = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() if card else 0
    tokens = shape.global_batch * shape.seq_len
    flops = train_flops(cfg, shape.global_batch, shape.seq_len)
    med = float(np.median(step_s))
    log(f"[train] {n_params:,} parameters; warm-up step {warm_s:.2f} s; "
        f"{sizes['timed']} steps {[round(1e3 * s, 1) for s in step_s]} ms "
        f"(median {1e3 * med:.1f} ms, {tokens / med:.0f} tokens/s); model "
        f"FLOPs a step {flops:.4e} ({flops / med / 1e12:.1f} TFLOP/s, "
        f"{100 * flops / med / BF16_FLOPS:.1f}% of the bf16 peak); peak "
        f"memory {peak / 2**30:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; launches of the hand-written "
        f"kernels in the timed steps {paths['train_step']}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a train step's loss is not finite: {losses}")
    close("step 0's loss against the serving path's cross-entropy",
          torch.tensor(losses[0]), torch.tensor(ce0), 5e-2, 1e-1)
    log(f"[train] step 0's loss {losses[0]:.4f}; the serving path's "
        f"cross-entropy on the same batch {ce0:.4f} (flash forward, f32 "
        f"logits; bar rtol 5e-2, atol 1e-1); ln(vocab) "
        f"{math.log(cfg.vocab):.4f}; a position's own token's logit "
        f"{own0:.4f} on average (the tied unembedding)")
    if any(paths["train_step"].values()):
        raise AssertionError("the train step launched a hand-written kernel"
                             f" ({paths['train_step']}): it takes the plain "
                             "attention path, as the reference trains")
    out["steps"] = dict(n_params=n_params, warmup_s=warm_s, step_s=step_s,
                        serving_ce0=ce0, own_token_logit0=own0,
                        median_ms=1e3 * med, tokens_per_s=tokens / med,
                        model_flops=flops, tflops=flops / med / 1e12,
                        mfu=flops / med / BF16_FLOPS, peak_bytes=peak,
                        losses=losses, launches=paths["train_step"],
                        batch=shape.global_batch, seq=shape.seq_len,
                        microbatches=m)
    if card:
        out["profile"] = profiled(
            f"train step ({shape.global_batch} x {shape.seq_len}, {m} "
            "microbatches)", lambda: step(model, state, batches[-1]))

    # where a microbatch's time goes, each part timed alone (host clock
    # ending in a synchronize)
    mb = {k: x[:shape.global_batch // m] for k, x in batches[0].items()}
    loss_fn = api.make_loss_fn(cfg)
    named = dict(model.named_parameters())

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, time.perf_counter() - t0

    split = {}
    lv, split["forward_s"] = timed(lambda: loss_fn(model, mb))
    grads, split["backward_s"] = timed(
        lambda: torch.autograd.grad(lv, list(named.values())))
    _, split["optimizer_s"] = timed(lambda: opt.update(
        dict(zip(named, grads)), state, model))
    del lv, grads
    with torch.no_grad():
        hidden = transformer.forward(model, mb["tokens"], cfg, unembed=False,
                                     flash=False)
    hidden.requires_grad_(True)
    cl, split["loss_chunks_fwd_s"] = timed(lambda: common.chunked_lm_loss(
        hidden, transformer.unembed_matrix(model, cfg), mb["labels"]))
    _, split["loss_chunks_bwd_s"] = timed(
        lambda: torch.autograd.grad(cl, [hidden, model.embed
                                         if cfg.tie_embeddings
                                         else model.unembed]))
    del cl, hidden
    layers_fwd = split["forward_s"] - split["loss_chunks_fwd_s"]
    est_ms = 1e3 * (m * (split["forward_s"] + split["backward_s"])
                    + split["optimizer_s"])
    log(f"[train] one microbatch ({shape.global_batch // m} x "
        f"{shape.seq_len}): forward {1e3 * split['forward_s']:.1f} ms (the "
        f"loss chunks {1e3 * split['loss_chunks_fwd_s']:.1f}); backward "
        f"{1e3 * split['backward_s']:.1f} ms (the loss chunks, recomputed, "
        f"{1e3 * split['loss_chunks_bwd_s']:.1f}; the layers' recompute is "
        f"their forward again, ~{1e3 * layers_fwd:.1f}); the optimizer "
        f"{1e3 * split['optimizer_s']:.1f} ms a step; a step is {m} x "
        f"(forward + backward) + the optimizer = "
        f"{est_ms:.1f} ms against {1e3 * med:.1f} measured")
    out["split"] = split
    del model, state, batches, step, named, mb
    if card:
        torch.cuda.empty_cache()

    # -- 21(b). the held checks at full width, 2 layers --------------------
    cfg2 = dataclasses.replace(cfg, n_layers=sizes["check_layers"])
    m2 = api.init_params(cfg2, 1, device=dev)
    shape2 = ShapeSpec("check", sizes["check_seq"], sizes["check_batch"],
                       "train")
    b2 = synthetic_batch(cfg2, shape2, 0, dev)
    f32 = torch.float32
    held = {}
    with torch.no_grad():
        hidden = transformer.forward(m2, b2["tokens"], cfg2,
                                     compute_dtype=f32, unembed=False,
                                     flash=False)
        w = transformer.unembed_matrix(m2, cfg2)
    h1, w1 = hidden.clone().requires_grad_(), w.clone().requires_grad_()
    lc = common.chunked_lm_loss(h1, w1, b2["labels"], compute_dtype=f32)
    gc = torch.autograd.grad(lc, (h1, w1))
    h2, w2 = hidden.clone().requires_grad_(), w.clone().requires_grad_()
    logp = torch.log_softmax(h2 @ w2, dim=-1)
    ln = -torch.gather(logp[:, :-1], -1,
                       b2["labels"][:, 1:, None].long())[..., 0].mean()
    gn = torch.autograd.grad(ln, (h2, w2))
    held["chunked_loss"] = close("chunked loss", lc, ln, 1e-4, 1e-5)
    held["chunked_loss_grads"] = max(
        close("chunked loss gradient", a, b, 1e-3, 1e-5)
        for a, b in zip(gc, gn))
    del hidden, w, h1, w1, h2, w2, logp, gc, gn

    captured = []

    class Capture(AdamW):
        def update(self, grads, st, params):
            captured.append({k: g.clone() for k, g in grads.items()})
            return params, st

    step_losses = [float(api.make_train_step(
        cfg2, Capture(), microbatches=mi, compute_dtype=f32)(m2, None, b2)[2])
        for mi in (1, 2)]
    rel = 0.0
    for name, g1 in captured[0].items():
        g2 = captured[1][name]
        scale = float(g1.abs().max())
        close(f"gradient of {name}, 2 microbatches against 1", g2, g1, 1e-4,
              1e-4 * scale)
        rel = max(rel, float((g2 - g1).abs().max()) / max(scale, 1e-30))
    held["microbatch_grad_rel"] = rel
    held["microbatch_loss"] = close("loss, 2 microbatches against 1",
                                    torch.tensor(step_losses[1]),
                                    torch.tensor(step_losses[0]), 1e-5, 1e-6)
    del captured, m2, b2

    gen = torch.Generator(device=dev).manual_seed(21)
    s = sizes["attn_seq"]
    qkv = [torch.randn(shape, generator=gen, device=dev)
           for shape in ((1, s, cfg.n_heads, cfg.hd),
                         (1, s, cfg.n_kv_heads, cfg.hd),
                         (1, s, cfg.n_kv_heads, cfg.hd))]
    cot = torch.randn((1, s, cfg.n_heads, cfg.hd), generator=gen, device=dev)
    grads = []
    for chunked in (True, False):
        xs = [x.clone().requires_grad_() for x in qkv]
        o = (common._plain_attention(*xs, cfg, True) if chunked
             else common._attend(*xs, cfg, True, 0))
        grads.append([o.detach()] + list(torch.autograd.grad(o, xs, cot)))
    if s * s <= common._ATTN_CHUNK_THRESHOLD:
        raise AssertionError(f"S = {s} does not take the q-chunked path")
    held["q_chunked_out"] = close("q-chunked attention", grads[0][0],
                                  grads[1][0], 1e-5, 1e-6)
    held["q_chunked_grads"] = max(
        close("q-chunked attention gradient", a, b, 1e-4, 1e-5)
        for a, b in zip(grads[0][1:], grads[1][1:]))
    del grads
    groups = cfg.n_heads // cfg.n_kv_heads
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (x.to(dtype) for x in qkv)
        with torch.no_grad():
            plain = common._plain_attention(q, k, v, cfg, True)
            fl = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 groups=groups).transpose(1, 2)
        name = str(dtype).split(".")[-1]
        rtol, atol = FLASH_VS_PLAIN_TOL[name]
        held[f"flash_vs_plain_{name}"] = close(
            f"flash against the plain path ({name})", fl, plain, rtol, atol)
    del qkv, cot, q, k, v, plain, fl
    log(f"[train] held at full width, {cfg2.n_layers} layers, batch "
        f"{shape2.global_batch} x {shape2.seq_len}: chunked loss against an "
        f"unchunked log_softmax (f32) {held['chunked_loss']:.3e} (rtol 1e-4,"
        f" atol 1e-5), its gradients {held['chunked_loss_grads']:.3e} (1e-3 "
        f"/ 1e-5); one step's gradient, 2 microbatches against 1 (f32), "
        f"largest difference {held['microbatch_grad_rel']:.3e} of a leaf's "
        f"largest entry (rtol 1e-4), loss {held['microbatch_loss']:.3e}; "
        f"q-chunked attention at S = {s} against the whole S x S path (f32): "
        f"output {held['q_chunked_out']:.3e} (1e-5 / 1e-6), input gradients "
        f"{held['q_chunked_grads']:.3e} (1e-4 / 1e-5); flash against the "
        f"plain path: bf16 "
        f"{held['flash_vs_plain_bfloat16']:.3e}, f32 "
        f"{held['flash_vs_plain_float32']:.3e} (bars 5e-2 / 5e-2 and 2e-3 "
        "/ 2e-3)")
    out["held"] = held

    # -- 21(d). compressed gradients on four gloo ranks (run beside the
    # build) -------------------------------------------------------------------
    arrays, rank_out, ranks_s = compress.result()
    w = torch.from_numpy(arrays["w"]).to(dev).requires_grad_()
    lfull = torch.mean((torch.from_numpy(arrays["x"]).to(dev) @ w
                        - torch.from_numpy(arrays["y"]).to(dev)) ** 2)
    full = torch.autograd.grad(lfull, w)[0].cpu().numpy()
    cons = []
    for call in range(2):
        outs = [r[0][call] for r in rank_out]
        recon = outs[0]["g"] + np.mean([o["err"] for o in outs], axis=0)
        want_g = full + np.mean([o["err_in"] for o in outs], axis=0)
        cons.append(float(np.max(np.abs(recon - want_g))))
    if max(cons) >= 1e-5:
        raise AssertionError(f"compressed gradients do not conserve: {cons}")
    log(f"[train] make_compressed_grad_fn on four gloo ranks sharing the "
        f"card, density {sizes['density']}: conservation "
        f"{[f'{c:.3e}' for c in cons]} over two calls (bar 1e-5); loss "
        f"{rank_out[0][0][0]['loss']:.6f} (full batch "
        f"{float(lfull.detach()):.6f}); collectives a rank {rank_out[0][1]}; "
        f"{ranks_s:.1f} s (beside the build)")
    out["compressed"] = dict(conservation=cons, seconds=ranks_s,
                             collectives=rank_out[0][1])

    # -- 21(c). the train launcher, killed at 6 steps and resumed to 9, at
    # the smoke config of this family and of phases 22 and 24's ----------
    out["cli"] = cli.result()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase 21 took {out['seconds']:.1f} s")
    results["train"] = out


#: phase 22: olmoe-1b-7b (src/repro/configs/olmoe_1b_7b.py) at full width:
#: serving at full depth (4 x 4096 prefill, an 8-request ServingEngine,
#: prompts of 16 and 16 new tokens each: 32 and 32 until 25(f) came, the
#: script's time limit; its tokens/s are host-bound);
#: training with the depth cut from 16 to 4 (parameters, AdamW's moments
#: and the gradient of 16 layers, 6.92e9 x 16 B, would take ~111 GB) on
#: 2 x 4096 tokens in two microbatches; the checks on one full-width MoE
#: layer over 256 tokens and on 2 layers over 2 x 1024; expert
#: parallelism on four gloo ranks sharing the card over 4 x 256 tokens
MOE_ARCH = "olmoe-1b-7b"
MOE = dict(prefill_batch=4, prefill_seq=4096, layer_tokens=256, requests=8,
           prompt=16, max_new=16,
           check_layers=2, check_batch=2, check_seq=1024,
           train_layers=4, train_batch=2, train_seq=4096, microbatches=2,
           timed=3, ep_batch=4, ep_seq=256, ep_timed=5, ep_seed=7)
#: expert parallelism's grids, (pods, rows, cols): (data, model) = 2x2 and
#: (pod, data, model) = 2x1x2
EP_GRIDS = ((1, 2, 2), (2, 1, 2))


def _moe_layer_inputs(cfg, b, s, dev, seed):
    """One full-width MoE layer's router and experts (f32) and tokens (B,
    S, d), drawn from ``seed`` on ``dev``: the same in every process."""
    import torch

    from repro_torch.models.moe import init_moe_ffn

    gen = torch.Generator(device=dev).manual_seed(seed)
    p = init_moe_ffn(gen, cfg)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    return p, x


def _moe_ep_rank(rank, cfg, sizes, device):
    """One rank of phase 22(c): ``moe_ffn_ep`` of one MoE layer on each
    grid of ``EP_GRIDS``: this rank's block of the output, the collectives
    of one call, and the host-clock ms of ``ep_timed`` calls (each after
    a barrier, ending in a synchronize)."""
    import torch

    from repro_torch.launch.mesh import (
        collective_counts, make_nmf_mesh, reset_collective_counts,
    )
    from repro_torch.models.moe import ep_block, moe_ffn_ep

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    p, x = _moe_layer_inputs(cfg, sizes["ep_batch"], sizes["ep_seq"], dev,
                             sizes["ep_seed"])
    out = {}
    for pods, rows, cols in EP_GRIDS:
        mesh = make_nmf_mesh(rows, cols, device=dev, pods=pods)
        moe_ffn_ep(p, x, cfg, mesh)                 # warm-up
        sync()
        reset_collective_counts()
        y = moe_ffn_ep(p, x, cfg, mesh)
        sync()
        counts = collective_counts()
        times = []
        for _ in range(sizes["ep_timed"]):
            mesh.barrier()
            sync()
            t0 = time.perf_counter()
            moe_ffn_ep(p, x, cfg, mesh)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        bsl, ssl = ep_block(mesh, x.shape[0], x.shape[1])
        out[(pods, rows, cols)] = dict(
            y=y.cpu().numpy(), block=(bsl.start, bsl.stop, ssl.start,
                                      ssl.stop), counts=counts, ms=times)
    return out


def run_moe_slice(dev, paths, results, cfg=None, sizes=MOE):
    """Phase 22: the moe family at full width.  (a) olmoe-1b-7b serving at
    full depth: a 4 x 4096 prefill (first call, then the median of 3;
    tokens/s, peak memory, busy share, flash launches), a ServingEngine
    draining 8 requests (16 before phase 25(d) came: the script's time
    limit) and a decode tick; one full-width MoE layer on
    256 tokens in f32 against the same layer on the CPU (routing equal,
    output within 1e-4) and against the dense mixture at capacity 8.0
    (the reference's bar); the flash attention against the plain path at
    2 layers in bf16.  (b) training at full width, 4 layers: bf16, remat,
    AdamW, two microbatches; ms a step, tokens/s, model FLOPs counting the
    active experts, peak memory; step 0's loss against the serving path's
    cross-entropy (the launcher's kill and resume at the smoke config runs
    in 21(c)).  (c) expert parallelism on four gloo ranks sharing the card,
    against the plain single-process body.  ``cfg`` and ``sizes`` shrink
    it for a rehearsal on the CPU."""
    import math

    import torch

    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import api, moe
    from repro_torch.models.common import attention, rmsnorm
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.training import AdamW

    t_phase = time.perf_counter()
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    cfg = cfg or ARCHS[MOE_ARCH]
    out = {}
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -- 22(a). serving at full width and depth ------------------------------
    t0 = time.perf_counter()
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[moe] {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.hd}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, top "
        f"{cfg.moe_top_k}, vocab {cfg.vocab}): {n_params:,} parameters in "
        f"f32, drawn on the card in {time.perf_counter() - t0:.2f} s")
    step = api.make_prefill_step(cfg)
    b, s_len = sizes["prefill_batch"], sizes["prefill_seq"]
    batch = api.make_batch(cfg, ShapeSpec("prefill", s_len, b, "prefill"),
                           seed=1, device=dev)
    _build.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    logits = step(model, batch)
    sync()
    first_s = time.perf_counter() - t0
    paths["moe_prefill"] = _build.launch_counts()
    finite = bool(torch.isfinite(logits).all())
    if tuple(logits.shape) != (b, cfg.vocab) or not finite:
        raise AssertionError("the moe prefill's logits are not finite (B, "
                             "vocab)")
    if card and paths["moe_prefill"]["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"the moe prefill launched the flash kernel "
                             f"{paths['moe_prefill']['flash_attention']} "
                             f"times, not n_layers = {cfg.n_layers}")
    runs = host_ms(lambda: step(model, batch), 3, sync)
    prefill_ms = float(np.median(runs))
    peak = torch.cuda.max_memory_allocated() if card else 0
    cap = max(int(math.ceil(b * s_len * cfg.moe_top_k / cfg.n_experts
                            * 1.25)), cfg.moe_top_k)
    log(f"[moe] prefill B={b} x S={s_len} (one dispatch group of {b * s_len}"
        f" tokens, capacity {cap} an expert): logits {tuple(logits.shape)} "
        f"finite; first call {first_s:.3f} s (the bf16 copies cast); "
        f"{prefill_ms:.2f} ms (median of {[round(x, 2) for x in runs]}), "
        f"{b * s_len / prefill_ms * 1e3:.0f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {paths['moe_prefill']}")
    out["prefill"] = dict(n_params=n_params, first_s=first_s, runs_ms=runs,
                          ms=prefill_ms,
                          tokens_per_s=b * s_len / prefill_ms * 1e3,
                          peak_bytes=peak, capacity=cap,
                          launches=paths["moe_prefill"])
    if card:
        out["prefill"]["profile"] = profiled(
            f"olmoe prefill B={b} x S={s_len}", lambda: step(model, batch))
    del logits

    rng = np.random.default_rng(2)
    engine = ServingEngine(cfg, model, max_batch=SERVE["max_batch"],
                           max_seq=SERVE["max_seq"], device=dev)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab,
                                               sizes["prompt"]).tolist(),
                    max_new=sizes["max_new"])
            for i in range(sizes["requests"])]
    for r in reqs:
        engine.submit(r)
    sync()
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    sync()
    serve_s = time.perf_counter() - t0
    emitted = sum(len(r.out) for r in reqs)
    if len(done) != len(reqs) or any(r.error or not r.out for r in reqs):
        raise AssertionError("the moe serving engine did not drain every "
                             "request with tokens")
    del engine
    cache = moe.init_cache(cfg, SERVE["max_batch"], SERVE["max_seq"],
                           device=dev)
    tok = torch.randint(0, cfg.vocab, (SERVE["max_batch"],), device=dev,
                        dtype=torch.int32)
    decode = api.make_decode_step(cfg)
    ticks = host_ms(lambda: decode(model, cache, tok, 64), 10, sync)
    tick_ms = float(np.median(ticks))
    log(f"[moe] ServingEngine (max_batch {SERVE['max_batch']}, max_seq "
        f"{SERVE['max_seq']}; prompts of {sizes['prompt']}, max_new "
        f"{sizes['max_new']}) drained {len(done)} requests: {emitted} tokens"
        f" in {serve_s:.3f} s, {emitted / serve_s:.1f} tokens/s; a decode "
        f"tick (batch {SERVE['max_batch']}, one dispatch group of "
        f"{SERVE['max_batch']} tokens) {tick_ms:.3f} ms (median of 10, host "
        "clock)")
    out["serve"] = dict(seconds=serve_s, tokens=emitted,
                        tokens_per_s=emitted / serve_s, tick_ms=tick_ms,
                        ticks_ms=ticks)
    del cache

    # the full-width MoE layer in f32: the card against the CPU, and
    # against the dense mixture (every token through its top k experts)
    p0 = model.layers[0].moe.leaves(torch.float32)
    p0_cpu = {n: t.detach().cpu() for n, t in p0.items()}
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1, sizes["layer_tokens"], cfg.d_model), generator=gen)
    xd = x.to(dev)
    k, e = cfg.moe_top_k, cfg.n_experts
    cap = max(int(math.ceil(x.shape[1] * k / e * 1.25)), k)
    with torch.no_grad():
        _, sel_d = moe.router_topk(xd, p0["router"], k)
        _, sel_c = moe.router_topk(x, p0_cpu["router"], k)
        keep_d = moe.expert_slots(sel_d, e, cap)[1]
        keep_c = moe.expert_slots(sel_c, e, cap)[1]
        if not (torch.equal(sel_d.cpu(), sel_c)
                and torch.equal(keep_d.cpu(), keep_c)):
            raise AssertionError("the MoE layer routes differently on the "
                                 "card and on the CPU")
        layer_err = close("MoE layer, card against CPU (f32)",
                          moe.moe_ffn(p0, xd, cfg).cpu(),
                          moe.moe_ffn(p0_cpu, x, cfg), 1e-4, 1e-4)
        got8 = moe.moe_ffn(p0, xd, cfg, capacity_factor=8.0)[0]
        gates, sel = moe.router_topk(xd[0], p0["router"], k)
        dense_w = torch.zeros((x.shape[1], e), device=dev).scatter(
            1, sel, gates)
        h = torch.nn.functional.silu(torch.einsum(
            "td,edf->etf", xd[0], p0["w_gate"])) * torch.einsum(
                "td,edf->etf", xd[0], p0["w_up"])
        oracle = torch.einsum("te,etd->td", dense_w, torch.einsum(
            "etf,efd->etd", h, p0["w_down"]))
        oracle_err = close("MoE layer at capacity 8.0 against the dense "
                           "mixture", got8, oracle, 2e-2, 2e-3)
    dropped = int((~keep_d).sum())
    log(f"[moe] one full-width MoE layer on {x.shape[1]} tokens (f32, "
        f"capacity {cap}, {dropped} of {keep_d.numel()} pairs dropped): "
        f"routing and kept pairs equal on the card and the CPU, output "
        f"within 1e-4 (max abs err {layer_err:.3e}); at capacity 8.0 "
        f"against the dense mixture within rtol 2e-2, atol 2e-3 (max abs "
        f"err {oracle_err:.3e})")
    del p0_cpu, h, oracle

    # the prefill's flash attention against the plain path, the first
    # layers, bf16, each layer's attention on the same input
    cb, cs = sizes["check_batch"], sizes["check_seq"]
    toks = torch.randint(0, cfg.vocab, (cb, cs), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))
    layers, _ = model.compute_weights(torch.bfloat16)
    positions = torch.arange(cs, dtype=torch.int32, device=dev).expand(cb,
                                                                       cs)
    flash_errs = []
    with torch.no_grad():
        h = model.embed[toks.long()].to(torch.bfloat16)
        for lp in layers[:sizes["check_layers"]]:
            hn = rmsnorm(h, lp["norm_attn"], cfg.norm_eps)
            flash_errs.append(close(
                "olmoe attention, flash against plain (bf16)",
                attention(lp["attn"], hn, cfg, positions, flash=True),
                attention(lp["attn"], hn, cfg, positions, flash=False),
                *FLASH_VS_PLAIN_TOL["bfloat16"]))
            h = moe.layer_fwd(lp, h, cfg, positions)
    log(f"[moe] the flash attention against the plain path on the first "
        f"{sizes['check_layers']} layers' inputs ({cb} x {cs}, H = Hkv = "
        f"{cfg.n_heads}, hd {cfg.hd}, bf16): max abs err "
        f"{[f'{v:.3e}' for v in flash_errs]} (bar rtol 5e-2, atol 5e-2)")
    out["checks"] = dict(layer_err=layer_err, oracle_err=oracle_err,
                         layer_capacity=cap, layer_dropped=dropped,
                         flash_vs_plain=flash_errs)
    del model, layers, h, hn, p0, x, xd
    if card:
        torch.cuda.empty_cache()

    # -- 22(b). training at full width, 4 layers ------------------------------
    cfg4 = dataclasses.replace(cfg, n_layers=sizes["train_layers"])
    tshape = ShapeSpec("train_4k cut", sizes["train_seq"],
                       sizes["train_batch"], "train")
    m = sizes["microbatches"]
    model = api.init_params(cfg4, 0, device=dev)
    n4 = sum(p.numel() for p in model.parameters())
    opt = AdamW()
    state = opt.init(model)
    step = api.make_train_step(cfg4, opt, microbatches=m)
    batches = [synthetic_batch(cfg4, tshape, i, dev)
               for i in range(sizes["timed"] + 1)]
    ce = []
    with torch.no_grad():
        for r in range(tshape.global_batch):
            tok = batches[0]["tokens"][r:r + 1]
            lg = moe.forward(model, tok, cfg4)[0]              # (S, V) f32
            y = batches[0]["labels"][r, 1:].long()
            ce.append(-torch.log_softmax(lg[:-1], -1).gather(
                -1, y[:, None]).mean())
            del lg
    ce0 = float(torch.stack(ce).mean())
    if card:
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    sync()
    t0 = time.perf_counter()
    model, state, loss = step(model, state, batches[0])
    losses.append(float(loss))
    warm_s = time.perf_counter() - t0
    _build.reset_launch_counts()
    for bt in batches[1:]:
        sync()
        t0 = time.perf_counter()
        model, state, loss = step(model, state, bt)
        losses.append(float(loss))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    paths["moe_train"] = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() if card else 0
    tokens = tshape.global_batch * tshape.seq_len
    flops = train_flops(cfg4, tshape.global_batch, tshape.seq_len)
    med = float(np.median(step_ms))
    log(f"[moe] training {cfg4.name} at full width, depth cut from "
        f"{cfg.n_layers} to {cfg4.n_layers} (reduced: parameters, AdamW "
        f"state and gradients of all {cfg.n_layers} layers would not fit): "
        f"{n4:,} parameters; {tshape.global_batch} x {tshape.seq_len} "
        f"tokens in {m} microbatches, bf16 compute, remat; warm-up step "
        f"{warm_s:.2f} s; {len(step_ms)} steps "
        f"{[round(x, 1) for x in step_ms]} ms (median {med:.1f} ms, "
        f"{tokens / med * 1e3:.0f} tokens/s); model FLOPs a step (active "
        f"parameters: the router and the top {cfg.moe_top_k} experts a "
        f"token) {flops:.4e}, {flops / med / 1e9:.1f} TFLOP/s, "
        f"{100 * flops / (med / 1e3) / BF16_FLOPS:.2f}% of the bf16 peak; "
        f"peak memory {peak / 2**30:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; hand-written kernels launched "
        f"{paths['moe_train']}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a moe train step's loss is not finite: "
                             f"{losses}")
    close("moe step 0's loss against the serving path's cross-entropy",
          torch.tensor(losses[0]), torch.tensor(ce0), 5e-2, 1e-1)
    if any(paths["moe_train"].values()):
        raise AssertionError(f"the moe train step launched a hand-written "
                             f"kernel ({paths['moe_train']})")
    log(f"[moe] step 0's loss {losses[0]:.4f}; the serving path's "
        f"cross-entropy on the same batch {ce0:.4f} (flash forward, f32 "
        f"logits; bar rtol 5e-2, atol 1e-1); ln(vocab) "
        f"{math.log(cfg.vocab):.4f}")
    out["train"] = dict(layers=cfg4.n_layers, n_params=n4, warmup_s=warm_s,
                        step_ms=step_ms, median_ms=med,
                        tokens_per_s=tokens / med * 1e3, model_flops=flops,
                        mfu=flops / (med / 1e3) / BF16_FLOPS,
                        peak_bytes=peak, losses=losses, serving_ce0=ce0,
                        launches=paths["moe_train"],
                        reduced="n_layers 16 -> 4; global batch 256 -> 2")
    del model, state, batches, step
    if card:
        torch.cuda.empty_cache()

    # -- 22(c). expert parallelism on four gloo ranks sharing the card -------
    device = "cuda:0" if card else "cpu"
    t0 = time.perf_counter()
    ranks = spawn_mesh(_moe_ep_rank, 2, 2, backend="gloo", device=device,
                       args=(cfg, sizes, device), timeout=300.0)
    ranks_s = time.perf_counter() - t0
    p, x = _moe_layer_inputs(cfg, sizes["ep_batch"], sizes["ep_seq"], dev,
                             sizes["ep_seed"])
    with torch.no_grad():
        plain = moe.moe_ffn_ep_plain(p, x, cfg, dp=2, model=2).cpu().numpy()
    out["ep"] = {}
    for grid in EP_GRIDS:
        name = "x".join(map(str, grid if grid[0] > 1 else grid[1:]))
        errs = []
        for rec in ranks:
            r = rec[grid]
            b0, b1, s0, s1 = r["block"]
            errs.append(float(np.max(np.abs(r["y"] - plain[b0:b1, s0:s1]))))
            close(f"expert parallelism on {name}, a rank's block against "
                  "the plain body (f32)", torch.from_numpy(r["y"]),
                  torch.from_numpy(plain[b0:b1, s0:s1]), 1e-5, 1e-5)
        c = ranks[0][grid]["counts"]
        ms = [float(np.median(rec[grid]["ms"])) for rec in ranks]
        log(f"[moe] expert parallelism on {name} ({sizes['ep_batch']} x "
            f"{sizes['ep_seq']} tokens, d {cfg.d_model}, {cfg.n_experts} "
            f"experts, top {cfg.moe_top_k}; four gloo ranks share one card: "
            f"host round trips, not a multi-card exchange): every rank's "
            f"block within 1e-5 of the plain single-process body (max abs "
            f"err {max(errs):.3e}); a layer: {c.get('all_to_all', 0)} "
            f"all_to_all / {c.get('all_to_all_bytes', 0)} bytes sent a rank,"
            f" {c['all_reduce']} all_reduce; ms a layer by rank "
            f"{[round(v, 3) for v in ms]} (medians of {sizes['ep_timed']})")
        out["ep"][name] = dict(max_err=max(errs), counts=c, ms=ms)
    out["ep_seconds"] = ranks_s
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[moe] phase 22 took {out['seconds']:.1f} s")
    results["moe"] = out


#: phase 23: the hybrid (zamba2-7b, src/repro/configs/zamba2_7b.py) and ssm
#: (xlstm-125m, src/repro/configs/xlstm_125m.py) families at full width:
#: serving at full depth (4 x 4096 and 1 x 32768 prefills, a ServingEngine
#: of 8 slots draining 16 requests, an f32 prefill against decode); zamba2
#: training with the
#: depth cut from 81 to 15 (two groups of 6 and a tail of 3: parameters,
#: AdamW's moments and gradients of 81 layers, ~20 B a parameter, would
#: take ~135 GB) and the global batch cut from 256 to 2; xlstm training at
#: full depth with the global batch cut from 256 to 4 in one microbatch
#: (its sLSTM loop runs 4096 steps a layer a microbatch: a run's time
#: limit), its profiler window over a 4 x 1024 prefill and its long
#: prefill cut to 1 x 8192 (the same loop, ~5k launches a 1024 steps;
#: since phase 25 came; 1 x 4096 since 25(f)); zamba2's profiler window over a 4 x 1024 prefill
#: too (since phase 25(e) came: the script's time limit); the flash kernel at
#: zamba2's head size 112.  Since 25(f) came (the script's time limit):
#: one timed prefill after the first call (a median of 3 before; zamba2's
#: and xlstm's take 2.4-2.9 s each), and xlstm trains on 4 x 1024 tokens
#: (4 x 4096 before: 15 s in its sLSTM loop), zamba2's first train
#: step is timed itself (a warm-up and one timed step before), and xlstm's
#: engine drains prompts of 8 and 8 new tokens (32 and 32 before: its
#: tokens/s are host-bound)
RECURRENT = dict(prefill_batch=4, prefill_seq=4096, long_seq=32768,
                 block_tokens=256, decode_check=64, hybrid_train_layers=15,
                 hybrid_train_batch=2, xlstm_train_batch=4, train_seq=4096,
                 microbatches=2, xlstm_microbatches=1, hybrid_timed=0,
                 xlstm_timed=0, xlstm_profile_seq=1024, xlstm_long_seq=4096,
                 long_pos=524287, long_prompt=16, flash_reps=20,
                 plain_reps=3, hybrid_prompt=8, hybrid_max_new=4,
                 hybrid_requests=16, hybrid_profile_seq=1024,
                 prefill_reps=1, xlstm_train_seq=1024, ssm_prompt=8,
                 ssm_max_new=8)
HYBRID_ARCH, SSM_ARCH = "zamba2-7b", "xlstm-125m"
#: flash at zamba2's shared block (B, H, Hkv, S, hd) and at olmoe's heads
FLASH_HD112 = (4, 32, 32, 4096, 112)
FLASH_OLMOE = (4, 16, 16, 4096, 128)


def recurrent_flops(cfg, b, s):
    """Model FLOPs of one forward of a hybrid or xlstm model over (b, s)
    tokens, 2 a multiply-add: every projection, the chunkwise SSD (chunks
    of 128: C B^T, the decayed sums with x and the state's read and
    update), the shared block's projections and causal attention after
    each group, the mLSTM's chunkwise products (chunks of 256) and the
    sLSTM's recurrence, and the unembedding.  A train step is 3 times
    this (no recompute)."""
    d, tokens = cfg.d_model, float(b) * s
    out = 2 * d * cfg.vocab * tokens
    if cfg.family == "hybrid":
        di, n = 2 * d, cfg.ssm_state
        h, p, q = di // cfg.ssm_head_dim, cfg.ssm_head_dim, min(128, s)
        mamba = 2 * (d * (2 * di + 2 * n + h) + di * d) \
            + 2 * (q * n + h * q * p + 2 * h * p * n)
        shared = 2 * (d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
                      + 3 * d * cfg.d_ff)
        groups = cfg.n_layers // cfg.attn_every
        out += tokens * (cfg.n_layers * mamba + groups * shared)
        out += groups * 4.0 * b * cfg.n_heads * cfg.hd * s * (s + 1) / 2
        return out
    h, up = cfg.n_heads, 2 * d
    hd_m, hd_s, q = up // h, d // h, min(256, s)
    mlstm = 2 * (d * 2 * up + 3 * up * up + up * 2 * h + up * d) \
        + 2 * h * (2 * q * hd_m + 3 * hd_m * hd_m)
    slstm = 2 * (d * 4 * d + d * d) + 2 * h * hd_s * 4 * hd_s
    n_s = len(cfg.slstm_at)
    return out + tokens * ((cfg.n_layers - n_s) * mlstm + n_s * slstm)


def _serve_model(name, cfg, model, step, sizes, dev, paths, key, card,
                 profile_expect=None, profile_seq=None, long_seq=None):
    """The prefill of one model at B x S (first call with its launches,
    then the median of ``sizes["prefill_reps"]`` (default 3)), a profiler
    window of one call (at B x
    ``profile_seq`` if given), and one 1 x ``long_seq`` prefill (default
    ``sizes["long_seq"]``); returns the numbers."""
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import _build
    from repro_torch.models import api

    sync = torch.cuda.synchronize if card else (lambda: None)
    b, s_len = sizes["prefill_batch"], sizes["prefill_seq"]
    batch = api.make_batch(cfg, ShapeSpec("prefill", s_len, b, "prefill"),
                           seed=1, device=dev)
    if card:
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    logits = step(model, batch)
    sync()
    first_s = time.perf_counter() - t0
    paths[key] = _build.launch_counts()
    if tuple(logits.shape) != (b, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"the {name} prefill's logits are not finite "
                             "(B, vocab)")
    runs = []
    for _ in range(sizes.get("prefill_reps", 3)):
        sync()
        t0 = time.perf_counter()
        step(model, batch)
        sync()
        runs.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(runs))
    peak = torch.cuda.max_memory_allocated() if card else 0
    log(f"[recurrent] {name} prefill B={b} x S={s_len}: logits "
        f"{tuple(logits.shape)} finite; first call {first_s:.3f} s (the "
        f"bf16 copies cast); {ms:.2f} ms (median of "
        f"{[round(x, 2) for x in runs]}), {b * s_len / ms * 1e3:.0f} "
        f"tokens/s; peak memory {peak / 2**30:.2f} GiB; launches "
        f"{paths[key]}")
    out = dict(first_s=first_s, runs_ms=runs, ms=ms,
               tokens_per_s=b * s_len / ms * 1e3, peak_bytes=peak,
               launches=paths[key])
    if card:
        t0 = time.perf_counter()
        p_len = profile_seq or s_len
        p_batch = batch if p_len == s_len else api.make_batch(
            cfg, ShapeSpec("prefill", p_len, b, "prefill"), seed=1,
            device=dev)
        out["profile"] = profiled(f"{name} prefill B={b} x S={p_len}",
                                  lambda: step(model, p_batch),
                                  expect=profile_expect, cpu=False)
        log(f"[recurrent] the profiler window and its summary took "
            f"{time.perf_counter() - t0:.1f} s")
        del p_batch
    del logits, batch
    # one prefill at prefill_32k's length (or the cut ``long_seq``), the
    # batch cut from 32 to 1
    long_seq = long_seq or sizes["long_seq"]
    long_batch = api.make_batch(
        cfg, ShapeSpec("prefill_32k cut", long_seq, 1, "prefill"),
        seed=3, device=dev)
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    logits = step(model, long_batch)
    sync()
    long_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if card else 0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"the {name} 1 x {long_seq} prefill's "
                             "logits are not finite")
    log(f"[recurrent] {name} prefill 1 x {long_seq} (prefill_32k, "
        f"batch cut from 32 to 1: one card"
        f"{'' if long_seq == sizes['long_seq'] else '; length cut'}): "
        f"finite, {long_s:.3f} s, {long_seq / long_s:.0f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB")
    out["long"] = dict(seconds=long_s, peak_bytes=peak, seq=long_seq)
    return out


def _free(card, what, tag="recurrent"):
    """Collect the cycles that still hold tensors (the first
    ``torch.utils.checkpoint`` call of a process imports a module lazily
    and leaves its callers' frames, a train step's model and state, in a
    cycle) and return the card's cache; logs what stays allocated."""
    import gc

    import torch

    gc.collect()
    if card:
        torch.cuda.empty_cache()
        log(f"[{tag}] before {what}: "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")


def _drain(name, cfg, model, dev, card, prompt=None, max_new=None,
           requests=None):
    """A ServingEngine (max_batch 8, max_seq 512) draining ``requests``
    (16) requests of ``prompt``-token prompts (32), ``max_new`` (32) new
    tokens each: seconds, tokens/s, ms a decode call."""
    import torch

    from repro_torch.serving import Request, ServingEngine

    prompt, max_new = prompt or SERVE["prompt"], max_new or SERVE["max_new"]
    requests = requests or SERVE["requests"]
    sync = torch.cuda.synchronize if card else (lambda: None)
    rng = np.random.default_rng(2)
    engine = ServingEngine(cfg, model, max_batch=SERVE["max_batch"],
                           max_seq=SERVE["max_seq"], device=dev)
    calls = []
    inner = engine._decode

    def counted(*a):
        calls.append(1)
        return inner(*a)

    engine._decode = counted
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab,
                                               prompt).tolist(),
                    max_new=max_new)
            for i in range(requests)]
    for r in reqs:
        engine.submit(r)
    sync()
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    sync()
    serve_s = time.perf_counter() - t0
    emitted = sum(len(r.out) for r in reqs)
    if len(done) != len(reqs) or any(r.error or not r.out for r in reqs):
        raise AssertionError(f"the {name} serving engine did not drain "
                             "every request with tokens")
    tick_ms = 1e3 * serve_s / len(calls)
    log(f"[recurrent] {name} ServingEngine (max_batch {SERVE['max_batch']},"
        f" max_seq {SERVE['max_seq']}; prompts of {prompt}, max_new "
        f"{max_new}) drained {len(done)} requests: "
        f"{emitted} tokens in {serve_s:.3f} s, {emitted / serve_s:.1f} "
        f"tokens/s; {len(calls)} decode calls (prompt tokens one a call, as "
        f"the reference's engine feeds them), {tick_ms:.3f} ms a call; the "
        "engine decodes every slot at the first active slot's position and "
        "feeds each prompt through every slot's state (ROADMAP queue 3 item "
        "1), so this measures time, not answers")
    return dict(seconds=serve_s, tokens=emitted,
                tokens_per_s=emitted / serve_s, decode_calls=len(calls),
                tick_ms=tick_ms, prompt=prompt, max_new=max_new)


def _train_model(name, cfg, sizes, batch, timed, dev, paths, key, card,
                 reduced, microbatches=None, seq=None):
    """Warm-up and ``timed`` steps of ``make_train_step`` (bf16, remat,
    AdamW, ``microbatches`` of them, by default ``sizes["microbatches"]``)
    at a global batch of ``batch`` x ``seq`` (default
    ``sizes["train_seq"]``) (``timed`` 0:
    the first step alone, timed and counted itself, where a step's
    seconds dwarf its set-up); step 0's loss against the serving path's
    cross-entropy on the same batch; no hand-written kernel launched."""
    import math

    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import _build
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import api
    from repro_torch.training import AdamW

    sync = torch.cuda.synchronize if card else (lambda: None)
    _free(card, f"training {name}")
    tshape = ShapeSpec("train_4k cut", seq or sizes["train_seq"], batch,
                       "train")
    m = microbatches or sizes["microbatches"]
    model = api.init_params(cfg, 0, device=dev)
    n = sum(p.numel() for p in model.parameters())
    opt = AdamW()
    state = opt.init(model)
    step = api.make_train_step(cfg, opt, microbatches=m)
    batches = [synthetic_batch(cfg, tshape, i, dev)
               for i in range(timed + 1)]
    mod = api.module_for(cfg)
    ce = []
    with torch.no_grad():
        rows = max(1, batch // 2)
        for r in range(0, batch, rows):
            lg = mod.forward(model, batches[0]["tokens"][r:r + rows], cfg)
            y = batches[0]["labels"][r:r + rows, 1:].long()
            ce.append(-torch.log_softmax(lg[:, :-1], -1).gather(
                -1, y[..., None]).mean() * lg.shape[0])
            del lg
    ce0 = float(torch.stack(ce).sum()) / batch
    if card:
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    if not timed:
        _build.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    model, state, loss = step(model, state, batches[0])
    losses.append(float(loss))
    warm_s = time.perf_counter() - t0
    if timed:
        _build.reset_launch_counts()
    else:
        step_ms.append(1e3 * warm_s)
    for bt in batches[1:]:
        sync()
        t0 = time.perf_counter()
        model, state, loss = step(model, state, bt)
        losses.append(float(loss))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    paths[key] = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() if card else 0
    tokens = batch * tshape.seq_len
    flops = 3.0 * recurrent_flops(cfg, batch, tshape.seq_len)
    med = float(np.median(step_ms))
    log(f"[recurrent] training {name} ({reduced}): {n:,} parameters; "
        f"{batch} x {tshape.seq_len} tokens in {m} "
        f"microbatch{'es' if m > 1 else ''}, bf16 "
        f"compute, remat, AdamW; "
        + (f"warm-up step {warm_s:.2f} s; " if timed else
           "the first step timed itself (no warm-up); ")
        + f"{len(step_ms)} steps {[round(x, 1) for x in step_ms]} ms (median "
        f"{med:.1f} ms, {tokens / med * 1e3:.0f} tokens/s); model FLOPs a "
        f"step {flops:.4e}, {flops / med / 1e9:.1f} TFLOP/s, "
        f"{100 * flops / (med / 1e3) / BF16_FLOPS:.2f}% of the bf16 peak; "
        f"peak memory {peak / 2**30:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; hand-written kernels launched "
        f"{paths[key]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a {name} train step's loss is not finite: "
                             f"{losses}")
    close(f"{name} step 0's loss against the serving path's cross-entropy",
          torch.tensor(losses[0]), torch.tensor(ce0), 5e-2, 1e-1)
    if any(paths[key].values()):
        raise AssertionError(f"the {name} train step launched a "
                             f"hand-written kernel ({paths[key]})")
    log(f"[recurrent] {name} step 0's loss {losses[0]:.4f}; the serving "
        f"path's cross-entropy on the same batch {ce0:.4f} (bar rtol 5e-2, "
        f"atol 1e-1); ln(vocab) {math.log(cfg.vocab):.4f}")
    del model, state, batches, step
    return dict(n_params=n, warmup_s=warm_s, step_ms=step_ms, median_ms=med,
                tokens_per_s=tokens / med * 1e3, model_flops=flops,
                mfu=flops / (med / 1e3) / BF16_FLOPS, peak_bytes=peak,
                losses=losses, serving_ce0=ce0, launches=paths[key],
                batch=batch, seq=tshape.seq_len, reduced=reduced)


def run_recurrent_slice(dev, paths, results, rows, cfgs=None,
                        sizes=RECURRENT):
    """Phase 23: the hybrid and ssm families at full width.  (a)
    zamba2-7b serving at full depth (4 x 4096 prefill with 13 flash
    launches at hd 112, 1 x 32768, a ServingEngine, an f32 prefill against
    decode); (b) one full-width Mamba block and the shared block on 256
    tokens in f32, card against CPU, and the block's decode against its
    forward; (c) zamba2-7b training at 15 layers; (d) xlstm-125m serving
    at full depth (prefills with the sLSTM layers' share, the engine, one
    long_500k decode step, an mLSTM and an sLSTM block card against CPU,
    mLSTM decode against parallel); (e) xlstm-125m training; (f) the flash
    kernel at zamba2's shape and its yardsticks.  ``cfgs`` (hybrid, ssm)
    and ``sizes`` shrink it for a rehearsal on the CPU."""
    import dataclasses as dc
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import api, hybrid, mamba, xlstm
    from repro_torch.models.transformer import layer_fwd

    t_phase = time.perf_counter()
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    hcfg, xcfg = cfgs or (ARCHS[HYBRID_ARCH], ARCHS[SSM_ARCH])
    out = {"part_seconds": {}}
    t_mark = [t_phase]

    def took(part):
        now = time.perf_counter()
        out["part_seconds"][part] = now - t_mark[0]
        log(f"[recurrent] 23({part}) took {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    _free(card, f"serving {hcfg.name}")
    groups = hcfg.n_layers // hcfg.attn_every

    # -- 23(a). zamba2-7b serving at full width and depth --------------------
    t0 = time.perf_counter()
    model = api.init_params(hcfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[recurrent] {hcfg.name} at full width ({hcfg.n_layers} Mamba2 "
        f"layers, d_model {hcfg.d_model}, d_inner {2 * hcfg.d_model}, "
        f"{mamba.n_ssm_heads(hcfg)} SSM heads of {hcfg.ssm_head_dim}, state "
        f"{hcfg.ssm_state}; the shared block after every {hcfg.attn_every}: "
        f"{groups} applications, {hcfg.n_heads}/{hcfg.n_kv_heads} heads of "
        f"{hcfg.hd}, d_ff {hcfg.d_ff}; vocab {hcfg.vocab}): {n_params:,} "
        f"parameters in f32, drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    long_len = sizes["long_pos"] + 1
    kv_long = groups * long_len * hcfg.kv_dim * 2 * 2
    log(f"[recurrent] {hcfg.name} long_500k does not fit one card: its "
        f"{groups} shared-block KV caches at {long_len} positions take "
        f"{groups} x {long_len} x {hcfg.kv_dim} x 2 (K, V) x 2 B = "
        f"{kv_long / 1e9:.1f} GB in bf16 (it waits for parameter and cache "
        "sharding over several cards)")
    match = f"flash_fwd_bf16_wgmma<{hcfg.hd}>"
    a = _serve_model(hcfg.name, hcfg, model, api.make_prefill_step(hcfg),
                     sizes, dev, paths, "hybrid_prefill", card,
                     profile_expect={match: groups},
                     profile_seq=sizes["hybrid_profile_seq"])
    a["n_params"] = n_params
    a["long_500k_kv_bytes"] = kv_long
    if card:
        if paths["hybrid_prefill"]["flash_attention"] != groups:
            raise AssertionError(
                f"the zamba2 prefill launched the flash kernel "
                f"{paths['hybrid_prefill']['flash_attention']} times, not "
                f"{groups}")
        seen = a["profile"]["launches_matching"][match]
        if seen != groups:
            raise AssertionError(f"the profiler window shows {seen} launches"
                                 f" of {match}, not {groups}")
        log(f"[recurrent] the profiler window shows {seen} launches of "
            f"{match} a prefill (the shared block's attention at hd "
            f"{hcfg.hd})")
    a["serve"] = _drain(hcfg.name, hcfg, model, dev, card,
                        sizes["hybrid_prompt"], sizes["hybrid_max_new"],
                        sizes["hybrid_requests"])

    # f32 prefill against f32 decode over 64 tokens (the f32 flash kernel
    # at hd 112 on the model's path), the reference's Mamba bar
    s = sizes["decode_check"]
    toks = torch.randint(0, hcfg.vocab, (1, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    _build.reset_launch_counts()
    with torch.no_grad():
        full = hybrid.forward(model, toks, hcfg, compute_dtype=torch.float32)
    f32_launches = _build.launch_counts()["flash_attention"]
    cache = hybrid.init_cache(hcfg, 1, s, dtype=torch.float32, device=dev)
    for t in range(s):
        logits, cache = hybrid.decode_step(model, cache, toks[:, t], t, hcfg,
                                           compute_dtype=torch.float32)
    dec_err = close(f"{hcfg.name} f32 prefill against decode",
                    logits, full[:, -1, :], 2e-2, 2e-2)
    if card and f32_launches != groups:
        raise AssertionError(f"the f32 prefill launched the flash kernel "
                             f"{f32_launches} times, not {groups}")
    log(f"[recurrent] {hcfg.name} f32 forward over {s} tokens (the f32 "
        f"flash kernel at hd {hcfg.hd}, {f32_launches} launches) against "
        f"{s} f32 decode steps: last-position logits within 2e-2 (max abs "
        f"err {dec_err:.3e})")
    a["decode_vs_prefill_err"] = dec_err
    del full, cache, logits
    took("a")

    # -- 23(b). one Mamba block and the shared block, f32, card against CPU -
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1, sizes["block_tokens"], hcfg.d_model), generator=gen)
    xd = x.to(dev)
    positions = torch.arange(x.shape[1], dtype=torch.int32)[None]
    mp = model.groups[0][0].leaves(torch.float32)
    mp_cpu = {k: v.detach().cpu() for k, v in mp.items()}
    sp = model.shared.weights(torch.float32)
    sp_cpu = {k: ({n: t.detach().cpu() for n, t in v.items()}
                  if isinstance(v, dict) else v.detach().cpu())
              for k, v in sp.items()}
    with torch.no_grad():
        y_card = mamba.mamba_block(mp, xd, hcfg)
        mamba_err = close("a full-width Mamba block, card against CPU (f32)",
                          y_card.cpu(), mamba.mamba_block(mp_cpu, x, hcfg),
                          1e-4, 1e-4)
        shared_err = close(
            "the shared block, card against CPU (f32)",
            layer_fwd(sp, xd, hcfg, positions.to(dev)).cpu(),
            layer_fwd(sp_cpu, x, hcfg, positions), 1e-4, 1e-4)
        st = mamba.init_mamba_state(hcfg, 1, device=dev)
        steps = []
        for t in range(x.shape[1]):
            y_t, st = mamba.mamba_decode(mp, xd[:, t:t + 1], st, hcfg)
            steps.append(y_t)
        mdec_err = close("the Mamba block's decode against its forward",
                         torch.cat(steps, 1), y_card, 2e-2, 2e-2)
    log(f"[recurrent] one full-width Mamba block on {x.shape[1]} tokens "
        f"(f32): card against CPU within 1e-4 (max abs err "
        f"{mamba_err:.3e}); the shared block (attention through the f32 "
        f"flash kernel at hd {hcfg.hd}, MLP): within 1e-4 (max abs err "
        f"{shared_err:.3e}); the block's {x.shape[1]} decode steps against "
        f"its forward on the card within 2e-2 (max abs err {mdec_err:.3e})")
    out["hybrid_blocks"] = dict(mamba_err=mamba_err, shared_err=shared_err,
                                decode_err=mdec_err)
    out["hybrid_serve"] = a
    del model, mp, mp_cpu, sp, sp_cpu, y_card, steps
    took("b")

    # -- 23(c). zamba2-7b training, depth cut to 15 ---------------------------
    ht = sizes["hybrid_train_layers"]
    cfg15 = dc.replace(hcfg, n_layers=ht)
    g15, t15 = divmod(ht, hcfg.attn_every)
    out["hybrid_train"] = _train_model(
        cfg15.name, cfg15, sizes, sizes["hybrid_train_batch"],
        sizes["hybrid_timed"], dev, paths, "hybrid_train", card,
        f"full width; n_layers {hcfg.n_layers} -> {ht} ({g15} groups of "
        f"{hcfg.attn_every} and a tail of {t15}); global batch 256 -> "
        f"{sizes['hybrid_train_batch']}")
    took("c")

    # -- 23(d). xlstm-125m serving at full width and depth ------------------
    _free(card, f"serving {xcfg.name}")
    model = api.init_params(xcfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    n_x = sum(p.numel() for p in model.parameters())
    log(f"[recurrent] {xcfg.name} at full width and depth ({xcfg.n_layers} "
        f"layers, sLSTM at {xcfg.slstm_at}, d_model {xcfg.d_model}, "
        f"{xcfg.n_heads} heads: mLSTM heads of "
        f"{2 * xcfg.d_model // xcfg.n_heads}, sLSTM heads of "
        f"{xcfg.d_model // xcfg.n_heads}; "
        f"vocab {xcfg.vocab}): {n_x:,} parameters in f32")
    d = _serve_model(xcfg.name, xcfg, model, api.make_prefill_step(xcfg),
                     sizes, dev, paths, "ssm_prefill", card,
                     profile_seq=sizes["xlstm_profile_seq"],
                     long_seq=sizes["xlstm_long_seq"])
    d["n_params"] = n_x
    # the sLSTM layers' share: each layer of one prefill timed alone
    b, s_len = sizes["prefill_batch"], sizes["prefill_seq"]
    toks = torch.randint(0, xcfg.vocab, (b, s_len), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))
    layer_ms = []
    with torch.no_grad():
        layers, _ = model.compute_weights(torch.bfloat16)
        h = model.embed[toks.long()].to(torch.bfloat16)
        for li, p in enumerate(layers):
            sync()
            t0 = time.perf_counter()
            if li in xcfg.slstm_at:
                h, _ = xlstm.slstm_seq(p, h, xcfg)
            else:
                h = xlstm.mlstm_parallel(p, h, xcfg)
            sync()
            layer_ms.append(1e3 * (time.perf_counter() - t0))
    s_ms = sum(layer_ms[i] for i in xcfg.slstm_at)
    log(f"[recurrent] {xcfg.name} prefill B={b} x S={s_len}, each layer "
        f"timed alone: {[round(x, 1) for x in layer_ms]} ms; the sLSTM "
        f"layers {s_ms:.1f} ms of {sum(layer_ms):.1f} ms "
        f"({100 * s_ms / sum(layer_ms):.1f}%: {s_len} steps a layer, each a "
        f"handful of small launches)")
    d["layer_ms"] = layer_ms
    d["slstm_share"] = s_ms / sum(layer_ms)
    del h, toks
    d["serve"] = _drain(xcfg.name, xcfg, model, dev, card,
                        sizes["ssm_prompt"], sizes["ssm_max_new"])
    # long_500k: one decode step at position 524,287 from a state carried
    # through a prompt; the state is the same size at every position
    states = xlstm.init_state(xcfg, 1, device=dev)
    nbytes = sum(t.numel() * t.element_size() for st in states
                 for t in st.values())
    prompt = torch.randint(0, xcfg.vocab, (sizes["long_prompt"],),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    for t in range(prompt.shape[0]):
        _, states = xlstm.decode_step(model, states, prompt[t:t + 1], t, xcfg)
    sync()
    t0 = time.perf_counter()
    logits, states = xlstm.decode_step(model, states, prompt[-1:],
                                       sizes["long_pos"], xcfg)
    sync()
    long_ms = 1e3 * (time.perf_counter() - t0)
    after = sum(t.numel() * t.element_size() for st in states
                for t in st.values())
    if not bool(torch.isfinite(logits).all()) or after != nbytes:
        raise AssertionError("the long_500k decode step's logits are not "
                             "finite or its state changed size")
    log(f"[recurrent] {xcfg.name} long_500k: one decode step at position "
        f"{sizes['long_pos']:,} after a {prompt.shape[0]}-token prompt: "
        f"logits finite, {long_ms:.3f} ms; the state {after:,} bytes, as at "
        "position 0 (constant in the position)")
    d["long_500k"] = dict(state_bytes=after, ms=long_ms,
                          pos=sizes["long_pos"])
    # an mLSTM and an sLSTM block, f32, card against CPU; mLSTM decode
    # against its parallel form
    x = torch.randn((1, sizes["block_tokens"], xcfg.d_model),
                    generator=torch.Generator().manual_seed(8))
    xd = x.to(dev)
    errs = {}
    with torch.no_grad():
        for li in (0, xcfg.slstm_at[0]):
            p = model.layers[li].leaves(torch.float32)
            pc = {k: v.detach().cpu() for k, v in p.items()}
            if li in xcfg.slstm_at:
                got, want = (xlstm.slstm_seq(p, xd, xcfg)[0],
                             xlstm.slstm_seq(pc, x, xcfg)[0])
                errs["slstm"] = close("an sLSTM block, card against CPU",
                                      got.cpu(), want, 1e-4, 1e-4)
            else:
                got = xlstm.mlstm_parallel(p, xd, xcfg)
                errs["mlstm"] = close("an mLSTM block, card against CPU",
                                      got.cpu(),
                                      xlstm.mlstm_parallel(pc, x, xcfg),
                                      1e-4, 1e-4)
                st = xlstm.init_mlstm_state(xcfg, 1, device=dev)
                steps = []
                for t in range(x.shape[1]):
                    y_t, st = xlstm.mlstm_decode(p, xd[:, t:t + 1], st, xcfg)
                    steps.append(y_t)
                errs["mlstm_decode"] = close(
                    "the mLSTM block's decode against its parallel form",
                    torch.cat(steps, 1), got, 5e-2, 5e-2)
    log(f"[recurrent] on {x.shape[1]} tokens (f32): an mLSTM block card "
        f"against CPU within 1e-4 (max abs err {errs['mlstm']:.3e}), an "
        f"sLSTM block within 1e-4 ({errs['slstm']:.3e}); the mLSTM decode "
        f"against its parallel form within 5e-2 "
        f"({errs['mlstm_decode']:.3e})")
    d["block_errs"] = errs
    out["ssm_serve"] = d
    del model, layers, p, pc
    took("d")

    # -- 23(e). xlstm-125m training at full width and depth ------------------
    out["ssm_train"] = _train_model(
        xcfg.name, xcfg, sizes, sizes["xlstm_train_batch"],
        sizes["xlstm_timed"], dev, paths, "ssm_train", card,
        f"full width and depth; global batch 256 -> "
        f"{sizes['xlstm_train_batch']}, sequence 4096 -> "
        f"{sizes['xlstm_train_seq']}", sizes["xlstm_microbatches"],
        seq=sizes["xlstm_train_seq"])
    took("e")

    # -- 23(f). the flash kernel at the new shapes ----------------------------
    _free(card, "the flash timings")
    flash = {}
    for name, (b, h, hkv, s, hd) in (("zamba2 hd 112", FLASH_HD112),
                                     ("olmoe hd 128", FLASH_OLMOE)):
        gen = torch.Generator(device=dev).manual_seed(hd)
        q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev)
                   .to(torch.bfloat16).transpose(1, 2)
                   for n in (h, hkv, hkv))
        item = dict(shape=[b, h, hkv, s, hd])
        flops = flash_flops(b, h, s, s, hd, True)
        item["bound"] = bound_ms(2 * b * s * hd * (2 * h + 2 * hkv), flops,
                                 BF16_FLOPS)
        timed = cuda_ms if card else (lambda *a, **kw: None)
        item["plain_ms"] = timed(
            lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                            groups=h // hkv),
            reps=sizes["plain_reps"], warmup=1)
        item["library_ms"] = timed(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            reps=sizes["flash_reps"])
        if hd == hcfg.hd:
            with torch.no_grad():
                got = flash_attention(q, k, v, causal=True, groups=h // hkv)
                item["max_abs_err"] = close(
                    "flash at zamba2's shape (bf16)", got,
                    ref.flash_attention_ref(q, k, v, causal=True,
                                            groups=h // hkv),
                    *FLASH_TOL["bfloat16"])
                q32, k32, v32 = (t[:, :, :1024].float() for t in (q, k, v))
                item["f32_max_abs_err"] = close(
                    "flash at zamba2's heads (f32, 1024 rows)",
                    flash_attention(q32, k32, v32, causal=True),
                    ref.flash_attention_ref(q32, k32, v32, causal=True),
                    *FLASH_TOL["float32"])
            item["ms"] = timed(lambda: flash_attention(
                q, k, v, causal=True, groups=h // hkv),
                reps=sizes["flash_reps"])
            item["padded_bound_ms"] = bound_ms(
                0, flash_flops(b, h, s, s, 128, True), BF16_FLOPS)[0]
        flash[name] = item
        log(f"[recurrent] flash at {name} (B={b}, H=Hkv={h}, S={s}, bf16, "
            f"causal): kernel {item.get('ms')} ms; bound "
            f"{item['bound'][0]:.4f} ms by {item['bound'][1]} "
            f"({flops:.4e} FLOPs)"
            + (f", padded to 128 {item['padded_bound_ms']:.4f} ms"
               if "padded_bound_ms" in item else "")
            + f"; plain {item['plain_ms']} ms; "
            f"scaled_dot_product_attention {item['library_ms']} ms"
            + (f"; against its plain version max abs err "
               f"{item['max_abs_err']:.3e} (bf16), "
               f"{item['f32_max_abs_err']:.3e} (f32)"
               if "max_abs_err" in item else ""))
    z = flash["zamba2 hd 112"]
    rows["flash_attention"].setdefault("extra", {})["hd112"] = dict(
        shape=z["shape"], ms=z["ms"], bound_ms=z["bound"][0],
        padded_bound_ms=z["padded_bound_ms"], plain_ms=z["plain_ms"],
        library_ms=z["library_ms"], max_abs_err=z["max_abs_err"],
        f32_max_abs_err=z["f32_max_abs_err"],
        launches_a_prefill=paths["hybrid_prefill"]["flash_attention"])
    o = flash["olmoe hd 128"]
    rows["flash_attention"]["extra"]["olmoe_shape"] = dict(
        shape=o["shape"], plain_ms=o["plain_ms"],
        library_ms=o["library_ms"], bound_ms=o["bound"][0])
    out["flash"] = {nm: {k: v for k, v in it.items() if k != "bound"}
                    | {"bound_ms": it["bound"][0]}
                    for nm, it in flash.items()}
    took("f")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[recurrent] phase 23 took {out['seconds']:.1f} s")
    results["recurrent"] = out


#: phase 24: the encdec family (seamless-m4t-large-v2,
#: src/repro/configs/seamless_m4t_large_v2.py) at full width: serving at
#: full depth (a 4 x 4096-frame prefill; one 1 x 32768 encode, prefill_32k's
#: batch cut from 32 to 1; a generation of 8 rows x 4096 frames, 32 greedy
#: decode steps; one decode step at decode_32k's lengths, its batch cut
#: from 128 to 8: 25.8 GB of cross K / V); card against CPU in f32; training
#: at full width and depth with train_4k's global batch cut from 256 to 8,
#: one timed step (2 until phase 25(f) came: the script's time limit);
#: the flash kernel at the encoder's and the cross-attention's shapes
ENCDEC = dict(prefill_batch=4, prefill_seq=4096, long_seq=32768,
              gen_batch=8, gen_seq=4096, gen_steps=32, d32_batch=8,
              d32_enc=32768, d32_dec=4096, d32_steps=5, block_tokens=256,
              block_dec=32, check_seq=64, check_steps=16, train_batch=8,
              train_seq=4096, microbatches=2, timed=1, flash_reps=20,
              plain_reps=3, unembed_reps=50)
ENCDEC_ARCH = "seamless-m4t-large-v2"
#: flash at the encoder (B, H, Hkv, Sq, T, hd; not causal) and at the
#: decoder's cross-attention, one query row against the memory
FLASH_ENCODER = (4, 16, 16, 4096, 4096, 64)
FLASH_CROSS = {"cross T=4096": (8, 16, 16, 1, 4096, 64),
               "cross T=32768": (8, 16, 16, 1, 32768, 64)}


def encdec_flops(cfg, b, s_enc, s_dec):
    """Model FLOPs of one forward of the encoder over (b, s_enc) frames and
    the teacher-forced decoder over (b, s_dec) tokens, 2 a multiply-add:
    every projection, the encoder's attention over all (row, key) pairs,
    the decoder's causal self-attention, its cross K / V of the memory and
    its cross-attention over every frame, and the unembedding.  A train
    step is 3 times this (no recompute)."""
    d, ff, hh = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd
    attn_proj = 2 * (d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d)
    mlp_f = 2 * 3 * d * ff
    enc = float(b) * s_enc * (attn_proj + mlp_f + 4 * hh * s_enc)
    dec_tok = float(b) * s_dec * (
        attn_proj + 2 * (d * cfg.q_dim + cfg.q_dim * d) + mlp_f
        + 4 * hh * (s_dec + 1) / 2 + 4 * hh * s_enc)
    cross_kv = float(b) * s_enc * 2 * 2 * d * cfg.kv_dim
    return (cfg.n_enc_layers * enc + cfg.n_layers * (dec_tok + cross_kv)
            + 2.0 * d * cfg.vocab * b * s_dec)


def _cache_views(b, h, hkv, t, hd, dtype, dev, seed):
    """q (B, H, 1, hd), the view of a (B, 1, H, hd) projection, and k, v
    (B, Hkv, T, hd), the views of layer 1 of an (L=2, B, T, Hkv, hd)
    cache, as a decode step's cross-attention passes them."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).to(dtype)
    kv = []
    for _ in range(2):
        c = torch.empty((2, b, t, hkv, hd), dtype=dtype, device=dev)
        c.normal_(generator=gen)
        kv.append(c[1].transpose(1, 2))
    return q.transpose(1, 2), kv[0], kv[1]


def run_encdec_slice(dev, paths, results, rows, cfg=None, sizes=ENCDEC):
    """Phase 24: the encdec family at full width.  (a) seamless-m4t-large-v2
    serving at full depth: ``make_prefill_step`` on 4 x 4096 frames (24
    flash launches, in the counts and in the profiler window), a 1 x 32768
    encode, a generation (``prefill`` of 8 x 4096, 32 greedy
    ``decode_step`` s, 24 flash launches a step at one query row, the
    unembedding's share), one decode step at decode_32k's lengths; (b) one
    encoder layer, one decoder layer and ``_cross_kv``, card against CPU in
    f32, and an f32 prefill with 16 decode steps against ``decode_train``;
    (c) training at full width and depth (8 x 4096 frames, 8 x 512
    tokens, two microbatches), step 0's loss against ``seq2seq_loss`` on
    the serving path's memory, no hand-written kernel (the launcher's kill
    and resume at the smoke config runs in 21(c)); (d) the flash kernel at the encoder's and the
    cross-attention's shapes against its plain version, its bound and
    ``scaled_dot_product_attention``.  ``cfg`` and ``sizes`` shrink it for
    a rehearsal on the CPU."""
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import api, encdec
    from repro_torch.models.common import chunked_lm_loss
    from repro_torch.models.transformer import layer_fwd
    from repro_torch.training import AdamW

    t_phase = time.perf_counter()
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    cfg = cfg or ARCHS[ENCDEC_ARCH]
    out = {"part_seconds": {}}
    t_mark = [t_phase]
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers

    def took(part):
        now = time.perf_counter()
        out["part_seconds"][part] = now - t_mark[0]
        log(f"[encdec] 24({part}) took {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    def want_launches(what, got, n):
        if card and got != n:
            raise AssertionError(f"{what} launched the flash kernel {got} "
                                 f"times, not {n}")

    _free(card, f"serving {cfg.name}", "encdec")

    # -- 24(a). serving at full width and depth ------------------------------
    t0 = time.perf_counter()
    model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[encdec] {cfg.name} at full width and depth ({n_enc} encoder and "
        f"{n_dec} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff},"
        f" vocab {cfg.vocab}): {n_params:,} parameters in f32, drawn on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    a = dict(n_params=n_params)
    step = api.make_prefill_step(cfg)
    b, s_len = sizes["prefill_batch"], sizes["prefill_seq"]
    batch = api.make_batch(cfg, ShapeSpec("prefill", s_len, b, "prefill"),
                           seed=1, device=dev)
    if card:
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    memory = step(model, batch)
    sync()
    first_s = time.perf_counter() - t0
    paths["encdec_prefill"] = _build.launch_counts()
    if tuple(memory.shape) != (b, s_len, cfg.d_model) or \
            not bool(torch.isfinite(memory).all()):
        raise AssertionError("the encdec prefill's memory is not finite "
                             "(B, S, d)")
    want_launches("the encdec prefill",
                  paths["encdec_prefill"]["flash_attention"], n_enc)
    runs = host_ms(lambda: step(model, batch), 3, sync)
    ms = float(np.median(runs))
    peak = torch.cuda.max_memory_allocated() if card else 0
    log(f"[encdec] prefill (the encoder) B={b} x S={s_len} frames: memory "
        f"{tuple(memory.shape)} finite; first call {first_s:.3f} s (the "
        f"bf16 copies cast); {ms:.2f} ms (median of "
        f"{[round(x, 2) for x in runs]}), {b * s_len / ms * 1e3:.0f} "
        f"frames/s; peak memory {peak / 2**30:.2f} GiB; launches "
        f"{paths['encdec_prefill']}")
    a["prefill"] = dict(first_s=first_s, runs_ms=runs, ms=ms,
                        frames_per_s=b * s_len / ms * 1e3, peak_bytes=peak,
                        launches=paths["encdec_prefill"])
    if card:
        match = f"flash_fwd_bf16_wgmma<{cfg.hd}>"
        prof = profiled(f"{cfg.name} prefill B={b} x S={s_len}",
                        lambda: step(model, batch), expect={match: n_enc},
                        cpu=False, warmup=True)
        a["prefill"]["profile"] = prof
        if prof["launches_matching"][match] != n_enc:
            raise AssertionError(
                f"the profiler window shows {prof['launches_matching'][match]}"
                f" launches of {match}, not {n_enc}")
        log(f"[encdec] the profiler window shows {n_enc} launches of "
            f"{match} a prefill (the encoder's self-attention, not causal)")
    del memory, batch

    # one encode at prefill_32k's length, the batch cut from 32 to 1
    long_batch = api.make_batch(
        cfg, ShapeSpec("prefill_32k cut", sizes["long_seq"], 1, "prefill"),
        seed=3, device=dev)
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    memory = step(model, long_batch)
    sync()
    long_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if card else 0
    if not bool(torch.isfinite(memory).all()):
        raise AssertionError(f"the 1 x {sizes['long_seq']} encode is not "
                             "finite")
    log(f"[encdec] encode 1 x {sizes['long_seq']} frames (prefill_32k, batch"
        f" cut from 32 to 1: one card): finite, {long_s:.3f} s, "
        f"{sizes['long_seq'] / long_s:.0f} frames/s, peak memory "
        f"{peak / 2**30:.2f} GiB")
    a["long"] = dict(seconds=long_s, peak_bytes=peak, seq=sizes["long_seq"])
    del memory, long_batch

    # a generation: prefill (encode + every layer's cross K / V), then
    # greedy decode steps from token 0, as the reference's test starts
    gb, gs = sizes["gen_batch"], sizes["gen_seq"]
    max_dec = max(gs // cfg.dec_ratio, 16)
    frames = api.make_batch(cfg, ShapeSpec("gen", gs, gb, "prefill"),
                            seed=5, device=dev)["frame_embeds"]
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    cache, memory = encdec.prefill(model, frames, cfg, max_dec=max_dec)
    sync()
    gen_prefill_s = time.perf_counter() - t0
    paths["encdec_gen_prefill"] = _build.launch_counts()
    want_launches("the generation's prefill",
                  paths["encdec_gen_prefill"]["flash_attention"], n_enc)
    kv_bytes = sum(cache[k].numel() * cache[k].element_size()
                   for k in ("ck", "cv"))
    token = torch.zeros((gb,), dtype=torch.int32, device=dev)
    decode = api.make_decode_step(cfg)
    decode(model, cache, token, 0)          # warm-up: row 0, rewritten
    _build.reset_launch_counts()
    step_ms, tokens = [], []
    for pos in range(sizes["gen_steps"]):
        sync()
        t0 = time.perf_counter()
        logits, cache = decode(model, cache, token, pos)
        token = logits.argmax(-1).to(torch.int32)
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        tokens.append(token)
    paths["encdec_decode"] = _build.launch_counts()
    if not bool(torch.isfinite(logits).all()) or \
            tuple(logits.shape) != (gb, cfg.vocab):
        raise AssertionError("the decode step's logits are not finite "
                             "(B, vocab)")
    want_launches(f"{sizes['gen_steps']} decode steps",
                  paths["encdec_decode"]["flash_attention"],
                  n_dec * sizes["gen_steps"])
    dec_ms = float(np.median(step_ms))
    w = model.compute_weights(torch.bfloat16)[2]
    xh = torch.randn((gb, cfg.d_model), device=dev).to(torch.bfloat16)
    timed = cuda_ms if card else (lambda *a_, **kw: float("nan"))
    unembed_ms = timed(lambda: xh @ w, reps=sizes["unembed_reps"])
    gen = dict(prefill_s=gen_prefill_s, max_dec=max_dec,
               cross_kv_bytes=kv_bytes, step_ms=step_ms, ms=dec_ms,
               tokens_per_s=gb / dec_ms * 1e3, unembed_ms=unembed_ms,
               unembed_share=unembed_ms / dec_ms,
               launches=paths["encdec_decode"],
               tokens=torch.stack(tokens, 1)[0].tolist())
    if card:
        gen["profile"] = profiled(f"{cfg.name} decode step (batch {gb})",
                                  lambda: decode(model, cache, token,
                                                 sizes["gen_steps"]),
                                  cpu=False, warmup=True)
    log(f"[encdec] generation: prefill {gb} x {gs} frames (cross K / V of "
        f"{n_dec} layers, {kv_bytes / 1e9:.2f} GB; max_dec {max_dec}) "
        f"{gen_prefill_s:.3f} s; {sizes['gen_steps']} greedy decode steps "
        f"from token 0: {dec_ms:.3f} ms a step (median; "
        f"{[round(x, 2) for x in step_ms[:4]]} ...), {gb / dec_ms * 1e3:.1f}"
        f" tokens/s; flash launches "
        f"{paths['encdec_decode']['flash_attention']} ({n_dec} a step, one query row against {gs} frames); the "
        f"unembedding ({gb} x {cfg.d_model} by {cfg.d_model} x {cfg.vocab}, "
        f"bf16) alone {unembed_ms:.4f} ms, {100 * unembed_ms / dec_ms:.1f}% "
        f"of a step; row 0's tokens {gen['tokens'][:8]} ...")
    a["generation"] = gen
    del cache, memory, frames, logits, xh, w

    # one decode step at decode_32k's lengths, the batch cut from 128 to 8,
    # the cross K / V filled from a seed
    db, de, dd = sizes["d32_batch"], sizes["d32_enc"], sizes["d32_dec"]
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cache = encdec.init_cache(cfg, db, dd, de, device=dev)
    g32 = torch.Generator(device=dev).manual_seed(6)
    for key in ("ck", "cv"):     # by index: no view outlives the loop
        for i in range(n_dec):
            cache[key][i].normal_(generator=g32)
    token = torch.randint(0, cfg.vocab, (db,), device=dev, generator=g32,
                          dtype=torch.int32)
    _build.reset_launch_counts()
    d32_ms = host_ms(lambda: decode(model, cache, token, 0),
                     sizes["d32_steps"], sync)
    paths["encdec_decode_32k"] = _build.launch_counts()
    logits = decode(model, cache, token, 1)[0]
    peak = torch.cuda.max_memory_allocated() if card else 0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("the decode_32k step's logits are not finite")
    want_launches("the decode_32k steps",
                  paths["encdec_decode_32k"]["flash_attention"],
                  n_dec * sizes["d32_steps"])
    kv32 = sum(cache[k].numel() * cache[k].element_size()
               for k in ("ck", "cv"))
    log(f"[encdec] decode_32k (enc_len {de}, max_dec {dd}, batch cut from "
        f"128 to {db}: cross K / V {kv32 / 1e9:.2f} GB in bf16; at 128 rows "
        f"{kv32 * 128 / db / 1e9:.0f} GB): {float(np.median(d32_ms)):.3f} ms"
        f" a step (median of {[round(x, 2) for x in d32_ms]}); logits "
        f"finite; peak memory {peak / 2**30:.2f} GiB; {n_dec} flash launches"
        " a step")
    a["decode_32k"] = dict(step_ms=d32_ms, ms=float(np.median(d32_ms)),
                           cross_kv_bytes=kv32, peak_bytes=peak,
                           launches=paths["encdec_decode_32k"])
    out["serve"] = a
    del cache, logits, token
    _free(card, "the f32 checks", "encdec")
    took("a")

    # -- 24(b). card against CPU in f32 at full width; decode against
    # decode_train ------------------------------------------------------------
    g = torch.Generator().manual_seed(7)
    bt, bd = sizes["block_tokens"], sizes["block_dec"]
    x = torch.randn((1, bt, cfg.d_model), generator=g)
    xd = torch.randn((1, bd, cfg.d_model), generator=g)
    mem = torch.randn((1, bt, cfg.d_model), generator=g)
    ep = model.enc_layers[0].weights(torch.float32)
    dp = model.dec_layers[0].weights(torch.float32)

    def on_cpu(p):
        return {k: ({n: t.detach().cpu() for n, t in v.items()}
                    if isinstance(v, dict) else v.detach().cpu())
                for k, v in p.items()}

    ep_cpu, dp_cpu = on_cpu(ep), on_cpu(dp)
    pos_e = torch.arange(bt, dtype=torch.int32)[None]
    pos_d = torch.arange(bd, dtype=torch.int32)[None]
    errs = {}
    with torch.no_grad():
        errs["encoder_layer"] = close(
            "an encoder layer, card against CPU (f32)",
            layer_fwd(ep, x.to(dev), cfg, pos_e.to(dev), causal=False).cpu(),
            layer_fwd(ep_cpu, x, cfg, pos_e, causal=False), 1e-4, 1e-4)
        errs["decoder_layer"] = close(
            "a decoder layer, card against CPU (f32)",
            encdec.dec_layer_fwd(dp, xd.to(dev), mem.to(dev), cfg,
                                 pos_d.to(dev)).cpu(),
            encdec.dec_layer_fwd(dp_cpu, xd, mem, cfg, pos_d), 1e-4, 1e-4)
        kc, vc = encdec._cross_kv(dp["cross_attn"], mem.to(dev), cfg)
        kw, vw = encdec._cross_kv(dp_cpu["cross_attn"], mem, cfg)
        errs["cross_kv"] = max(
            close("_cross_kv K, card against CPU (f32)", kc.cpu(), kw,
                  1e-4, 1e-4),
            close("_cross_kv V, card against CPU (f32)", vc.cpu(), vw,
                  1e-4, 1e-4))
        # f32 prefill and decode steps against decode_train's logits
        cs, ns = sizes["check_seq"], sizes["check_steps"]
        gen32 = torch.Generator(device=dev).manual_seed(8)
        fe = torch.randn((1, cs, cfg.d_model), generator=gen32, device=dev)
        toks = torch.randint(0, cfg.vocab, (1, ns), generator=gen32,
                             device=dev)
        _build.reset_launch_counts()
        cache, memory = encdec.prefill(model, fe, cfg, max_dec=ns,
                                       compute_dtype=torch.float32)
        for t in range(ns):
            logits, cache = encdec.decode_step(model, cache, toks[:, t], t,
                                               cfg,
                                               compute_dtype=torch.float32)
        f32_launches = _build.launch_counts()["flash_attention"]
        full = encdec.decode_train(model, memory, toks, cfg, remat=False,
                                   compute_dtype=torch.float32)
        errs["decode_vs_decode_train"] = close(
            "f32 decode against decode_train", logits, full[:, -1, :], 2e-3,
            2e-3)
    want_launches("the f32 prefill and decode steps", f32_launches,
                  n_enc + n_dec * ns)
    log(f"[encdec] f32 at full width, card against CPU: an encoder layer on "
        f"{bt} frames (the f32 flash kernel, not causal) within 1e-4 (max "
        f"abs err {errs['encoder_layer']:.3e}); a decoder layer on {bd} "
        f"tokens against {bt} frames {errs['decoder_layer']:.3e}; _cross_kv "
        f"{errs['cross_kv']:.3e}.  An f32 prefill of {cs} frames and {ns} "
        f"decode steps ({f32_launches} f32 flash launches) against "
        f"decode_train's f32 logits at position {ns - 1}: within 2e-3 (max "
        f"abs err {errs['decode_vs_decode_train']:.3e})")
    out["f32_checks"] = errs
    del model, ep, dp, ep_cpu, dp_cpu, cache, memory, full, logits
    took("b")

    # -- 24(c). training at full width and depth ------------------------------
    _free(card, f"training {cfg.name}", "encdec")
    tb, ts, m = sizes["train_batch"], sizes["train_seq"], sizes["microbatches"]
    tshape = ShapeSpec("train_4k cut", ts, tb, "train")
    model = api.init_params(cfg, 0, device=dev)
    opt = AdamW()
    state = opt.init(model)
    train_step = api.make_train_step(cfg, opt, microbatches=m)
    batches = [synthetic_batch(cfg, tshape, i, dev)
               for i in range(sizes["timed"] + 1)]
    s_dec = batches[0]["tokens"].shape[1]
    # step 0's loss against seq2seq_loss on the serving path's memory (the
    # flash kernel, no autograd), row block by row block
    ce = []
    with torch.no_grad():
        rows_ = max(1, tb // 2)
        for r in range(0, tb, rows_):
            sub = {k: v[r:r + rows_] for k, v in batches[0].items()}
            memory = step(model, sub)
            hidden = encdec.decode_train(model, memory, sub["tokens"], cfg,
                                         unembed=False)
            ce.append(chunked_lm_loss(hidden, model.unembed, sub["labels"])
                      * sub["tokens"].shape[0])
            del memory, hidden
    ce0 = float(torch.stack(ce).sum()) / tb
    if card:
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, step_ms = [], []
    sync()
    t0 = time.perf_counter()
    model, state, loss = train_step(model, state, batches[0])
    losses.append(float(loss))
    warm_s = time.perf_counter() - t0
    for bt_ in batches[1:]:
        sync()
        t0 = time.perf_counter()
        model, state, loss = train_step(model, state, bt_)
        losses.append(float(loss))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    paths["encdec_train"] = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() if card else 0
    med = float(np.median(step_ms))
    flops = 3.0 * encdec_flops(cfg, tb, ts, s_dec)
    tok = tb * (ts + s_dec)
    log(f"[encdec] training {cfg.name} at full width and depth (global batch"
        f" 256 -> {tb}): {tb} x {ts} frames and {tb} x {s_dec} tokens in {m}"
        f" microbatches, bf16 compute, remat, AdamW; warm-up step "
        f"{warm_s:.2f} s; {len(step_ms)} steps "
        f"{[round(x, 1) for x in step_ms]} ms (median {med:.1f} ms, "
        f"{tok / med * 1e3:.0f} frames + tokens/s); model FLOPs a step "
        f"{flops:.4e}, {flops / med / 1e9:.1f} TFLOP/s, "
        f"{100 * flops / (med / 1e3) / BF16_FLOPS:.2f}% of the bf16 peak; "
        f"peak memory {peak / 2**30:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; hand-written kernels launched "
        f"{paths['encdec_train']}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"an encdec train step's loss is not finite: "
                             f"{losses}")
    close("encdec step 0's loss against seq2seq_loss on the serving path's "
          "memory", torch.tensor(losses[0]), torch.tensor(ce0), 5e-2, 1e-1)
    if any(paths["encdec_train"].values()):
        raise AssertionError(f"the encdec train step launched a hand-written "
                             f"kernel ({paths['encdec_train']})")
    log(f"[encdec] step 0's loss {losses[0]:.4f}; seq2seq_loss on the "
        f"serving path's memory {ce0:.4f} (bar rtol 5e-2, atol 1e-1); "
        f"ln(vocab) {math.log(cfg.vocab):.4f}")
    out["train"] = dict(warmup_s=warm_s, step_ms=step_ms, median_ms=med,
                        tokens_per_s=tok / med * 1e3, model_flops=flops,
                        mfu=flops / (med / 1e3) / BF16_FLOPS,
                        peak_bytes=peak, losses=losses, serving_ce0=ce0,
                        launches=paths["encdec_train"], batch=tb,
                        frames=ts, tokens=s_dec)
    del model, state, batches, train_step, loss
    took("c")

    # -- 24(d). the flash kernel at this family's shapes ----------------------
    _free(card, "the flash timings", "encdec")
    timed = cuda_ms if card else (lambda *a_, **kw: None)
    flash = {}
    b, h, hkv, sq, t, hd = FLASH_ENCODER
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn((b, n, sq, hd), generator=gen, device=dev)
               .to(torch.bfloat16) for n in (h, hkv, hkv))
    cases = {"encoder": (q, k, v)}
    for name, (b2, h2, hkv2, _, t2, hd2) in FLASH_CROSS.items():
        cases[name] = _cache_views(b2, h2, hkv2, t2, hd2, torch.bfloat16,
                                   dev, seed=t2)
    for name, (q, k, v) in cases.items():
        b2, h2, sq2, hd2 = q.shape
        hkv2, t2 = k.shape[1], k.shape[2]
        flops = flash_flops(b2, h2, sq2, t2, hd2, False)
        nbytes = 2 * (2 * b2 * sq2 * h2 * hd2 + 2 * b2 * t2 * hkv2 * hd2)
        item = dict(shape=[b2, h2, hkv2, sq2, t2, hd2], flops=flops,
                    bytes=nbytes)
        item["bound"] = bound_ms(nbytes, flops, BF16_FLOPS)
        with torch.no_grad():
            got = flash_attention(q, k, v, causal=False,
                                  groups=h2 // hkv2)
            plain = ref.flash_attention_ref(q, k, v, causal=False,
                                            groups=h2 // hkv2)
            item["max_abs_err"] = close(f"flash at {name} (bf16)", got,
                                        plain, *FLASH_TOL["bfloat16"])
        del got, plain
        item["ms"] = timed(lambda: flash_attention(
            q, k, v, causal=False, groups=h2 // hkv2),
            reps=sizes["flash_reps"])
        item["plain_ms"] = timed(lambda: ref.flash_attention_ref(
            q, k, v, causal=False, groups=h2 // hkv2),
            reps=sizes["plain_reps"], warmup=1)
        item["library_ms"] = timed(
            lambda: F.scaled_dot_product_attention(q, k, v),
            reps=sizes["flash_reps"])
        flash[name] = item
        log(f"[encdec] flash at {name} (B={b2}, H=Hkv={h2}, Sq={sq2}, "
            f"T={t2}, hd={hd2}, bf16, not causal): kernel {item['ms']} ms; "
            f"bound {item['bound'][0]:.4f} ms by {item['bound'][1]} "
            f"({flops:.4e} FLOPs, {nbytes / 1e6:.1f} MB); plain "
            f"{item['plain_ms']} ms; scaled_dot_product_attention "
            f"{item['library_ms']} ms; against its plain version max abs "
            f"err {item['max_abs_err']:.3e}")
    del cases, q, k, v
    # f32 (the CUDA-core kernel) with fewer rows: the encoder's heads at
    # 1024 frames, and one query row against 4096 frames of a cache
    q32, k32, v32 = (torch.randn((2, n, 1024, 64), generator=gen,
                                 device=dev) for n in (16, 16, 16))
    f32_errs = {"encoder 1024": close(
        "flash at the encoder's heads (f32, 1024 frames)",
        flash_attention(q32, k32, v32, causal=False),
        ref.flash_attention_ref(q32, k32, v32, causal=False),
        *FLASH_TOL["float32"])}
    qc, kc, vc = _cache_views(8, 16, 16, 4096, 64, torch.float32, dev, 10)
    f32_errs["cross T=4096"] = close(
        "flash at one query row (f32, T=4096)",
        flash_attention(qc, kc, vc, causal=False),
        ref.flash_attention_ref(qc, kc, vc, causal=False),
        *FLASH_TOL["float32"])
    log(f"[encdec] flash in f32 against its plain version: {f32_errs}")
    del q32, k32, v32, qc, kc, vc
    # the log-sum-exp output (``lse=True``), with which 25(f)'s sharded
    # decode merges its ranks' slices of the cross K / V: one query row of
    # seamless's shape, T = 4096 and a 16,384-key slice, bf16 and f32; the
    # output bitwise the one without it, lse against the plain version's,
    # and two launches over the halves of T merged against one over T
    lse_rows = {}
    for dt_name, dtype in (("bfloat16", torch.bfloat16),
                           ("float32", torch.float32)):
        for t2 in (4096, 16384):
            q, k, v = _cache_views(8, 16, 16, t2, 64, dtype, dev, t2 + 1)
            name = f"T={t2} {dt_name}"
            with torch.no_grad():
                whole = flash_attention(q, k, v, causal=False)
                got, lse = flash_attention(q, k, v, causal=False, lse=True)
                if card and not torch.equal(got, whole):
                    raise AssertionError(f"flash with lse at {name}: the "
                                         "output is not bitwise the one "
                                         "without it")
                _, plain = ref.flash_attention_ref(q, k, v, causal=False,
                                                   lse=True)
                item = dict(lse_err=close(
                    f"flash lse at {name}", lse, plain, 0.0,
                    1e-3 if dtype == torch.bfloat16 else 1e-5))
                half = t2 // 2
                parts = [flash_attention(q, k[:, :, i:i + half],
                                         v[:, :, i:i + half], causal=False,
                                         lse=True) for i in (0, half)]
                top = torch.logsumexp(torch.stack([p_[1] for p_ in parts]),
                                      0)
                merged = sum(torch.exp(p_[1] - top)[..., None]
                             * p_[0].float() for p_ in parts)
                item["merge_err"] = close(
                    f"flash halves of T merged by lse at {name}", merged,
                    whole, *FLASH_TOL[dt_name])
            del got, lse, plain, parts, top, merged, whole
            if dtype == torch.bfloat16:
                flops = flash_flops(8, 16, 1, t2, 64, False)
                nbytes = 2 * (2 * 8 * 16 * 64 + 2 * 8 * t2 * 16 * 64)
                item["bound"] = bound_ms(nbytes + 4 * 8 * 16, flops,
                                         BF16_FLOPS)
                item["ms"] = timed(lambda: flash_attention(
                    q, k, v, causal=False), reps=sizes["flash_reps"])
                item["lse_ms"] = timed(lambda: flash_attention(
                    q, k, v, causal=False, lse=True),
                    reps=sizes["flash_reps"])
                item["plain_ms"] = timed(lambda: ref.flash_attention_ref(
                    q, k, v, causal=False, lse=True),
                    reps=sizes["plain_reps"], warmup=1)
                item["library_ms"] = timed(
                    lambda: F.scaled_dot_product_attention(q, k, v),
                    reps=sizes["flash_reps"])
            lse_rows[name] = item
            log(f"[encdec] flash with lse at one query row, {name} (B=8, "
                f"H=16, hd 64): lse against the plain version max abs err "
                f"{item['lse_err']:.3e} (atol "
                f"{1e-3 if dtype == torch.bfloat16 else 1e-5}); halves of T "
                f"merged against one launch {item['merge_err']:.3e}; output "
                "bitwise the one without lse"
                + (f"; {item['lse_ms']} ms with lse, {item['ms']} ms without"
                   f", bound {item['bound'][0]:.4f} ms by "
                   f"{item['bound'][1]}, plain {item['plain_ms']} ms, SDPA "
                   f"{item['library_ms']} ms" if "ms" in item else ""))
            del q, k, v
    e = flash["encoder"]
    rows["flash_attention"].setdefault("extra", {})["encdec"] = dict(
        {nm: {key: (it["bound"][0] if key == "bound" else it[key])
              for key in ("shape", "ms", "plain_ms", "library_ms", "bound",
                          "max_abs_err")}
         for nm, it in flash.items()},
        f32_max_abs_err=f32_errs,
        launches_a_prefill=paths["encdec_prefill"]["flash_attention"],
        launches_a_decode_step=paths["encdec_decode"]["flash_attention"]
        // sizes["gen_steps"],
        lse={nm: {key: (it["bound"][0] if key == "bound" else it[key])
                  for key in it} for nm, it in lse_rows.items()})
    out["flash"] = {nm: {k_: v_ for k_, v_ in it.items() if k_ != "bound"}
                    | {"bound_ms": it["bound"][0],
                       "bound_by": it["bound"][1]}
                    for nm, it in flash.items()}
    out["flash_f32_errs"] = f32_errs
    out["flash_lse"] = rows["flash_attention"]["extra"]["encdec"]["lse"]
    log(f"[encdec] the encoder's flash {e['ms']} ms against its bound "
        f"{e['bound'][0]:.4f} ms and SDPA {e['library_ms']} ms")
    took("d")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[encdec] phase 24 took {out['seconds']:.1f} s")
    results["encdec"] = out


#: phase 25: parameter sharding (FSDP over "data", tensor parallelism over
#: "model") on a 2x2 grid of four gloo ranks sharing the card: llama3.2-1b
#: at full width, depth cut from 16 to 2 (a run's time limit: every gather
#: crosses the host under gloo), a global batch of 4 x 1024 in bf16 with
#: remat; f32 gradients at full width with 2 layers on 2 x 256 tokens; the
#: launcher at the smoke config under torch.distributed.run; then in the
#: same ranks the moe, hybrid, ssm and encdec families at full width (the
#: depth of each cut as ``families`` says: olmoe 16 to 2 layers, zamba2 81
#: to one group of 6 Mamba2 blocks and the shared block, xlstm whole,
#: seamless 24 + 24 to 2 + 2), a global batch of 4 x 512 (seamless: 4 x 512
#: frames and 4 x 64 tokens), bf16 with remat, a warm-up and a timed step;
#: then f32 gradients, as llama's, of olmoe at 2 layers (through the expert
#: exchange) and of zamba2 at 2 layers with the shared block after each
#: (two groups of one Mamba2 block: the leaves read in part, the shared
#: block's gradients added over its uses).  (a) and (d) take one timed step
#: each (two until 25(f) came: the script's time limit).  25(f): the sharded
#: serving steps of llama3.2-1b at (a)'s 2 layers and of (d)'s four families
#: at (d)'s depths, full width, bf16: a prefill of 2 x 4096 tokens (one
#: sequence a "data" rank; seamless 2 x 4096 frames; xlstm 2 x 2048, its
#: sLSTM loop) and two decode steps at batch 4 against a state drawn from a
#: seed at decode_32k's length (xlstm at long_500k's position 524,287: its
#: state does not grow), at a position in the last "model" block and one in
#: the first; xlstm-125m's are held in f32 at 2e-3 (``check_f32``: its bf16
#: prefill logits differ from its own f32 ones by more than the bf16 bar)
SHARD = dict(grid=(2, 2), layers=2, batch=4, seq=1024, timed=1,
             check_layers=2, check_batch=2, check_seq=256,
             families=(("olmoe-1b-7b", dict(n_layers=2)),
                       ("zamba2-7b", dict(n_layers=6)),
                       ("xlstm-125m", {}),
                       ("seamless-m4t-large-v2",
                        dict(n_layers=2, n_enc_layers=2))),
             family_batch=4, family_seq=512, family_timed=1,
             serve=(("llama3.2-1b", dict(n_layers=2)),
                    ("olmoe-1b-7b", dict(n_layers=2)),
                    ("zamba2-7b", dict(n_layers=6)),
                    ("xlstm-125m", {}),
                    ("seamless-m4t-large-v2",
                     dict(n_layers=2, n_enc_layers=2))),
             serve_batch=2, serve_seq=4096, serve_seqs={"xlstm-125m": 2048},
             decode_batch=4, decode_len=32768,
             decode_lens={"xlstm-125m": 524288}, decode_first=7,
             check_f32=("xlstm-125m",),
             grad_checks=(("olmoe-1b-7b", dict(n_layers=2)),
                          ("zamba2-7b", dict(n_layers=2, attn_every=1))))


def _shard_rank(rank, sizes, device, untimed=None):
    """One rank of phase 25(a, b, d, e, f): the sharded train step of
    llama3.2-1b on the 2x2 grid.  (a) at full width with ``layers`` layers,
    a warm-up step and ``timed`` timed steps in bf16 (host clock ending in
    a synchronize), this rank's state bytes, peak memory, collectives and
    kernel launches; (d) the other families (:func:`_shard_families`);
    (f) every family's sharded serving steps (:func:`_serve_families`);
    then, the timed work done (rank 0 creates the file ``untimed``, which
    the parent's subprocess checks wait for), (b) llama's f32 gradients
    with ``check_layers`` layers and (e) those of ``grad_checks``
    (:func:`_grad_check`)."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import (
        collective_counts, make_local_mesh, reset_collective_counts,
    )
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import api
    from repro_torch.training import AdamW, sharding

    dev = torch.device(device)
    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    mesh = make_local_mesh(*sizes["grid"], device=dev)
    base = sizes.get("cfg") or ARCHS[LM_ARCH]
    out = {}

    # -- (a) bf16 steps ------------------------------------------------------
    cfg = dataclasses.replace(base, n_layers=sizes["layers"])
    model = api.init_params(cfg, 0, device=dev)
    shards = sharding.shard_model(model, mesh)
    opt = AdamW()
    state = opt.init(model)
    step = sharding.make_train_step(cfg, opt, shards)
    shape = ShapeSpec("shard", sizes["seq"], sizes["batch"], "train")
    batches = [synthetic_batch(cfg, shape, i, dev)
               for i in range(sizes["timed"] + 1)]
    losses, step_s = [], []
    sync()
    t0 = time.perf_counter()
    model, state, loss = step(model, state, batches[0])
    losses.append(float(loss))
    warm_s = time.perf_counter() - t0
    if card:
        torch.cuda.reset_peak_memory_stats()
    reset_collective_counts()
    _build.reset_launch_counts()
    for b in batches[1:]:
        sync()
        t0 = time.perf_counter()
        model, state, loss = step(model, state, b)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    out["a"] = dict(losses=losses, warm_s=warm_s, step_s=step_s,
                    counts=collective_counts(),
                    launches=_build.launch_counts(),
                    peak=torch.cuda.max_memory_allocated() if card else 0,
                    state_bytes=sharding.state_bytes(model, state),
                    plan=(shards.tp_attn, shards.tp_mlp, shards.tp_vocab))
    del model, state, step, batches, loss

    # -- (d) the moe, hybrid, ssm and encdec families ------------------------
    out["d"] = _shard_families(mesh, sizes, dev)
    # -- (f) the sharded serving steps, every family -------------------------
    t0 = time.perf_counter()
    out["f"] = _serve_families(mesh, sizes, dev)
    out["f_s"] = time.perf_counter() - t0
    mesh.barrier()
    if rank == 0 and untimed:
        Path(untimed).touch()

    # -- (b, e) f32 gradients against 1x1 -----------------------------------
    out["b"] = _grad_check(mesh, dataclasses.replace(
        base, n_layers=sizes["check_layers"]), sizes, dev)
    own = sizes.get("grad_cfgs", {})
    out["e"] = {arch: _grad_check(mesh, own.get(arch) or
                                  dataclasses.replace(ARCHS[arch], **cut),
                                  sizes, dev)
                for arch, cut in sizes["grad_checks"]}
    return out


def _grad_check(mesh, cfg, sizes, dev):
    """One f32 sharded step's gradients of ``cfg`` on ``check_batch`` x
    ``check_seq`` tokens (parameters from seed 1), each rank's blocks held
    against the same blocks of the 1x1 step's gradients on the same
    parameters and batch, which every rank computes on its own (a moe's
    1x1 experts group as the grid's do: ``moe_ffn_ep_plain``, at the
    default capacity).  This rank's record: the two losses, the largest
    absolute error and the worst error as a share of the bar rtol 1e-3,
    atol 1e-5."""
    import functools

    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import api, moe
    from repro_torch.training import AdamW, sharding
    from repro_torch.training.optimizer import value_and_grad

    shape = ShapeSpec("shard check", sizes["check_seq"], sizes["check_batch"],
                      "train")
    batch = synthetic_batch(cfg, shape, 0, dev)
    model = api.init_params(cfg, 1, device=dev)
    shards = sharding.shard_model(model, mesh)
    got = {}

    class Capture(AdamW):
        def update(self, grads, state, params):
            got.update(grads)
            return params, state

    opt = Capture()
    # only the loss is kept: the state returned would stay resident
    loss = sharding.make_train_step(
        cfg, opt, shards, compute_dtype=torch.float32)(
        model, opt.init(model), batch)[2]
    del model
    whole = api.init_params(cfg, 1, device=dev)
    plain = moe.moe_ffn_ep
    if cfg.family == "moe":
        rows, cols = sizes["grid"]
        moe.moe_ffn_ep = functools.partial(moe.moe_ffn_ep_plain, dp=rows,
                                           model=cols)
    try:
        loss1, want = value_and_grad(api.make_loss_fn(
            cfg, compute_dtype=torch.float32), whole, batch)
    finally:
        moe.moe_ffn_ep = plain
    del whole
    err, worst = 0.0, 0.0
    for name, g in got.items():
        w = want[name][sharding.block_index(mesh, shards.dims(name))]
        err = max(err, float((g - w).abs().max()))
        worst = max(worst, float(((g - w).abs()
                                  / (1e-5 + 1e-3 * w.abs())).max()))
    rec = dict(loss=float(loss), loss_1x1=float(loss1), grad_err=err,
               grad_worst=worst, leaves=len(got),
               names=sorted(got) == sorted(want), layers=cfg.n_layers)
    del got, want
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def family_config(arch, sizes):
    """The phase-25 (d) config of ``arch``: full width, the depth cut by
    ``sizes["families"]`` (or a rehearsal's own config from
    ``sizes["family_cfgs"]``)."""
    from repro_torch.configs import ARCHS

    cuts = dict(sizes["families"])
    own = sizes.get("family_cfgs", {})
    return own.get(arch) or dataclasses.replace(ARCHS[arch], **cuts[arch])


def _shard_families(mesh, sizes, dev):
    """Phase 25(d) on one rank: each family's sharded train step, drawn by
    the launcher's init (``init_sharded``), a warm-up and ``family_timed``
    timed steps in bf16 with remat (host clock ending in a synchronize):
    the losses, this rank's state bytes, peak memory (what the family
    added to what was resident before its init: ``memory_guard``'s way,
    its arguments being its own), collectives and kernel launches a
    step."""
    import gc

    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import (
        collective_counts, reset_collective_counts,
    )
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.training import AdamW, sharding

    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    shape = ShapeSpec("shard", sizes["family_seq"], sizes["family_batch"],
                      "train")
    out = {}
    for arch, _ in sizes["families"]:
        cfg = family_config(arch, sizes)
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        sync()
        resident = torch.cuda.memory_allocated() if card else 0
        t0 = time.perf_counter()
        model, shards = sharding.init_sharded(cfg, mesh, 0, dev)
        opt = AdamW()
        state = opt.init(model)
        sync()
        init_s = time.perf_counter() - t0
        step = sharding.make_train_step(cfg, opt, shards)
        batches = [synthetic_batch(cfg, shape, i, dev)
                   for i in range(sizes["family_timed"] + 1)]
        t0 = time.perf_counter()
        model, state, loss = step(model, state, batches[0])
        losses = [float(loss)]
        warm_s = time.perf_counter() - t0
        if card:
            torch.cuda.reset_peak_memory_stats()
        reset_collective_counts()
        _build.reset_launch_counts()
        step_s = []
        for b in batches[1:]:
            sync()
            t0 = time.perf_counter()
            model, state, loss = step(model, state, b)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
        out[arch] = dict(
            losses=losses, init_s=init_s, warm_s=warm_s, step_s=step_s,
            counts=collective_counts(), launches=_build.launch_counts(),
            peak=(torch.cuda.max_memory_allocated() - resident
                  if card else 0),
            resident=resident,
            state_bytes=sharding.state_bytes(model, state),
            plan=(shards.tp_attn, shards.tp_mlp, shards.tp_vocab,
                  shards.tp_ssm, shards.ep))
        del model, state, step, batches, loss
    return out


def serve_config(arch, sizes):
    """The 25(f) config of ``arch``: full width, the depth cut by
    ``sizes["serve"]`` (or a rehearsal's own from ``sizes["serve_cfgs"]``)."""
    from repro_torch.configs import ARCHS

    own = sizes.get("serve_cfgs", {})
    return own.get(arch) or dataclasses.replace(
        ARCHS[arch], **dict(sizes["serve"])[arch])


def serve_shapes(arch, cfg, sizes):
    """25(f)'s prefill and decode cells of ``arch``, and its two decode
    positions: one in the last "model" block, one in the first."""
    from repro_torch.configs import ShapeSpec

    seq = sizes["serve_seqs"].get(arch, sizes["serve_seq"])
    length = sizes["decode_lens"].get(arch, sizes["decode_len"])
    return (ShapeSpec("serve", seq, sizes["serve_batch"], "prefill"),
            ShapeSpec("serve", length, sizes["decode_batch"], "decode"),
            (length - 1, sizes["decode_first"]))


def _tree_like(tree, value):
    """``tree``'s structure (dicts, lists, None) with ``value`` at every
    leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_like(v, value) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_like(v, value) for v in tree]
    return value


def _kv_rows(cache_blocks, specs, shapes, mesh, positions):
    """This rank's written rows of every KV leaf (``k``, ``v``) at each
    position (clamped to the leaf's rows, as the step writes them) that
    falls in its block of rows: ``{(name, pos): (L, B_loc, Hkv, hd)}``."""
    out = {}
    for name in ("k", "v"):
        if name not in cache_blocks:
            continue
        t = shapes[name][2]
        rows = (mesh.block(t, specs[name][2]) if specs[name][2]
                else slice(0, t))
        for pos in positions:
            row = min(max(pos, 0), t - 1)
            if rows.start <= row < rows.stop:
                out[(name, pos)] = cache_blocks[name][:, :, row - rows.start]
    return out


class _Routes:
    """``moe.router_topk`` that records each call's expert choices and can
    replay them: an unsharded step then routes every token as the sharded
    step did.  In bf16 the two steps' router logits differ by rounding, so
    a token whose k-th and (k+1)-th logits nearly tie may pick another
    expert on each side, and its output then differs by far more than the
    bar; pinned, the rest of the computation is held at the bar.  A replay
    records ``gap``, the most a pinned choice falls below the unsharded
    logits' own k-th (0 where the choices agree), and ``flips``, the
    (token, k) pairs chosen otherwise."""

    def __init__(self, plain):
        self.plain, self.calls, self.replay = plain, [], None
        self.gap, self.flips = 0.0, 0

    def __call__(self, x, router, k):
        import torch

        if self.replay is None:
            gates, sel = self.plain(x, router, k)
            self.calls.append(sel)
            return gates, sel
        sel = next(self.replay)
        logits = x @ router
        vals = logits.gather(-1, sel)
        own = torch.sort(logits, dim=-1, descending=True, stable=True)
        kth = own.values[..., k - 1:k].float()
        self.gap = max(self.gap, float(
            (kth - vals.float()).clamp_min(0).max()))
        self.flips += int((~(sel[..., :, None] == own.indices[
            ..., None, :k]).any(-1)).sum())
        return torch.softmax(vals.float(), dim=-1).to(x.dtype), sel


def _serve_families(mesh, sizes, dev):
    """Phase 25(f) on one rank: each family's sharded serving steps
    (``serving/sharding.py``) on its blocks drawn by ``init_sharded``, in
    bf16: a warm-up and a timed prefill of the whole batch (each rank its
    block), two timed decode steps against a state drawn from a seed
    (``init_sharded_cache``), at a position in the last "model" block and
    one in the first; host clock ending in a synchronize; collectives and
    kernel launches of the timed calls, this rank's state bytes, peak
    memory above what was resident before the family's init.  Then,
    untimed, the unsharded steps (``api.make_prefill_step`` /
    ``make_decode_step``) on this rank's batch block alone (a moe prefill
    on the whole batch, its experts grouped as the grid's,
    ``moe_ffn_ep_plain``): the whole parameters from the same seed, the
    whole rows of the block of the same drawn state; the largest errors of
    the logits (an encdec prefill: the memory) and of the written KV
    rows."""
    import functools
    import gc

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import (
        collective_counts, reset_collective_counts,
    )
    from repro_torch.models import api, moe
    from repro_torch.serving import sharding as serving
    from repro_torch.training import sharding

    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    out = {}
    for arch, _ in sizes["serve"]:
        cfg = serve_config(arch, sizes)
        pshape, dshape, positions = serve_shapes(arch, cfg, sizes)
        batch = api.make_batch(cfg, pshape, seed=1, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        token = torch.randint(0, cfg.vocab, (dshape.global_batch,),
                              generator=gen, device=dev, dtype=torch.int32)
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        sync()
        resident = torch.cuda.memory_allocated() if card else 0
        t0 = time.perf_counter()
        model, shards = sharding.init_sharded(cfg, mesh, 0, dev)
        sync()
        init_s = time.perf_counter() - t0
        rec = dict(init_s=init_s, resident=resident,
                   plan=(shards.tp_attn, shards.tp_mlp, shards.tp_vocab,
                         shards.tp_ssm, shards.ep))

        # -- the prefill: a warm-up and one timed call --------------------
        prefill = serving.make_prefill_step(cfg, shards)
        t0 = time.perf_counter()
        prefill(model, batch)
        sync()
        warm_s = time.perf_counter() - t0
        if card:
            torch.cuda.reset_peak_memory_stats()
        reset_collective_counts()
        _build.reset_launch_counts()
        routes = {"prefill": _Routes(moe.router_topk),
                  "decode": _Routes(moe.router_topk)}
        if cfg.family == "moe":
            moe.router_topk = routes["prefill"]
        sync()
        t0 = time.perf_counter()
        try:
            logits = prefill(model, batch)
            sync()
        finally:
            moe.router_topk = routes["prefill"].plain
        rec["prefill"] = dict(
            warm_s=warm_s, ms=1e3 * (time.perf_counter() - t0),
            counts=collective_counts(), launches=_build.launch_counts(),
            peak=(torch.cuda.max_memory_allocated() - resident
                  if card else 0),
            shape=tuple(logits.shape),
            finite=bool(torch.isfinite(logits.float()).all()))
        got_prefill = logits
        del logits

        # -- the decode: two timed steps from a drawn state ---------------
        t0 = time.perf_counter()
        cache = serving.init_sharded_cache(cfg, dshape, mesh, dev, seed=2)
        sync()
        cache_s = time.perf_counter() - t0
        decode = serving.make_decode_step(cfg, shards)
        if card:
            torch.cuda.reset_peak_memory_stats()
        reset_collective_counts()
        _build.reset_launch_counts()
        got_decode, step_ms = [], []
        if cfg.family == "moe":
            moe.router_topk = routes["decode"]
        try:
            for pos in positions:
                sync()
                t0 = time.perf_counter()
                lg, _ = decode(model, cache, token, pos)
                sync()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                got_decode.append(lg)
        finally:
            moe.router_topk = routes["decode"].plain
        rec["decode"] = dict(
            cache_s=cache_s, step_ms=step_ms, positions=positions,
            counts=collective_counts(), launches=_build.launch_counts(),
            peak=(torch.cuda.max_memory_allocated() - resident
                  if card else 0),
            state_bytes=serving.cache_bytes(cache),
            shape=tuple(got_decode[0].shape),
            finite=all(bool(torch.isfinite(x).all()) for x in got_decode))
        written = _kv_rows(cache.blocks, cache.specs, cache.shapes, mesh,
                           positions)
        # a family whose bf16 logits differ from its own f32 logits by more
        # than the bf16 bar is held in f32: the same sharded steps again,
        # untimed, from the same state
        check_dt = (torch.float32 if arch in sizes.get("check_f32", ())
                    else None)
        # f32: the reference's bar between two orders of one f32 function
        # (prefill against decode, tests/test_models_smoke.py:90-91)
        bar = (2e-3, 2e-3) if check_dt else (5e-2, 1e-1)
        bf16_prefill = got_prefill
        if check_dt is not None:
            got_prefill = serving.make_prefill_step(
                cfg, shards, check_dt, capacity_factor=1.25)(model, batch)
            del cache
            cache = serving.init_sharded_cache(cfg, dshape, mesh, dev,
                                               seed=2)
            step32 = serving.make_decode_step(cfg, shards, check_dt)
            got_decode = [step32(model, cache, token, pos)[0]
                          for pos in positions]
            written = _kv_rows(cache.blocks, cache.specs, cache.shapes, mesh,
                               positions)
        del model, cache, decode, prefill
        gc.collect()
        if card:
            torch.cuda.empty_cache()

        # -- the check: the unsharded steps on this rank's batch block -----
        whole = api.init_params(cfg, 0, device=dev)
        b_axes = api.batch_axes_for(pshape.global_batch, mesh,
                                    sharding.BATCH_AXES)
        rows = (mesh.block(pshape.global_batch, b_axes) if b_axes
                else slice(0, pshape.global_batch))
        plain = moe.moe_ffn_ep
        if cfg.family == "moe":
            # every rank's expert choices of the prefill, in the order the
            # plain body routes the blocks: (layer, batch block, "model")
            r_, c_ = sizes["grid"]
            own = torch.stack(routes["prefill"].calls)       # (L, 1, T, k)
            blocks = torch.zeros((own.shape[0], r_, c_) + own.shape[1:],
                                 dtype=own.dtype, device=own.device)
            blocks[:, mesh.index("data"), mesh.index("model")] = own
            blocks = mesh.all_reduce(blocks, ("data", "model"))
            routes["prefill"].replay = iter(
                blocks.reshape((-1,) + own.shape[1:]))
            moe.moe_ffn_ep = functools.partial(moe.moe_ffn_ep_plain, dp=r_,
                                               model=c_)
            moe.router_topk = routes["prefill"]
        try:
            if cfg.family == "moe":
                want = api.make_prefill_step(cfg, check_dt)(whole,
                                                            batch)[rows]
            else:
                want = api.make_prefill_step(cfg, check_dt)(
                    whole, {k: v[rows] for k, v in batch.items()})
        finally:
            moe.moe_ffn_ep = plain
            moe.router_topk = routes["prefill"].plain
        errs = dict(prefill=close(
            f"25(f) {arch}: the sharded prefill against the unsharded one"
            + (" (f32)" if check_dt else ""), got_prefill, want, *bar))
        if check_dt is not None:
            # what the bf16 bar would have met: the sharded bf16 prefill
            # against the unsharded bf16 one, and that against its f32
            want16 = api.make_prefill_step(cfg)(
                whole, {k: v[rows] for k, v in batch.items()})
            rec["bf16_gaps"] = dict(
                sharded_vs_unsharded=float(
                    (bf16_prefill.float() - want16.float()).abs().max()),
                unsharded_bf16_vs_f32=float(
                    (want16.float() - want.float()).abs().max()))
            del want16
        del want, got_prefill, bf16_prefill, batch
        d_axes = api.batch_axes_for(dshape.global_batch, mesh,
                                    sharding.BATCH_AXES)
        d_rows = (mesh.block(dshape.global_batch, d_axes) if d_axes
                  else slice(0, dshape.global_batch))
        state = serving.drawn_cache(cfg, dshape, 2, dev, rows=d_rows)
        step1 = api.make_decode_step(cfg, check_dt)
        if cfg.family == "moe":
            # one group of the global batch: this rank's tokens' choices
            routes["decode"].replay = iter(
                [sel[:, d_rows] for sel in routes["decode"].calls])
            moe.router_topk = routes["decode"]
        try:
            for pos, got in zip(positions, got_decode):
                want, _ = step1(whole, state, token[d_rows], pos)
                errs[f"decode {pos}"] = close(
                    f"25(f) {arch}: the sharded decode step at {pos} "
                    "against the unsharded one", got, want, *bar)
        finally:
            moe.router_topk = routes["decode"].plain
        if cfg.family == "moe":
            rec["routes"] = {k: dict(gap=r.gap, flips=r.flips,
                                     calls=len(r.calls))
                             for k, r in routes.items()}
            for kind, r in routes.items():
                if r.gap > 0.1:
                    raise AssertionError(
                        f"25(f) {arch}: the sharded {kind} chose an expert "
                        f"{r.gap:.3e} below the unsharded router logits' "
                        "own k-th (bar atol 1e-1)")
        for (name, pos), blk in written.items():
            t = state[name].shape[2]
            errs[f"row {name} {pos}"] = close(
                f"25(f) {arch}: the row {name}[{pos}] the sharded step "
                "wrote against the unsharded one's", blk,
                state[name][:, :, min(pos, t - 1)], *bar)
        rec["errs"] = errs
        rec["rows_held"] = sorted({pos for _, pos in written})
        del whole, state, written, got_decode
        out[arch] = rec
    return out


def check_serve_families(ranks_f, sizes, dev, paths):
    """Phase 25(f) in the parent: each family's numbers from its ranks;
    every output finite and of the rank's batch block; each rank's state
    bytes exactly the reference's per-device bytes (``dryrun.spec_bytes``
    under ``api.cache_pspecs``); the flash kernel launched by every
    attention layer of a prefill and by every cross-attention of an encdec
    decode step; the rows a step wrote held by some rank."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.models import api

    rows, cols = sizes["grid"]
    grid = {"data": rows, "model": cols}
    out = {}
    for arch, _ in sizes["serve"]:
        cfg = serve_config(arch, sizes)
        pshape, dshape, positions = serve_shapes(arch, cfg, sizes)
        recs = [r[arch] for r in ranks_f]
        r0 = recs[0]
        meta = api.init_decode_cache(cfg, dshape, device="meta")
        specs = api.cache_pspecs(cfg, dshape, grid, meta)

        def spec_total(tree, spec):
            if tree is None:
                return 0
            if isinstance(tree, dict):
                return sum(spec_total(v, spec[k]) for k, v in tree.items())
            if isinstance(tree, list):
                return sum(spec_total(v, sp) for v, sp in zip(tree, spec))
            return dryrun.spec_bytes(tree.shape, tree.dtype, spec, grid)

        per_rank = spec_total(meta, specs)
        whole = spec_total(meta, _tree_like(meta, None))
        attn_layers = {"dense": cfg.n_layers, "vlm": cfg.n_layers,
                       "moe": cfg.n_layers, "encdec": cfg.n_enc_layers,
                       "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
                       "ssm": 0}[cfg.family]
        cross = cfg.n_layers if cfg.family == "encdec" else 0
        pre, dec = r0["prefill"], r0["decode"]
        errs = {}
        for r in recs:
            for k, e in r["errs"].items():
                errs[k] = max(errs.get(k, 0.0), e)
        n_steps = len(positions)
        d_counts = {k: v / n_steps for k, v in dec["counts"].items()}
        paths[f"serve_prefill_{arch}"] = pre["launches"]
        paths[f"serve_decode_{arch}"] = dec["launches"]
        b_loc = pshape.global_batch // rows
        tokens = pshape.global_batch * pshape.seq_len
        log(f"[shard] (f) {arch} ({cfg.n_layers} layers"
            + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
            + f", full width, bf16) split over model (attention, MLP, "
            f"vocabulary, recurrent heads, experts): {r0['plan']}; init "
            f"{r0['init_s']:.2f} s; prefill {pshape.global_batch} x "
            f"{pshape.seq_len} (warm-up {pre['warm_s']:.2f} s): "
            f"{pre['ms']:.1f} ms on rank 0 (slowest rank "
            f"{max(r['prefill']['ms'] for r in recs):.1f} ms; "
            f"{tokens / pre['ms'] * 1e3:.0f} tokens/s), all_reduce "
            f"{pre['counts']['all_reduce']} calls, "
            f"{pre['counts']['bytes'] / 1e6:.1f} MB, all_to_all "
            f"{pre['counts'].get('all_to_all', 0)} calls, "
            f"{pre['counts'].get('all_to_all_bytes', 0) / 1e6:.1f} MB; "
            f"flash launches {pre['launches']['flash_attention']}; peak "
            f"a rank {[round(r['prefill']['peak'] / 2**30, 3) for r in recs]}"
            f" GiB above what was resident; decode batch "
            f"{dshape.global_batch} at length {dshape.seq_len}: state drawn "
            f"in {dec['cache_s']:.2f} s, steps at {positions} "
            f"{[round(x, 1) for x in dec['step_ms']]} ms (rank 0; slowest "
            f"rank {max(max(r['decode']['step_ms']) for r in recs):.1f}); "
            f"a step all_reduce {d_counts['all_reduce']:.0f} calls, "
            f"{d_counts['bytes'] / 1e6:.1f} MB; flash launches a step "
            f"{dec['launches']['flash_attention'] / n_steps:.0f}; state "
            f"bytes a rank {[r['decode']['state_bytes'] for r in recs]} "
            f"(the reference's per-device bytes {per_rank}; whole "
            f"{whole}); peak a rank "
            f"{[round(r['decode']['peak'] / 2**30, 3) for r in recs]} GiB; "
            f"against the unsharded step on each rank's block (bar rtol "
            f"5e-2, atol 1e-1): max abs err {errs}"
            + (f"; held in f32 (its bf16 logits: sharded against "
               f"unsharded, unsharded against its f32, max abs "
               f"{[r['bf16_gaps'] for r in recs]})"
               if "bf16_gaps" in r0 else "")
            + (f"; experts pinned to the sharded steps' choices: "
               f"{r0['routes']} (gap: how far a pinned choice falls below "
               "the unsharded router's own k-th logit)"
               if "routes" in r0 else ""))
        if any(r["decode"]["state_bytes"] != per_rank for r in recs):
            raise AssertionError(f"(f) {arch}: a rank holds other than the "
                                 f"reference's per-device state bytes "
                                 f"{per_rank}")
        want_p = ((b_loc, pshape.seq_len, cfg.d_model)
                  if cfg.family == "encdec" else (b_loc, cfg.vocab))
        for r in recs:
            if not (r["prefill"]["finite"] and r["decode"]["finite"]):
                raise AssertionError(f"(f) {arch}: a sharded output is not "
                                     "finite")
            if (r["prefill"]["shape"] != want_p or r["decode"]["shape"]
                    != (dshape.global_batch // rows, cfg.vocab)):
                raise AssertionError(f"(f) {arch}: a rank's output is not "
                                     "its batch block")
        flash = pre["launches"]["flash_attention"]
        if dev.type == "cuda" and (
                flash != attn_layers
                or dec["launches"]["flash_attention"] != cross * n_steps):
            raise AssertionError(f"(f) {arch}: flash launched {flash} times "
                                 f"a prefill, {dec['launches']} in "
                                 f"{n_steps} decode steps, not "
                                 f"{attn_layers} and {cross} a step")
        held = sorted({p for r in recs for p in r["rows_held"]})
        if "k" in meta and held != sorted(set(positions)):
            raise AssertionError(f"(f) {arch}: the rows written at "
                                 f"{positions} are held at {held}")
        out[arch] = dict(
            layers=cfg.n_layers, plan=r0["plan"], init_s=r0["init_s"],
            prefill_ms=[r["prefill"]["ms"] for r in recs],
            prefill_warm_s=pre["warm_s"], prefill_counts=pre["counts"],
            prefill_launches=pre["launches"],
            prefill_peak=[r["prefill"]["peak"] for r in recs],
            decode_ms=[r["decode"]["step_ms"] for r in recs],
            positions=list(positions), decode_counts_per_step=d_counts,
            decode_launches=dec["launches"],
            decode_peak=[r["decode"]["peak"] for r in recs],
            state_bytes=[r["decode"]["state_bytes"] for r in recs],
            per_rank_state_bytes=per_rank, whole_state_bytes=whole,
            errs=errs, routes=[r.get("routes") for r in recs],
            bf16_gaps=[r.get("bf16_gaps") for r in recs])
    return out


def check_shard_families(ranks_d, sizes, dev, paths):
    """Phase 25(d) in the parent: each family's numbers from its ranks,
    held against the 1x1 loss on the same parameters and batch (this
    process joins no group; bf16 bar) and the reference's per-device shard
    bytes (``dryrun.spec_bytes`` under the launcher's specs), exactly; every
    loss finite and equal on every rank; no hand-written kernel
    launched."""
    import math

    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import api
    from repro_torch.training import sharding

    rows, cols = sizes["grid"]
    grid = {"data": rows, "model": cols}
    shape = ShapeSpec("shard", sizes["family_seq"], sizes["family_batch"],
                      "train")
    timed = sizes["family_timed"]
    out = {}
    for arch, _ in sizes["families"]:
        cfg = family_config(arch, sizes)
        recs = [r[arch] for r in ranks_d]
        batch = synthetic_batch(cfg, shape, 0, dev)
        model = api.init_params(cfg, 0, device=dev)
        with torch.no_grad():
            loss1 = float(api.make_loss_fn(cfg)(model, batch))
        n_params = sum(p.numel() for p in model.parameters())
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        meta = api.init_params(cfg, device="meta")
        specs = api.param_pspecs(cfg, meta, sharding.RULES, grid)
        per_rank = 3 * sum(dryrun.spec_bytes(p.shape, torch.float32,
                                             specs[n], grid)
                           for n, p in meta.named_parameters())
        # decoder tokens, and an encoder's frames
        tokens = batch["tokens"].numel() + (
            math.prod(batch["frame_embeds"].shape[:2])
            if "frame_embeds" in batch else 0)
        r0 = recs[0]
        med = float(np.median(r0["step_s"]))
        counts = {k: v / timed for k, v in r0["counts"].items()}
        paths[f"shard_{arch}"] = r0["launches"]
        log(f"[shard] (d) {arch}: {n_params:,} parameters at full width "
            f"({cfg.n_layers} layers"
            + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
            + f"); split over model (attention, MLP, vocabulary, recurrent "
            f"heads, experts): {r0['plan']}; init {r0['init_s']:.2f} s, "
            f"warm-up step {r0['warm_s']:.2f} s; {timed} steps "
            f"{[round(1e3 * x, 1) for x in r0['step_s']]} ms (median "
            f"{1e3 * med:.1f} ms, {tokens / med:.0f} tokens/s; slowest "
            f"rank's median "
            f"{1e3 * max(np.median(r['step_s']) for r in recs):.1f} ms); "
            f"losses {[round(x, 4) for x in r0['losses']]}; all_reduce a "
            f"step {counts['all_reduce']:.0f} calls, "
            f"{counts['bytes'] / 1e6:.1f} MB; all_to_all a step "
            f"{counts.get('all_to_all', 0):.0f} calls, "
            f"{counts.get('all_to_all_bytes', 0) / 1e6:.2f} MB (rank 0); "
            f"peak memory a rank {[round(r['peak'] / 2**30, 2) for r in recs]}"
            f" GiB above what was resident before its init "
            f"({[round(r['resident'] / 2**30, 3) for r in recs]} GiB); "
            f"parameters + mu + nu a rank "
            f"{[r['state_bytes'] for r in recs]} B (the reference's "
            f"per-device shard: {per_rank})")
        if not all(math.isfinite(x) for r in recs for x in r["losses"]):
            raise AssertionError(f"(d) {arch}: a sharded step's loss is not "
                                 "finite")
        if any(r["losses"] != r0["losses"] for r in recs):
            raise AssertionError(f"(d) {arch}: the ranks disagree on the "
                                 "loss")
        if any(r["state_bytes"] != per_rank for r in recs):
            raise AssertionError(f"(d) {arch}: a rank holds other than the "
                                 f"reference's per-device shard bytes "
                                 f"{per_rank}")
        err = close(f"(d) {arch}: step 0's sharded loss against the 1x1 "
                    "loss", torch.tensor(r0["losses"][0]),
                    torch.tensor(loss1), 0.0, 1e-2)
        log(f"[shard] (d) {arch}: step 0's loss {r0['losses'][0]:.4f} on the "
            f"grid, {loss1:.4f} at 1x1 on the same parameters and batch "
            f"(|difference| {err:.2e}; bar atol 1e-2, in bf16)")
        if any(r0["launches"].values()):
            raise AssertionError(f"(d) {arch}: the sharded step launched a "
                                 f"hand-written kernel ({r0['launches']})")
        out[arch] = dict(n_params=n_params, layers=cfg.n_layers,
                         losses=r0["losses"], loss_1x1=loss1,
                         step_s=[r["step_s"] for r in recs],
                         init_s=r0["init_s"], warm_s=r0["warm_s"],
                         median_ms=1e3 * med, tokens_per_s=tokens / med,
                         counts_per_step=counts,
                         peak_bytes=[r["peak"] for r in recs],
                         state_bytes=[r["state_bytes"] for r in recs],
                         per_rank_bytes=per_rank, plan=r0["plan"])
    return out


def launcher_across_grids(card):
    """``python -m torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.train --arch llama3.2-1b --smoke --deterministic
    --data 2 --model 2 --dist-backend gloo``: stopped at 6 (checkpoints
    every 3) beside an uninterrupted run to 9; then the stopped one resumed
    to 9 on 2x2 (bitwise the uninterrupted run) while a copy of its step-6
    checkpoint resumes on 4x1 (within 1e-4)."""
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint import load_checkpoint_arrays

    root = tempfile.mkdtemp(prefix="shard-ck-")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"), OMP_NUM_THREADS="1")

    def run(ckpt, steps, data=2, model=2):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(data * model), "-m",
               "repro_torch.launch.train", "--arch", LM_ARCH, "--smoke",
               "--deterministic", "--ckpt-every", "3", "--steps", str(steps),
               "--ckpt-dir", ckpt, "--data", str(data), "--model",
               str(model), "--dist-backend", "gloo", "--batch", "4",
               "--seq", "32"]
        return subprocess.Popen(cmd + ([] if card else ["--device", "cpu"]),
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def finish(p, *again):
        """The output of run ``p`` (started as ``run(*again)``) once it
        exits 0; a run whose gloo group failed to connect, before any step
        (gloo's flake on one host), is started again, up to twice."""
        for _ in range(3):
            try:
                o, e = p.communicate(timeout=300)
            finally:
                p.kill()
            if p.returncode == 0 or "connectFullMesh failed" not in e:
                break
            log(f"[shard] a launcher's gloo group failed to connect; "
                f"started again: {again}")
            p = run(*again)
        if p.returncode != 0:
            raise AssertionError(f"the sharded train launcher exited "
                                 f"{p.returncode}: {e[-3000:]}")
        return o

    t0 = time.perf_counter()
    a, b, c = (os.path.join(root, k) for k in ("a", "b", "4x1"))
    first, whole = run(a, 6), run(b, 9)
    outs = [finish(first, a, 6), finish(whole, b, 9)]
    shutil.copytree(os.path.join(a, "step_6"), os.path.join(c, "step_6"))
    resumed, other = run(a, 9), run(c, 9, 4, 1)
    outs += [finish(resumed, a, 9), finish(other, c, 9, 4, 1)]
    secs = time.perf_counter() - t0
    for o in outs[2:]:
        if "resuming from checkpoint step 6" not in o:
            raise AssertionError(f"a rerun did not resume from step 6: "
                                 f"{o[-2000:]}")
    want, _ = load_checkpoint_arrays(b, 9)
    got, _ = load_checkpoint_arrays(a, 9)
    differ = [n for n in want if not np.array_equal(got[n], want[n])]
    if got.keys() != want.keys() or differ:
        raise AssertionError(f"the 2x2 resumed run's step-9 state differs "
                             f"from the uninterrupted run's in {differ}")
    got, _ = load_checkpoint_arrays(c, 9)
    diff = {n: float(np.max(np.abs(got[n].astype(np.float64) - want[n])))
            for n in want}
    for n in want:
        if not np.allclose(got[n], want[n], rtol=1e-4, atol=1e-4):
            raise AssertionError(f"the 4x1 resume's {n} is not within 1e-4 "
                                 f"of the 2x2 run's (max abs diff "
                                 f"{diff[n]:.3e})")
    top = max(diff, key=diff.get)
    params = max(v for n, v in diff.items() if n.startswith("0/"))
    log(f"[shard] python -m torch.distributed.run --nproc-per-node 4 -m "
        f"repro_torch.launch.train --arch {LM_ARCH} --smoke --deterministic "
        f"--data 2 --model 2 --dist-backend gloo: stopped at 6, rerun to 9 "
        f"(\"resuming from checkpoint step 6\"), bitwise the uninterrupted "
        f"2x2 run ({len(want)} leaves); its step-6 checkpoint resumed on 4x1:"
        f" within 1e-4 (max abs diff {diff[top]:.3e} in {top}, the "
        f"parameters {params:.3e}); four runs in two waves {secs:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return dict(seconds=secs, leaves=len(want), max_diff_4x1=diff[top],
                max_diff_leaf=top, max_diff_params=params)


def run_shard_slice(dev, paths, results, launcher, sizes=SHARD):
    """Phase 25: parameter sharding on a 2x2 grid of four gloo ranks
    sharing the card.  (a) llama3.2-1b at full width with its depth cut to
    ``layers``: ms a step, tokens/s, each rank's peak memory and state
    bytes against the 1x1 run's, ``all_reduce`` calls and bytes a step;
    every loss finite, step 0's the 1x1 loss on the same parameters and
    batch within the bf16 bar; (b) f32 gradients at full width with 2
    layers, gathered, against 1x1's (1e-3 / 1e-5); (c) the launcher's kill
    and resume on 2x2 and on 4x1; (d) the moe, hybrid, ssm and encdec
    families (:func:`check_shard_families`); (e) f32 gradients of
    ``grad_checks`` as (b)'s.  ``launcher`` is the future of (c)'s runs,
    which :func:`main` started beside the build; 19(e)'s command line
    starts here once the ranks' timed steps are done.  ``sizes`` may carry a
    ``cfg`` and ``family_cfgs`` to shrink it for a rehearsal on the
    CPU."""
    import dataclasses
    import math
    import shutil
    import tempfile
    import threading

    import torch

    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import api
    from repro_torch.training import sharding

    t_phase = time.perf_counter()
    card = dev.type == "cuda"
    base = sizes.get("cfg") or ARCHS[LM_ARCH]
    cfg = dataclasses.replace(base, n_layers=sizes["layers"])
    rows, cols = sizes["grid"]
    if card:
        torch.cuda.empty_cache()
    log(f"[shard] {cfg.name} at full width, depth cut from {base.n_layers} "
        f"to {cfg.n_layers}, on a {rows}x{cols} grid of four gloo ranks "
        "sharing the card (FSDP over data, tensor parallelism over model; "
        "every collective an all_reduce through the host: not a multi-card "
        f"result); global batch {sizes['batch']} x {sizes['seq']}, bf16, "
        "remat")
    device = f"cuda:{dev.index or 0}" if card else "cpu"
    # 19(e)'s command line goes beside the untimed work (a run's time
    # limit): it starts once the ranks' timed steps are done, beside (b),
    # (e) and the checks here
    root = tempfile.mkdtemp(prefix="chip-smoke-shard-")
    untimed, stop = os.path.join(root, "untimed"), threading.Event()
    nmf_cli = beside(once, untimed, stop, nmf_command_line, device)
    t0 = time.perf_counter()
    try:
        recs = spawn_mesh(_shard_rank, rows, cols, backend="gloo",
                          device=device, args=(sizes, device, untimed),
                          timeout=600.0)
    finally:
        stop.set()
    spawn_s = time.perf_counter() - t0

    # the 1x1 loss on the same parameters and batch (this process joins no
    # group), and the reference's per-device shard bytes of the grid
    model = api.init_params(cfg, 0, device=dev)
    shape = ShapeSpec("shard", sizes["seq"], sizes["batch"], "train")
    with torch.no_grad():
        loss1 = float(api.make_loss_fn(cfg)(
            model, synthetic_batch(cfg, shape, 0, dev)))
    specs = api.param_pspecs(cfg, model, sharding.RULES,
                             {"data": rows, "model": cols})
    whole_bytes, per_rank = 0, 0
    for name, p in model.named_parameters():
        parts = 1
        for ax in specs[name]:
            parts *= {"data": rows, "model": cols}.get(ax, 1) if ax else 1
        whole_bytes += 3 * p.numel() * 4
        per_rank += 3 * p.numel() * 4 // parts
    n_params = sum(p.numel() for p in model.parameters())
    del model
    if card:
        torch.cuda.empty_cache()

    a = [r["a"] for r in recs]
    losses = a[0]["losses"]
    med = float(np.median(a[0]["step_s"]))
    tokens = sizes["batch"] * sizes["seq"]
    calls = a[0]["counts"]["all_reduce"] / sizes["timed"]
    nbytes = a[0]["counts"]["bytes"] / sizes["timed"]
    flops = train_flops(cfg, sizes["batch"], sizes["seq"])
    paths["shard_train"] = a[0]["launches"]
    log(f"[shard] (a) {n_params:,} parameters; the blocks split over model "
        f"(attention, MLP, vocabulary): {a[0]['plan']}; warm-up step "
        f"{a[0]['warm_s']:.2f} s; {sizes['timed']} steps "
        f"{[round(1e3 * x, 1) for x in a[0]['step_s']]} ms (median "
        f"{1e3 * med:.1f} ms, {tokens / med:.0f} tokens/s; slowest rank's "
        f"median {1e3 * max(np.median(r['step_s']) for r in a):.1f} ms); "
        f"model FLOPs a step {flops:.4e} ({100 * flops / med / BF16_FLOPS:.2f}"
        f"% of the bf16 peak); "
        f"losses {[round(x, 4) for x in losses]}; all_reduce a step "
        f"{calls:.0f} calls, {nbytes / 1e6:.1f} MB (rank 0); peak memory a "
        f"rank {[round(r['peak'] / 2**30, 2) for r in a]} GiB; parameters "
        f"+ mu + nu a rank {[r['state_bytes'] for r in a]} bytes against "
        f"{whole_bytes} at 1x1 ({per_rank / whole_bytes:.4f} of it, the "
        f"reference's per-device shard); launches of the hand-written "
        f"kernels {a[0]['launches']}; spawn to result {spawn_s:.1f} s "
        "((a), (d), (b) and (e); 19(e)'s command line beside (b) and (e))")
    if not all(math.isfinite(x) for r in a for x in r["losses"]):
        raise AssertionError("a sharded step's loss is not finite")
    if any(r["losses"] != losses for r in a):
        raise AssertionError("the ranks disagree on the loss")
    if any(r["state_bytes"] != per_rank for r in a):
        raise AssertionError(f"a rank holds other than the reference's "
                             f"per-device shard bytes {per_rank}")
    close("step 0's sharded loss against the 1x1 loss",
          torch.tensor(losses[0]), torch.tensor(loss1), 5e-2, 1e-1)
    log(f"[shard] step 0's loss {losses[0]:.4f} on the grid, {loss1:.4f} at "
        "1x1 on the same parameters and batch (bar rtol 5e-2, atol 1e-1)")
    if any(a[0]["launches"].values()):
        raise AssertionError("the sharded step launched a hand-written "
                             f"kernel ({a[0]['launches']})")
    checks = {LM_ARCH: [r["b"] for r in recs]}
    checks.update({arch: [r["e"][arch] for r in recs]
                   for arch in recs[0]["e"]})
    held = {}
    for arch, per_rank in checks.items():
        e = dict(per_rank[0],
                 grad_err=max(r["grad_err"] for r in per_rank),
                 grad_worst=max(r["grad_worst"] for r in per_rank),
                 names=all(r["names"] for r in per_rank))
        part = "(b)" if arch == LM_ARCH else "(e)"
        log(f"[shard] {part} {arch} f32, full width, {e['layers']} layers, "
            f"{sizes['check_batch']} x {sizes['check_seq']}: loss "
            f"{e['loss']:.6f} on the grid, {e['loss_1x1']:.6f} at 1x1"
            + (" (its experts grouped as the grid's)"
               if arch == MOE_ARCH else "")
            + f"; every rank's {e['leaves']} gradient blocks within rtol "
            f"1e-3, atol 1e-5 of the same blocks of 1x1's (max abs err "
            f"{e['grad_err']:.3e}, {e['grad_worst']:.3f} of the bar at "
            "worst)")
        for r in per_rank:
            close(f"{part} {arch}: the sharded f32 loss against 1x1's",
                  torch.tensor(r["loss"]), torch.tensor(r["loss_1x1"]),
                  1e-4, 1e-5)
        if not e["names"] or e["grad_worst"] > 1.0:
            raise AssertionError(f"{part} {arch}: a sharded f32 gradient is "
                                 "missing or not within rtol 1e-3, atol 1e-5 "
                                 "of 1x1's")
        held[arch] = e
    b = held.pop(LM_ARCH)
    out = dict(n_params=n_params, layers=cfg.n_layers, losses=losses,
               loss_1x1=loss1, step_s=[r["step_s"] for r in a],
               warm_s=a[0]["warm_s"], median_ms=1e3 * med,
               tokens_per_s=tokens / med, model_flops=flops,
               mfu=flops / med / BF16_FLOPS, all_reduce_calls=calls,
               all_reduce_bytes=nbytes, peak_bytes=[r["peak"] for r in a],
               state_bytes=[r["state_bytes"] for r in a],
               whole_state_bytes=whole_bytes, plan=a[0]["plan"],
               check=b, grad_checks=held, spawn_s=spawn_s)
    out["families"] = check_shard_families([r["d"] for r in recs], sizes,
                                           dev, paths)
    out["serving"] = check_serve_families([r["f"] for r in recs], sizes,
                                          dev, paths)
    out["serving_s"] = [r["f_s"] for r in recs]
    log(f"[shard] (f) the sharded serving steps took "
        f"{[round(x, 1) for x in out['serving_s']]} s a rank (inits, "
        "prefills, decode steps and each rank's unsharded checks)")
    out["launcher"] = launcher.result()
    results["phases"].setdefault("mesh", {})["cli"] = nmf_cli.result()
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[shard] phase 25 took {out['seconds']:.1f} s")
    results["shard"] = out


#: a predicted peak against the measured one (phase 26)
PEAK_RTOL = 0.10


def dryrun_serving_cells(serve, sizes, peak_check, failed):
    """Phase 26(e): 25(f)'s llama3.2-1b prefill and seamless-m4t-large-v2
    decode cells by ``lower_cell`` on a fake 2x2 grid on ``meta``, held
    against 25(f)'s records ``serve``: collective calls and bytes a call,
    flash launches and a rank's state bytes exactly (a disagreement is
    appended to ``failed``), the predicted peak by ``peak_check``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_nmf_mesh

    rows_, cols_ = sizes["grid"]
    out = {}
    for arch, kind in (("llama3.2-1b", "prefill"),
                       ("seamless-m4t-large-v2", "decode")):
        s_cfg = serve_config(arch, sizes)
        pshape, dshape, positions = serve_shapes(arch, s_cfg, sizes)
        with dryrun.fake_world(rows_ * cols_):
            rec = dryrun.lower_cell(s_cfg, pshape if kind == "prefill"
                                    else dshape,
                                    make_nmf_mesh(rows_, cols_,
                                                  device="meta"))
        fam = serve[arch]
        if kind == "prefill":
            card = fam["prefill_counts"]
            flash_card = fam["prefill_launches"]["flash_attention"]
            measured = max(fam["prefill_peak"])
        else:
            card = fam["decode_counts_per_step"]
            flash_card = (fam["decode_launches"]["flash_attention"]
                          / len(positions))
            measured = max(fam["decode_peak"])
        want = {"all_reduce": (card["all_reduce"], card["bytes"]),
                "all_to_all": (card.get("all_to_all", 0),
                               card.get("all_to_all_bytes", 0))}
        got = {k: (rec["collectives"].get(k, {}).get("calls", 0),
                   rec["collectives"].get(k, {}).get("bytes", 0))
               for k in want}
        flash_meta = rec["launches"].get("flash_attention", 0)
        log(f"[dryrun] (e) {arch} {kind} ({s_cfg.n_layers} layers) on a "
            f"fake {rows_}x{cols_} grid: (calls, bytes) a call {got} "
            f"(phase 25(f): {want}); flash launches {flash_meta} (25(f): "
            f"{flash_card}); state bytes a rank {rec.get('state_bytes')} "
            f"(25(f): {fam['state_bytes'][0] if kind == 'decode' else None})"
            f"; {rec['flops']:.4e} FLOPs a rank")
        if got != want:
            failed.append(f"(e) {arch} {kind}: collectives {got} != phase "
                          f"25(f)'s {want}")
        if flash_meta != flash_card:
            failed.append(f"(e) {arch} {kind}: {flash_meta} flash launches "
                          f"predicted, 25(f) launched {flash_card}")
        if kind == "decode" and rec["state_bytes"] != fam["state_bytes"][0]:
            failed.append(f"(e) {arch}: state bytes {rec['state_bytes']} != "
                          f"25(f)'s {fam['state_bytes'][0]}")
        out[f"{arch} {kind}"] = dict(
            collectives=got, flash=flash_meta, flops=rec["flops"],
            state_bytes=rec.get("state_bytes"),
            peak=peak_check(f"(e) {arch} sharded {kind}, rank 0",
                            rec["bytes_per_device"], measured))
    return out


def run_dryrun_slice(dev, op, u0, smi, paths, results, rows, sizes=SHARD):
    """Phase 26: the dry-run on ``meta`` in this process, held against what
    phases 3/7, 9/11 and 25 measured on the card (see the module's
    docstring).  A predicted peak is a step's argument bytes plus the
    largest sum of live temporaries; the measured one of (a) and (b) is
    ``analysis.memory_guard``'s of phase 7's warm-up fit and phase 9's
    first prefill (the window's ``max_memory_allocated`` less what was
    resident before the call, plus the same argument bytes)."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost_analysis import CostMode, bound_ms
    from repro_torch.launch.mesh import make_nmf_mesh
    from repro_torch.models import api
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity

    t_phase = time.perf_counter()
    out, failed = {}, []
    # the meta branches launch nothing: the card's counts stay as they are
    card_counts = _build.launch_counts()

    def peak_check(name, predicted, measured):
        ratio = predicted / measured
        ok = abs(ratio - 1.0) <= PEAK_RTOL
        log(f"[dryrun] {name}: predicted peak {predicted / 2**30:.3f} GiB, "
            f"measured {measured / 2**30:.3f} GiB ({ratio:.4f} of it; bar "
            f"{PEAK_RTOL:.0%}) on {smi}")
        if not ok:
            failed.append(f"{name}: predicted peak {predicted} B is not "
                          f"within {PEAK_RTOL:.0%} of the measured {measured}")
        return dict(predicted=predicted, measured=measured, ratio=ratio)

    # -- (a) the PubMed fit --------------------------------------------------
    cfg = NMFConfig(k=K, iters=ITERS, sparsity=Sparsity(t_u=T_U, t_v=T_V),
                    backend="cuda-bsr")
    op_meta = op.to("meta")
    u0_meta = torch.empty_like(u0, device="meta")
    occ = results["data"]["occupied_tiles"]
    for name, b in (("A", op_meta.bsr), ("At", op_meta.bsr_t)):
        if b.occupied != occ[name]:
            failed.append(f"(a) the meta operand's {name} keeps "
                          f"{b.occupied} occupied tiles, the card's holds "
                          f"{occ[name]}")
    mode = CostMode()
    with mode:
        args = mode.track(op_meta, u0_meta)
        EnforcedNMF(cfg, device="meta").fit(op_meta, u0=u0_meta)
    launches = {name: int(mode.costs.launches.get(name, 0))
                for name in _build.KERNELS}
    if launches != paths["fit"]:
        failed.append(f"(a) predicted launches {launches} != phase 3's "
                      f"{paths['fit']}")
    log(f"[dryrun] (a) PubMed fit, {ITERS} iterations on the meta operand: "
        f"launches {launches} (phase 3: {paths['fit']})")
    t = results["timing"]
    card_args = t["fit_guard_argument_bytes"]
    fit = dict(launches=launches, args=args, card_args=card_args,
               peak=peak_check("(a) PubMed fit", mode.peak_bytes,
                               t["fit_guard_peak_bytes"]),
               kernels={})
    dtype = u0.dtype
    for name, row in (("bsr_spmm_gram", "bsr_spmm_gram"),
                      ("relu_topk", "project_mask")):
        n = mode.costs.launches[name]
        fl, nb = (mode.costs.kernel_flops[name] / n,
                  mode.costs.kernel_bytes[name] / n)
        bound, by = bound_ms(fl, nb, dtype)
        ms = rows[row]["ms"]
        fit["kernels"][name] = dict(flops=fl, bytes=nb, bound_ms=bound,
                                    bound_by=by, ms=ms, share=bound / ms)
        log(f"[dryrun] (a) {name} a launch: {fl:.4e} FLOPs, {nb:.4e} bytes "
            f"(from shapes only), bound {bound:.6f} ms by {by}; "
            f"phase 7's {ms:.5f} ms: {100 * bound / ms:.1f}% of the roofline "
            f"on {smi}")
    out["fit"] = fit

    # -- (b) the llama3.2-1b prefill ------------------------------------------
    lm_cfg = ARCHS[LM_ARCH]
    shape = ShapeSpec("prefill", PREFILL_S, PREFILL_B, "prefill")
    model = api.init_params(lm_cfg, device="meta")
    batch = {n: torch.empty(s.shape, dtype=s.dtype, device="meta")
             for n, s in api.input_specs(lm_cfg, shape).items()}
    mode = CostMode()
    with mode:
        args = mode.track(model, batch)
        api.make_prefill_step(lm_cfg)(model, batch)
    flash = int(mode.costs.launches.get("flash_attention", 0))
    if flash != lm_cfg.n_layers:
        failed.append(f"(b) predicted {flash} flash launches, not "
                      f"{lm_cfg.n_layers}")
    lm = results["lm"]
    flops = mode.costs.flops
    log(f"[dryrun] (b) {lm_cfg.name} prefill {PREFILL_B} x {PREFILL_S} on "
        f"meta: {flash} flash launches (phase 9: "
        f"{paths['prefill']['flash_attention']}); {flops:.4e} FLOPs counted "
        f"(flash {mode.costs.kernel_flops['flash_attention']:.4e}) beside "
        f"phase 11's {1e3 * lm['prefill_s']:.2f} ms: "
        f"{flops / lm['prefill_s'] / 1e12:.1f} TFLOP/s, "
        f"{100 * flops / lm['prefill_s'] / BF16_FLOPS:.1f}% of the bf16 peak "
        f"on {smi}")
    out["prefill"] = dict(flash_launches=flash, flops=flops,
                          bytes=mode.costs.hbm_bytes,
                          prefill_ms=1e3 * lm["prefill_s"],
                          peak=peak_check("(b) prefill", mode.peak_bytes,
                                          lm["prefill_guard_peak_bytes"]))
    del model, batch

    # -- (c) phase 25's cell on a fake 2x2 grid --------------------------------
    shard = results["shard"]
    sh_cfg = dataclasses.replace(lm_cfg, n_layers=sizes["layers"])
    sh_shape = ShapeSpec("shard", sizes["seq"], sizes["batch"], "train")
    rows_, cols_ = sizes["grid"]
    with dryrun.fake_world(rows_ * cols_):
        rec = dryrun.lower_cell(sh_cfg, sh_shape,
                                make_nmf_mesh(rows_, cols_, device="meta"),
                                microbatches=1)
    ar = rec["collectives"]["all_reduce"]
    log(f"[dryrun] (c) {sh_cfg.name}, {sizes['layers']} layers, "
        f"{sizes['batch']} x {sizes['seq']} on a fake {rows_}x{cols_} grid: "
        f"parameters + mu + nu a rank {rec['state_bytes']} B (phase 25: "
        f"{shard['state_bytes'][0]}); all_reduce a step {ar['calls']:.0f} "
        f"calls, {ar['bytes'] / 1e6:.1f} MB (phase 25: "
        f"{shard['all_reduce_calls']:.0f}, "
        f"{shard['all_reduce_bytes'] / 1e6:.1f} MB); {rec['flops']:.4e} "
        f"FLOPs a rank a step")
    if rec["state_bytes"] != shard["state_bytes"][0]:
        failed.append(f"(c) state bytes {rec['state_bytes']} != phase 25's "
                      f"{shard['state_bytes'][0]}")
    if (ar["calls"] != shard["all_reduce_calls"]
            or ar["bytes"] != shard["all_reduce_bytes"]):
        failed.append(f"(c) all_reduce {ar} != phase 25's "
                      f"{shard['all_reduce_calls']} calls, "
                      f"{shard['all_reduce_bytes']} bytes")
    out["shard"] = dict(state_bytes=rec["state_bytes"], all_reduce=ar,
                        flops=rec["flops"],
                        peak=peak_check("(c) sharded step, rank 0",
                                        rec["bytes_per_device"],
                                        max(shard["peak_bytes"])))

    # -- (d) phase 25(d)'s olmoe cell on a fake 2x2 grid ----------------------
    fam = shard["families"]["olmoe-1b-7b"]
    mo_cfg = family_config("olmoe-1b-7b", sizes)
    mo_shape = ShapeSpec("shard", sizes["family_seq"], sizes["family_batch"],
                         "train")
    with dryrun.fake_world(rows_ * cols_):
        rec = dryrun.lower_cell(mo_cfg, mo_shape,
                                make_nmf_mesh(rows_, cols_, device="meta"),
                                microbatches=1)
    card = fam["counts_per_step"]
    want = {"all_reduce": (card["all_reduce"], card["bytes"]),
            "all_to_all": (card.get("all_to_all", 0),
                           card.get("all_to_all_bytes", 0))}
    got = {k: (rec["collectives"].get(k, {}).get("calls", 0),
               rec["collectives"].get(k, {}).get("bytes", 0)) for k in want}
    log(f"[dryrun] (d) {mo_cfg.name}, {mo_cfg.n_layers} layers, "
        f"{sizes['family_batch']} x {sizes['family_seq']} on a fake "
        f"{rows_}x{cols_} grid: parameters + mu + nu a rank "
        f"{rec['state_bytes']} B (phase 25(d): {fam['state_bytes'][0]}); "
        f"(calls, bytes) a step {got} (phase 25(d): {want}); "
        f"{rec['flops']:.4e} FLOPs a rank a step")
    if rec["state_bytes"] != fam["state_bytes"][0]:
        failed.append(f"(d) state bytes {rec['state_bytes']} != phase "
                      f"25(d)'s {fam['state_bytes'][0]}")
    if got != want:
        failed.append(f"(d) collectives {got} != phase 25(d)'s {want}")
    out["moe_shard"] = dict(state_bytes=rec["state_bytes"], collectives=got,
                            flops=rec["flops"],
                            peak=peak_check("(d) olmoe sharded step, rank 0",
                                            rec["bytes_per_device"],
                                            max(fam["peak_bytes"])))
    # -- (e) 25(f)'s serving cells on a fake 2x2 grid --------------------------
    t0 = time.perf_counter()
    out["serving"] = dryrun_serving_cells(shard["serving"], sizes,
                                          peak_check, failed)
    out["serving_s"] = time.perf_counter() - t0
    log(f"[dryrun] 26(e) took {out['serving_s']:.1f} s")
    if _build.launch_counts() != card_counts:
        failed.append(f"the dry-runs moved the card's launch counts from "
                      f"{card_counts} to {_build.launch_counts()}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[dryrun] phase 26 took {out['seconds']:.1f} s")
    results["dryrun"] = out
    if failed:
        raise AssertionError("the dry-run disagrees with the card: "
                             + "; ".join(failed))


def run_analysis_slice(dev, a_sp, op, u0, smi, results):
    """Phase 27: the analyzer's runtime guards on the card (see the
    module's docstring).  A guard's peak is the call's arguments plus the
    largest sum of what it made: on the card the allocator's
    ``max_memory_allocated`` less what was resident before the call, on
    ``meta`` ``CostMode``'s, the number the IR gate budgets."""
    import torch

    from repro_torch.analysis import memory_guard, recompile_guard
    from repro_torch.analysis.ir.targets import (
        CANON, canon_operand, canon_u0, engine_fn,
    )
    from repro_torch.backend import get_backend
    from repro_torch.kernels import _build
    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity

    t_phase = time.perf_counter()
    out, failed = {"canon": {}, "pubmed": {}}, []

    def held(size, backend, fn, card_args, meta_args, bar):
        t0 = time.perf_counter()
        card = memory_guard(fn, *card_args)
        t1 = time.perf_counter()
        plan = memory_guard(fn, *meta_args)
        t2 = time.perf_counter()
        ratio = plan.peak_bytes / card.peak_bytes
        log(f"[analysis] (a) als[{backend}] at {size}: meta planner "
            f"{plan.peak_bytes} B ({t2 - t1:.2f} s), card "
            f"{card.peak_bytes} B ({t1 - t0:.2f} s; arguments "
            f"{card.argument_bytes} B, scratch {card.temp_bytes} B): "
            f"{ratio:.4f} of it"
            + (f" (bar {bar:.0%})" if bar is not None else " (no bar: the "
               "allocator rounds each block to 512 B)") + f" on {smi}")
        if bar is not None and abs(ratio - 1.0) > bar:
            failed.append(f"als[{backend}] at {size}: the planner's "
                          f"{plan.peak_bytes} B is not within {bar:.0%} of "
                          f"the card's {card.peak_bytes} B")
        if plan.argument_bytes != card.argument_bytes:
            failed.append(f"als[{backend}] at {size}: argument bytes "
                          f"{plan.argument_bytes} on meta, "
                          f"{card.argument_bytes} on the card")
        return dict(meta=plan.peak_bytes, card=card.peak_bytes, ratio=ratio,
                    arguments=card.argument_bytes, card_temp=card.temp_bytes)

    # -- (a) memory_guard: the canonical size and PubMed's -------------------
    for backend in ("cuda-bsr", "torch-csr"):
        a = canon_operand(backend, dev)
        out["canon"][backend] = held(
            f"{CANON['n']}x{CANON['m']}", backend, engine_fn("als", backend),
            (a, canon_u0(device=dev)), (a.to("meta"), canon_u0()), None)
        del a
    sizes = dict(n=N_TERMS, m=N_DOCS, k=K, iters=3)
    u0_meta = torch.empty_like(u0, device="meta")
    for backend, a in (("cuda-bsr", op),
                       ("torch-csr", get_backend("torch-csr").prepare(
                           a_sp, device=dev))):
        out["pubmed"][backend] = held(
            f"PubMed {N_TERMS}x{N_DOCS}", backend,
            engine_fn("als", backend, **sizes), (a, u0), (a.to("meta"),
                                                         u0_meta), PEAK_RTOL)
        del a

    # -- (b) recompile_guard: a second identical fit builds nothing ----------
    t0 = time.perf_counter()
    cfg = NMFConfig(k=CANON["k"], iters=CANON["iters"], backend="cuda-bsr",
                    sparsity=Sparsity(t_u=CANON["t_u"], t_v=CANON["t_v"]))
    a, u = canon_operand("cuda-bsr", dev), canon_u0(device=dev)
    EnforcedNMF(cfg, device=dev).fit(a, u0=u)
    before = _build.launch_counts()
    with recompile_guard() as counter:
        EnforcedNMF(cfg, device=dev).fit(a, u0=u)
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.launch_counts().items()
                if v != before[k]}
    log(f"[analysis] (b) a second identical fit under recompile_guard(): "
        f"{counter.count} nvcc builds, launches {launched} "
        f"({time.perf_counter() - t0:.2f} s, both fits)")
    if counter.count or not launched:
        failed.append(f"(b) {counter.count} builds, launches {launched}")
    out["recompile"] = dict(builds=counter.count, launches=launched)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[analysis] phase 27 took {out['seconds']:.1f} s on {smi}")
    results["analysis"] = out
    if failed:
        raise AssertionError("the analyzer's guards disagree: "
                             + "; ".join(failed))


#: the paper's Wikipedia configuration (``NMF_CONFIGS["wikipedia"]``, Table
#: 1 / Fig. 7): 143,462 terms x 12,439 pages, k = 5, 50 iterations; 2% of
#: each dense factor kept, as phase 3 keeps at PubMed
WIKI_TERMS, WIKI_DOCS = 143462, 12439
WIKI_T_U, WIKI_T_V = WIKI_TERMS * K // 50, WIKI_DOCS * K // 50  # 14346, 1243
#: the reference's host ingest of this corpus (a float64 copy of A's whole
#: tile volume), measured on another host (8 cores, no card) before the
#: lean ingest: seconds and peak RSS, printed for orientation only;
#: ``tools/ingest_ab.py`` times both ingests on one host
WIKI_OLD_INGEST_S, WIKI_OLD_INGEST_PEAK_GB = 38.7, 36.0
#: the card's host link, PCIe 5.0 x16, one direction (bytes/s): the bound
#: of a copy from host memory
PCIE_BYTES_PER_S = 64e9


def rss_bytes():
    """This process's resident set (``/proc/self/status``, ``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def mem_total_bytes():
    """The host's memory (``/proc/meminfo``, ``MemTotal``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    return 0


def chunk_coverage(sub, bm, bk):
    """Which blocks of ``bm`` terms and of ``bk`` documents of the chunk
    ``sub`` (terms x its documents, scipy CSR) hold an entry: a block
    with none is referenced by no slot of the chunk's transposed (terms)
    or own (documents) BSR orientation, and each fused product on that
    orientation adds the Gram of those rows in a ``gram`` launch
    (``kernels/fused.py``).  Block 0 counts as held: padding slots point
    there.  Two boolean arrays, over the term and the document blocks."""
    n, w = sub.shape
    terms = np.zeros(-(-n // bm), bool)
    terms[np.flatnonzero(np.diff(sub.indptr)) // bm] = True
    docs = np.zeros(-(-w // bk), bool)
    docs[np.unique(sub.indices) // bk] = True
    terms[0] = docs[0] = True
    return terms, docs


class RssPeak:
    """The largest ``VmRSS`` of this process inside a ``with`` block,
    sampled every 20 ms on a thread (the kernel's own high-water mark,
    ``VmHWM``, covers the process's whole life), and the RSS before it."""

    def __enter__(self):
        import threading

        self.base = self.peak = rss_bytes()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())
        return False


def wikipedia_corpus():
    """The synthetic corpus of the Wikipedia configuration, made as the
    command line makes it (seed 0, 5 journals), kept as its scipy CSR
    (~7 MB): the padded ``SpCSR`` the generator returns (13.3 GB, its
    width the head term's ~11,600 documents) is dropped here, before any
    timed window."""
    from repro_torch.data import synthetic_journal_corpus
    from repro_torch.sparse import to_scipy

    t0 = time.perf_counter()
    corpus, _ = synthetic_journal_corpus(n_terms=WIKI_TERMS,
                                         n_docs=WIKI_DOCS, n_journals=5)
    gen_s = time.perf_counter() - t0
    padded = (corpus.values.numel() * corpus.values.element_size()
              + corpus.cols.numel() * corpus.cols.element_size())
    rss = rss_bytes()
    a_sp = to_scipy(corpus).tocsr()
    del corpus
    return dict(a_sp=a_sp, gen_s=gen_s, seconds=time.perf_counter() - t0,
                padded_bytes=padded, rss_with_padded=rss)


def wikipedia_command_line(card):
    """Phase 28(c): ``python -m repro_torch.launch.nmf_run --config
    wikipedia --backend cuda-bsr --iters 3 --sparsity
    frac_u=0.02,frac_v=0.02`` exits 0 and prints a fit line: a finite
    error, NNZ within the budgets.  Run beside untimed work only (the
    build and the train launchers' runs)."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.nmf_run", "--config",
           "wikipedia", "--backend", "cuda-bsr", "--iters", "3",
           "--sparsity", "frac_u=0.02,frac_v=0.02"] + (
               [] if card else ["--device", "cpu", "--small"])
    t0 = time.perf_counter()
    cli = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    secs = time.perf_counter() - t0
    if cli.returncode != 0:
        raise AssertionError(f"nmf_run --config wikipedia exited "
                             f"{cli.returncode}: {cli.stderr[-3000:]}")
    got = re.search(r"final error (\S+), residual \S+, NNZ\(U\)=(\d+), "
                    r"NNZ\(V\)=(\d+)", cli.stdout)
    if got is None:
        raise AssertionError(f"nmf_run --config wikipedia printed no fit "
                             f"line: {cli.stdout[-2000:]}")
    from repro_torch.configs import NMF_CONFIGS

    err, nnz_u, nnz_v = float(got[1]), int(got[2]), int(got[3])
    wiki = NMF_CONFIGS["wikipedia"]
    n, m = wiki["n_terms"], wiki["n_docs"]
    if not card:
        n, m = n // 8, m // 8
    t_u, t_v = int(n * K * 0.02), int(m * K * 0.02)
    if not (np.isfinite(err) and nnz_u <= t_u + max(2, t_u // 100)
            and nnz_v <= t_v + max(2, t_v // 100)):
        raise AssertionError(f"nmf_run --config wikipedia: error {err}, "
                             f"NNZ(U) {nnz_u} (t_u {t_u}), NNZ(V) {nnz_v} "
                             f"(t_v {t_v})")
    line = [ln for ln in cli.stdout.splitlines() if ln.startswith("solver=")]
    return dict(seconds=secs, line=line, error=err, nnz_u=nnz_u,
                nnz_v=nnz_v, t_u=t_u, t_v=t_v)


def run_wikipedia_slice(dev, wiki, cli, smi, paths, results, rows):
    """Phase 28: the paper's Wikipedia configuration on the card (see the
    module's docstring).  ``wiki`` is :func:`wikipedia_corpus`'s result,
    made while the script waited for the train launchers; ``cli`` the
    future of (c)'s command line, started beside them."""
    import gc

    import torch

    from repro_torch.analysis import memory_guard
    from repro_torch.backend import get_backend
    from repro_torch.convert import estimator_from_reference
    from repro_torch.core.nmf import init_u0, solve_gram
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.bsr import bsr_dot_uv, bsr_operand
    from repro_torch.kernels.bsr_spmm import bsr_spmm
    from repro_torch.kernels.fused import bsr_spmm_gram
    from repro_torch.kernels.gram import gram
    from repro_torch.kernels.project_mask import relu_topk
    from repro_torch.nmf import (
        EnforcedNMF, NMFConfig, Sparsity, default_chunk_docs,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = results["wikipedia"] = {}
    a_sp = wiki["a_sp"]
    n, m = a_sp.shape
    mem_total = mem_total_bytes()
    log(f"[wiki] Wikipedia-shaped corpus {n} x {m}, nnz {a_sp.nnz}: "
        f"generated in {wiki['gen_s']:.2f} s ({wiki['seconds']:.2f} s with "
        f"its scipy copy) while the train launchers ran; its padded SpCSR "
        f"{wiki['padded_bytes'] / 1e9:.2f} GB (RSS "
        f"{wiki['rss_with_padded'] / 1e9:.2f} GB with it) dropped before "
        f"any timed window; this "
        f"process's RSS now {rss_bytes() / 1e9:.2f} GB of the host's "
        f"{mem_total / 1e9:.1f} GB")
    out["corpus"] = {k: v for k, v in wiki.items() if k != "a_sp"} | dict(
        shape=[n, m], nnz=int(a_sp.nnz), mem_total=mem_total)

    # -- (a) the host ingest, then one copy to the card -----------------------
    be = get_backend("cuda-bsr")
    tiles = be.tile_config(n, m, device=dev)
    with RssPeak() as rss:
        t0 = time.perf_counter()
        host_op = bsr_operand(a_sp, bm=tiles.bm, bk=tiles.bk, device="cpu")
        ingest_s = time.perf_counter() - t0
    tile_bytes = sum(b.tiles.numel() * b.tiles.element_size()
                     for b in (host_op.bsr, host_op.bsr_t))
    occ = {"A": host_op.bsr.occupied, "At": host_op.bsr_t.occupied}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = host_op.to(dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    del host_op
    dev_bytes = sum(t.numel() * t.element_size() for b in (op.bsr, op.bsr_t)
                    for t in (b.tiles, b.block_cols, b.gram_flags))
    above = rss.peak - rss.base
    ingest = dict(seconds=ingest_s, rss_base=rss.base, rss_peak=rss.peak,
                  above_input=above, tile_bytes=tile_bytes,
                  h2d_s=h2d_s, h2d_bound_s=tile_bytes / PCIE_BYTES_PER_S,
                  device_bytes=dev_bytes, occupied=occ,
                  nrb=[op.bsr.nrb, op.bsr_t.nrb],
                  bcap=[op.bsr.bcap, op.bsr_t.bcap],
                  tiles=[tiles.bm, tiles.bk])
    out["ingest"] = ingest
    log(f"[wiki] host ingest (bsr_operand of the scipy corpus, both "
        f"orientations at {tiles.bm} x {tiles.bk}): {ingest_s:.2f} s, RSS "
        f"peak {rss.peak / 1e9:.2f} GB, {above / 1e9:.2f} GB above its "
        f"input ({above / tile_bytes:.3f}x the two orientations' "
        f"{tile_bytes / 1e9:.2f} GB of tiles; target <= 1.15x); the "
        f"float64 ingest took {WIKI_OLD_INGEST_S} s / "
        f"{WIKI_OLD_INGEST_PEAK_GB} GB peak on another host (8 cores, no "
        f"card; tools/ingest_ab.py times both on one); A: nrb "
        f"{op.bsr.nrb}, bcap {op.bsr.bcap}, A^T: nrb {op.bsr_t.nrb}, bcap "
        f"{op.bsr_t.bcap}, "
        f"occupied tiles {occ['A']} / {occ['At']} of "
        f"{op.bsr.nrb * op.bsr.bcap} / {op.bsr_t.nrb * op.bsr_t.bcap} slots "
        f"({100 * occ['A'] / (op.bsr.nrb * op.bsr.bcap):.1f}% / "
        f"{100 * occ['At'] / (op.bsr_t.nrb * op.bsr_t.bcap):.1f}%), "
        f"{100 * a_sp.nnz / (occ['A'] * tiles.bm * tiles.bk):.3f}% of an "
        f"occupied tile's entries stored; to the card {h2d_s:.2f} s for "
        f"{dev_bytes / 1e9:.2f} GB on the card (bound "
        f"{ingest['h2d_bound_s']:.3f} s at PCIe 5.0 x16, one direction)")

    # -- (a) the whole-batch Alg. 2 fit on cuda-bsr ------------------------
    gen = torch.Generator().manual_seed(0)
    u0 = init_u0(gen, n, K, device=dev)
    cfg = NMFConfig(k=K, iters=ITERS, solver="enforced", backend="cuda-bsr",
                    sparsity=Sparsity(t_u=WIKI_T_U, t_v=WIKI_T_V))
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = EnforcedNMF(cfg, device=dev).fit(op, u0=u0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    paths["wiki_fit"] = counts = _build.launch_counts()
    res = model.result_
    nu, nv = res.final_nnz_u, res.final_nnz_v
    log(f"[wiki] cuda-bsr fit, {ITERS} iterations: {fit_s:.2f} s (the "
        f"first, set-up included), final error {res.final_error:.6f}, "
        f"NNZ(U) {nu} (t_u {WIKI_T_U}), NNZ(V) {nv} (t_v {WIKI_T_V}), health "
        f"{int(res.health)}, launches {counts}")
    if (int(res.health) != -1 or not bool(torch.isfinite(model.u_).all())
            or not bool(torch.isfinite(model.v_).all())):
        raise AssertionError("the Wikipedia fit is unhealthy")
    for nnz, t in ((nu, WIKI_T_U), (nv, WIKI_T_V)):
        if nnz > t + max(2, t // 100):
            raise AssertionError(f"Wikipedia fit: NNZ {nnz} is over {t} "
                                 "beyond ties")
    if (counts["bsr_spmm_gram"] != 2 * ITERS + 1
            or counts["relu_topk"] != 2 * ITERS
            or counts["project_mask"] != 0):
        raise AssertionError(f"Wikipedia fit launches {counts}: want "
                             f"bsr_spmm_gram {2 * ITERS + 1}, relu_topk "
                             f"{2 * ITERS}, no other mask launch")
    t0 = time.perf_counter()
    dense_a = get_backend("torch-dense").prepare(a_sp, device=dev)
    torch.cuda.synchronize()
    dense_prep_s = time.perf_counter() - t0
    dense = EnforcedNMF(cfg.replace(backend="torch-dense"),
                        device=dev).fit(dense_a, u0=u0)
    diffs = {f: float((getattr(dense.result_, f) - getattr(res, f)
                       ).abs().max()) for f in ("error", "residual")}
    log(f"[wiki] torch-dense fit on the card from the same u0 (dense A "
        f"{dense_a.numel() * 4 / 1e9:.2f} GB, made in {dense_prep_s:.2f} s): "
        f"traces against cuda-bsr within {diffs} (bar 1e-4); its final "
        f"error {dense.result_.final_error:.6f}")
    if max(diffs.values()) > 1e-4:
        raise AssertionError(f"Wikipedia: cuda-bsr and torch-dense traces "
                             f"differ by {diffs} > 1e-4")
    del dense
    _build.reset_launch_counts()
    v_fold = model.transform(op)
    torch.cuda.synchronize()
    paths["wiki_transform"] = fold = _build.launch_counts()
    dense_model = estimator_from_reference(
        model.u_.cpu().numpy(), model.v_.cpu().numpy(), m,
        cfg.replace(backend="torch-dense"), device=dev)
    fold_diff = float((v_fold - dense_model.transform(dense_a)).abs().max())
    log(f"[wiki] transform of the corpus: launches {fold}, V "
        f"{tuple(v_fold.shape)} within {fold_diff:.3e} of the dense fold-in "
        "(bar 1e-4)")
    if fold["bsr_spmm"] != 1 or fold["relu_topk"] != 1 or fold_diff > 1e-4:
        raise AssertionError(f"Wikipedia transform: launches {fold}, "
                             f"{fold_diff:.3e} from the dense fold-in")
    del dense_model, v_fold
    out["fit"] = dict(first_s=fit_s, launches=counts, nnz_u=nu, nnz_v=nv,
                      error=res.error.tolist(),
                      residual=res.residual.tolist(), dense_diffs=diffs,
                      dense_prep_s=dense_prep_s, transform=fold,
                      fold_diff=fold_diff)

    # -- (b) the streamed fit, resident chunks, prefetch on ---------------
    scfg = cfg.replace(solver="streaming")
    width = default_chunk_docs(m)
    chunks = -(-m // width)
    inner = min(ITERS, 10)
    cap, cover = 0, []
    for lo in range(0, m, width):
        sub = a_sp[:, lo:lo + width].tocsr()
        cap = max(cap, int(np.diff(sub.indptr).max()))
        # the tiles stage_chunk ingests the chunk at (on the host)
        ct = be.tile_config(*sub.shape, device="cpu")
        cover.append(chunk_coverage(sub, ct.bm, ct.bk))
    disk = chunks * n * cap * (4 + 4)
    # each pass's A_c^T U and A_c V_c add a gram launch where the chunk
    # leaves a block of terms or documents unreferenced
    want_gram = inner * sum((not t.all()) + (not d.all()) for t, d in cover)
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on = EnforcedNMF(scfg, device=dev).fit(a_sp, u0=u0)
    torch.cuda.synchronize()
    on_s = time.perf_counter() - t0
    paths["wiki_stream"] = scounts = _build.launch_counts()
    speak = torch.cuda.max_memory_allocated()
    sres = on.result_
    want = 2 * inner * chunks
    if (scounts["bsr_spmm_gram"] != want or scounts["relu_topk"] != want + 1
            or scounts["bsr_spmm"] != 2 * chunks
            or scounts["gram"] != want_gram):
        raise AssertionError(f"Wikipedia streamed fit launches {scounts}: "
                             f"want bsr_spmm_gram {want}, relu_topk "
                             f"{want + 1}, bsr_spmm {2 * chunks}, gram "
                             f"{want_gram}")
    if int(sres.health) != -1 or not bool(torch.isfinite(on.u_).all()):
        raise AssertionError("the Wikipedia streamed fit is unhealthy")
    passes = {p: sres.stream_stats[p] for p in ("fit", "fold_in", "seed")}
    # the oracle: the same streamed fit on torch-dense, carved from the
    # dense operand of (a) (no padded SpCSR of its own)
    t0 = time.perf_counter()
    oracle = EnforcedNMF(scfg.replace(backend="torch-dense"),
                         device=dev).fit(dense_a, u0=u0)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    sdiffs = {f: float((getattr(oracle.result_, f) - getattr(sres, f)
                        ).abs().max()) for f in ("residual", "error")}
    sdiffs["u_rel"] = float((oracle.u_ - on.u_).abs().max()
                            / on.u_.abs().max())
    log(f"[wiki] streamed cuda-bsr fit, {chunks} chunks of <= {width} "
        f"documents, {inner} passes a chunk, prefetch on: {on_s:.2f} s, "
        f"launches {scounts} (gram on the U rows of the "
        f"{sum(not t.all() for t, _ in cover)} chunks that leave a term "
        f"block unreferenced, and the V_c rows of the "
        f"{sum(not d.all() for _, d in cover)} that leave a document block"
        f"), device peak {speak / 1e9:.2f} GB; each pass's "
        f"host ingest (Prefetcher pack / consumer stall, s): "
        + ", ".join(f"{p} {st['pack_s']:.2f} / {st['stall_s']:.2f}"
                    for p, st in passes.items())
        + f"; the torch-dense streamed fit {oracle_s:.2f} s, within {sdiffs} "
        f"(U relative to its largest entry; bar 1e-4); not spilled: a "
        f"write_corpus directory would hold {chunks} x {n} x {cap} slots, "
        f"{disk / 1e9:.2f} GB")
    if max(sdiffs.values()) > 1e-4:
        raise AssertionError(f"Wikipedia streamed cuda-bsr and torch-dense "
                             f"differ: {sdiffs}")
    out["stream"] = dict(seconds=on_s, chunks=chunks, width=width,
                         inner=inner, launches=scounts, passes=passes,
                         uncovered_terms=[bool(not t.all()) for t, _ in cover],
                         uncovered_docs=[bool(not d.all()) for _, d in cover],
                         device_peak=speak, oracle_s=oracle_s,
                         diffs=sdiffs,
                         chunk_cap=cap, disk_bytes=disk,
                         error=sres.error.tolist())
    del on, oracle, dense_a
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) an iteration, its busy share, the planner's peak ----------------
    timed = EnforcedNMF(cfg, device=dev)
    card = memory_guard(timed.fit, op, u0=u0)
    t0 = time.perf_counter()
    timed.fit(op, u0=u0)
    torch.cuda.synchronize()
    per_iter_ms = 1e3 * (time.perf_counter() - t0) / ITERS
    prof_cfg = cfg.replace(iters=5)
    prof = profiled("Wikipedia 5-iteration fit (set-up included)",
                    lambda: EnforcedNMF(prof_cfg, device=dev).fit(op, u0=u0))
    busy_ms = prof["device_busy_us"] / 1e3 / 5
    u0_meta = torch.empty_like(u0, device="meta")
    plan = memory_guard(EnforcedNMF(cfg, device="meta").fit, op.to("meta"),
                        u0=u0_meta)
    ratio = plan.peak_bytes / card.peak_bytes
    log(f"[wiki] cuda-bsr fit: {per_iter_ms:.3f} ms an iteration (host "
        f"clock, {ITERS} iterations, the operand ingested), device busy "
        f"{busy_ms:.3f} ms an iteration in a 5-iteration profiler window "
        f"({prof['kernels_per_call'] / 5:.0f} kernels an iteration); the "
        f"meta planner's peak {plan.peak_bytes / 2**30:.3f} GiB against the "
        f"card's {card.peak_bytes / 2**30:.3f} GiB (memory_guard: "
        f"{ratio:.4f} of it, bar {PEAK_RTOL:.0%}) on {smi}")
    if abs(ratio - 1.0) > PEAK_RTOL:
        raise AssertionError(f"Wikipedia fit: the planner's peak "
                             f"{plan.peak_bytes} B is not within "
                             f"{PEAK_RTOL:.0%} of the card's "
                             f"{card.peak_bytes} B")
    out["iteration"] = dict(ms=per_iter_ms, busy_ms=busy_ms,
                            busy_share=busy_ms / per_iter_ms,
                            profile=prof, card_peak=card.peak_bytes,
                            card_args=card.argument_bytes,
                            meta_peak=plan.peak_bytes, peak_ratio=ratio)
    del timed

    # -- (d) the kernels at this shape, against their plain versions ---------
    u_fit, v_fit = model.u_, model.v_
    kern = {}
    for o, b, w, tiles_o, sp in (
            ("A@V", op.bsr, v_fit, occ["A"], a_sp),
            ("A^T@U", op.bsr_t, u_fit, occ["At"], a_sp.T.tocsr())):
        y, g = bsr_spmm_gram(b, w)
        if not torch.equal(y, bsr_spmm(b, w)):
            raise AssertionError(f"Wikipedia {o}: the fused product is not "
                                 "bitwise bsr_spmm's")
        y_ref, g_ref = ref.bsr_spmm_gram_ref(b, w)
        err = max(close(f"Wikipedia bsr_spmm {o}", y, y_ref, 1e-4, 1e-4),
                  close(f"Wikipedia bsr_spmm_gram gram {o}", g, g_ref, 1e-5,
                        1e-4))
        del y, g, y_ref, g_ref
        flops = 2.0 * tiles_o * b.bm * b.bk * K
        flagged = int((b.gram_flags != 0).sum())
        call, lib = _lib_spmm(b, w, sp, dev)
        item = dict(
            max_abs_err=err,
            spmm_ms=cuda_ms(lambda: bsr_spmm(b, w), reps=10),
            fused_ms=cuda_ms(lambda: bsr_spmm_gram(b, w), reps=10),
            plain_ms=cuda_ms(lambda: ref.bsr_spmm_ref(b, w), reps=3,
                             warmup=1),
            fused_plain_ms=cuda_ms(lambda: ref.bsr_spmm_gram_ref(b, w),
                                   reps=3, warmup=1),
            library_call=call, library_ms=cuda_ms(lib, reps=5, warmup=1),
            spmm_bound=bound_ms(_spmm_bytes(b, w, tiles_o, K), flops),
            fused_bound=bound_ms(_spmm_bytes(b, w, tiles_o, K, True),
                                 flops + 2.0 * flagged * b.bk * K * K),
            flagged=flagged)
        del lib
        st = torch.zeros((b.plan.runs, 2), dtype=torch.int64, device=dev)
        bsr_spmm_gram(b, w, stamps=st)
        torch.cuda.synchronize()
        t = st.cpu().numpy()
        end = (t[:, 1] - t[:, 0].min()) / 1e3
        item["tail_us"] = dict(min=float(end.min()),
                               median=float(np.median(end)),
                               mean=float(end.mean()), max=float(end.max()))
        kern[o] = item
        shares = [100 * item[f"{key}_bound"][0] / item[f"{key}_ms"]
                  for key in ("spmm", "fused")]
        log(f"[wiki] {o}: bsr_spmm {item['spmm_ms']:.4f} ms, fused "
            f"{item['fused_ms']:.4f} ms (bounds {item['spmm_bound'][0]:.4f}"
            f" / {item['fused_bound'][0]:.4f} ms by {item['spmm_bound'][1]},"
            f" the occupied tiles; {shares[0]:.1f}% / {shares[1]:.1f}% of "
            f"the bound), plain {item['plain_ms']:.3f} / "
            f"{item['fused_plain_ms']:.3f} ms, "
            f"{call} {item['library_ms']:.4f} ms; {flagged} slots carry a "
            f"first-occurrence Gram flag; max abs err against the plain "
            f"version {err:.3e}")
        tail = item["tail_us"]
        log(f"[tail] Wikipedia bsr_spmm_gram {o}: {b.plan.runs} blocks end "
            f"{tail['min']:.1f} / {tail['median']:.1f} / {tail['mean']:.1f} "
            f"/ {tail['max']:.1f} us (min / median / mean / max); the mean "
            f"end is {100 * (1 - tail['mean'] / max(tail['max'], 1e-9)):.1f}"
            "% short of the last")
    # the two epilogues on the fitted factors' pre-epilogue products, A V
    # (V^T V)^-1 and A^T U (U^T U)^-1
    av, gv = be.matmul_with_gram(op, v_fit)
    x_u = solve_gram(gv, av)
    x_v = solve_gram(u_fit.T @ u_fit, be.matmul_t(op, u_fit))
    del av, gv
    epi = {}

    def bits(x):
        return x.contiguous().view(torch.int32)

    for name, x, t in (("U", x_u, WIKI_T_U), ("V", x_v, WIKI_T_V)):
        got, tau = relu_topk(x, t)
        want, want_tau = ref.relu_topk_ref(x, t)
        if not (torch.equal(bits(got), bits(want))
                and torch.equal(bits(tau), bits(want_tau))):
            raise AssertionError(f"Wikipedia relu_topk {name}: not bitwise "
                                 "the plain version")
        n_el = x.numel()
        epi[name] = dict(
            shape=list(x.shape), t=t,
            ms=cuda_ms(lambda: relu_topk(x, t), reps=50),
            plain_ms=cuda_ms(lambda: ref.relu_topk_ref(x, t), reps=5),
            bound=bound_ms(4 * (2 * n_el + 1), (NUM_STEPS + 2.0) * n_el))
        log(f"[wiki] relu_topk {name} ({x.shape[0]} x {K}, t {t}): "
            f"{epi[name]['ms']:.5f} ms, plain {epi[name]['plain_ms']:.4f} ms,"
            f" bound {epi[name]['bound'][0]:.6f} ms by "
            f"{epi[name]['bound'][1]}; bitwise the plain version")
    del x_u, x_v
    # gram at the streamed fit's shape: the Gram of the U rows (143,462 x
    # 5, the others zeroed) that the first chunk leaving a term block
    # unreferenced holds, from that chunk's operand as stage_chunk builds it
    gram_item = None
    c = next((i for i, (t, _) in enumerate(cover) if not t.all()), None)
    if c is not None:
        sub = a_sp[:, c * width:(c + 1) * width].tocsr()
        bt = be.prepare(sub, device="cpu").bsr_t
        unc = bt.uncovered_rows.numpy()
        if not np.array_equal(unc, ~cover[c][0][np.arange(n) // bt.bk]):
            raise AssertionError(f"Wikipedia chunk {c}: its operand's "
                                 "unreferenced term rows are not those "
                                 "chunk_coverage counted")
        x = ref.unreferenced_rows(dataclasses.replace(
            bt, uncovered_rows=bt.uncovered_rows.to(dev)), u_fit)
        del bt, sub
        g1 = gram(x)
        if not torch.equal(gram(x), g1):
            raise AssertionError("Wikipedia gram is not bitwise repeatable")
        gram_item = dict(
            chunk=c, shape=list(x.shape), rows=int(unc.sum()),
            max_abs_err=close("Wikipedia gram", g1, ref.gram_ref(x), 1e-4,
                              1e-3),
            ms=cuda_ms(lambda: gram(x), reps=200),
            plain_ms=cuda_ms(lambda: ref.gram_ref(x), reps=50),
            library_ms=cuda_ms(lambda: x.T @ x, reps=200),
            bound=bound_ms(4 * (n * K + K * K), gram_flops(n, K)))
        log(f"[wiki] gram of chunk {c}'s unreferenced U rows ({unc.sum()} "
            f"of {n} kept, {n} x {K}): {gram_item['ms']:.5f} ms, plain "
            f"{gram_item['plain_ms']:.5f} ms, u.T @ u "
            f"{gram_item['library_ms']:.5f} ms, bound "
            f"{gram_item['bound'][0]:.6f} ms by {gram_item['bound'][1]}; "
            f"max abs err against the plain version "
            f"{gram_item['max_abs_err']:.3e}, bitwise repeatable")
        del x, g1
    dot_ms = cuda_ms(lambda: bsr_dot_uv(op.bsr, u_fit, v_fit), reps=10)
    dot_bound = bound_ms(4 * (op.bsr.nrb * op.bsr.bcap * op.bsr.bm
                              * op.bsr.bk + (n + m) * K),
                         2.0 * op.bsr.nrb * op.bsr.bcap * op.bsr.bm
                         * op.bsr.bk * K)
    log(f"[wiki] the error path's <A, U V^T> (bsr_dot_uv, every one of A's "
        f"{op.bsr.nrb * op.bsr.bcap} slots): {dot_ms:.4f} ms, "
        f"{100 * dot_ms / per_iter_ms:.1f}% of an iteration (bound "
        f"{dot_bound[0]:.4f} ms over all slots)")
    out["kernels"] = dict(bsr=kern, relu_topk={
        k: {kk: vv for kk, vv in v.items() if kk != "bound"}
        | {"bound_ms": v["bound"][0]} for k, v in epi.items()},
        dot_ms=dot_ms, dot_share=dot_ms / per_iter_ms,
        dot_bound_ms=dot_bound[0], gram=gram_item and (
            {k: v for k, v in gram_item.items() if k != "bound"}
            | {"bound_ms": gram_item["bound"][0]}))
    for name, key in (("bsr_spmm", "spmm"), ("bsr_spmm_gram", "fused")):
        rows[name].setdefault("extra", {})["wikipedia"] = dict(
            ms=float(np.mean([kern[o][f"{key}_ms"] for o in kern])),
            bound_ms=float(np.mean([kern[o][f"{key}_bound"][0]
                                    for o in kern])),
            plain_ms=float(np.mean([kern[o][("plain_ms" if key == "spmm"
                                             else "fused_plain_ms")]
                                    for o in kern])),
            library_ms=(float(np.mean([kern[o]["library_ms"] for o in kern]))
                        if key == "spmm" else None),
            launches=(paths["wiki_transform"]["bsr_spmm"] if key == "spmm"
                      else counts["bsr_spmm_gram"]))
    if gram_item is not None:
        rows["gram"].setdefault("extra", {})["wikipedia"] = dict(
            ms=gram_item["ms"], bound_ms=gram_item["bound"][0],
            plain_ms=gram_item["plain_ms"],
            library_ms=gram_item["library_ms"], launches=scounts["gram"])
    rows["project_mask"].setdefault("extra", {})["wikipedia"] = dict(
        ms=float(np.mean([e["ms"] for e in epi.values()])),
        bound_ms=float(np.mean([e["bound"][0] for e in epi.values()])),
        plain_ms=float(np.mean([e["plain_ms"] for e in epi.values()])),
        library_ms=None, launches=counts["relu_topk"])
    del model, u_fit, v_fit, op
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) the command line, run beside the train launchers -----------------
    c = cli.result()
    log(f"[wiki] python -m repro_torch.launch.nmf_run --config wikipedia "
        f"--backend cuda-bsr --iters 3 --sparsity frac_u=0.02,frac_v=0.02: "
        f"exit 0 in {c['seconds']:.1f} s (beside the build and the train "
        f"launchers' runs);"
        f" {c['line']}")
    out["cli"] = c
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[wiki] phase 28 took {out['seconds']:.1f} s on {smi}")


# ---------------------------------------------------------------------------
# phase 29: the port's examples on the card
# ---------------------------------------------------------------------------

#: 29(a): each example as its docstring runs it (no ``--device``: the card;
#: the pipeline into a fresh ``--ckpt``), and the lines it must print:
#: (pattern, how many lines at least); every one must also name the card
EXAMPLE_RUNS = {
    "quickstart": (["torch_quickstart.py"], [
        (r"^term/document matrix: \(2000, 1000\), nnz=\d+$", 1),
        (r"^device +: cuda", 1),
        (r"^final relative error +: ", 1), (r"^final residual +: ", 1),
        (r"^NNZ\(U\)=\d+  NNZ\(V\)=\d+  max stored=\d+", 1),
        (r"^clustering accuracy +: ", 1),
        (r"^fold-in +: 100 new docs -> topics ", 1),
        (r"^topic [0-4]: terms \[", 5)]),
    "pipeline": (["torch_topic_modeling_pipeline.py"], [
        (r"^== stage [1-5]: ", 5), (r"^   round [1-4]/4: err=", 4),
        (r"clustering accuracy \(Eq\. 3\.3\): ", 1),
        (r"memory: stored NNZ \d+ vs dense", 1),
        (r"served 64 docs in ", 1), (r"\d+/64 documents assigned", 1),
        (r"folded 64 served docs", 1)]),
    "pipeline --stream": (["torch_topic_modeling_pipeline.py", "--stream"], [
        (r"^== stage [1-5]: ", 5), (r"^   chunk [1-8]/8 \(\d+ docs\)", 8),
        (r"^   ckpt=\d+KB", 1),
        (r"clustering accuracy \(Eq\. 3\.3\): ", 1),
        (r"served 64 docs in ", 1), (r"\d+/64 documents assigned", 1),
        (r"folded 64 served docs", 1)]),
    "serving": (["torch_serving.py"], [
        (r"^8 requests submitted; engine slots: 4$", 1),
        (r"^tick +\d+: req\d+->\d+", 2), (r"^drained in \d+ ticks", 1)]),
    "lm_training llama3.2-1b": (
        ["torch_lm_training.py", "--arch", "llama3.2-1b", "--steps", "20"], [
            (r"^llama3\.2-1b: [\d.]+M params \(reduced config\)$", 1),
            (r"^step +\d+ loss \S+ \([\d.]+s\)$", 20)]),
    "lm_training olmoe-1b-7b --compress": (
        ["torch_lm_training.py", "--arch", "olmoe-1b-7b", "--compress"], [
            (r"^olmoe-1b-7b: [\d.]+M params \(reduced config\)$", 1),
            (r"^step +\d+ loss \S+ \(top-5% compressed grads, [\d.]+s\)$",
             20)]),
}
#: 29(a)'s two waves: the LM examples need no kernel and start beside the
#: build; the NMF examples start with it and wait, at their first kernel,
#: on the build's lock of each library (``kernels/_build.py``)
LM_EXAMPLES = ("serving", "lm_training llama3.2-1b",
               "lm_training olmoe-1b-7b --compress")
NMF_EXAMPLES = ("quickstart", "pipeline", "pipeline --stream")
#: 29(b): the pipeline at the docstring's PubMed size, in this process
PIPELINE_ARGV = ["--terms", str(N_TERMS), "--docs", str(N_DOCS), "--iters",
                 "200"]


def example_runs(names, card_name):
    """Phase 29(a): the examples ``names`` one after another, each a
    subprocess run as its docstring runs it, on the card: exit 0, every
    line of :data:`EXAMPLE_RUNS`, no NaN or inf in what it printed, and the
    card (``card_name``) named.  Run beside untimed work only (the build
    and the train launchers).  Returns each one's seconds and output."""
    import shutil
    import tempfile

    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    out = {}
    for name in names:
        argv, lines = EXAMPLE_RUNS[name]
        ckpt = tempfile.mkdtemp(prefix="chip-smoke-example-")
        cmd = [sys.executable, str(repo / "examples" / argv[0]), *argv[1:]]
        if "pipeline" in name:
            cmd += ["--ckpt", ckpt]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=600)
        secs = time.perf_counter() - t0
        shutil.rmtree(ckpt, ignore_errors=True)
        if run.returncode != 0:
            raise AssertionError(f"example {name} exited {run.returncode}: "
                                 f"{run.stderr[-3000:]}")
        text = run.stdout.splitlines()
        for pattern, count in lines:
            got = sum(1 for ln in text if re.search(pattern, ln))
            if got < count:
                raise AssertionError(f"example {name} printed {got} lines "
                                     f"matching {pattern!r}, not {count}: "
                                     f"{run.stdout[-2000:]}")
        if re.search(r"\b(nan|inf)\b", run.stdout, re.IGNORECASE):
            raise AssertionError(f"example {name} printed a non-finite "
                                 f"number: {run.stdout[-2000:]}")
        if card_name not in run.stdout:
            raise AssertionError(f"example {name} does not name the card "
                                 f"{card_name!r}: {run.stdout[:500]}")
        out[name] = dict(seconds=secs, lines=len(text), stdout=run.stdout)
    return out


def _example(name):
    """The example script ``examples/<name>.py`` as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pipeline_launches(dev, a_sp, full_cover, new_sp, args, stream):
    """The kernel launches of the pipeline example's ``main`` worked out
    from the code: a fit of i iterations is 2 i + 1 ``bsr_spmm_gram`` (the
    +1 the streaming statistics' seed) and 2 i ``relu_topk``; a
    ``partial_fit`` pass (min(iters, 10) of them a chunk) two of each; each
    fused product adds one ``gram`` where its operand leaves a block of
    rows unreferenced (``kernels/fused.py``); a ``transform`` and a
    ``TopicServer`` tick one ``bsr_spmm`` and one ``relu_topk``.
    ``full_cover`` says whether A's two orientations (A: the documents'
    blocks, A^T: the terms') leave a block unreferenced."""
    from repro_torch.backend import get_backend

    be = get_backend("cuda-bsr")
    iters = args.iters // args.rounds
    passes = min(iters, 10)
    want = dict(bsr_spmm_gram=0, relu_topk=0, bsr_spmm=0, gram=0,
                project_mask=0)

    def add(n_iters, cover, seed=False):
        docs_gap, terms_gap = cover
        want["bsr_spmm_gram"] += 2 * n_iters + seed
        want["relu_topk"] += 2 * n_iters
        want["gram"] += n_iters * (docs_gap + terms_gap) + seed * docs_gap

    def cover(sub):
        ct = be.tile_config(*sub.shape, device=dev)
        terms, docs = chunk_coverage(sub.tocsr(), ct.bm, ct.bk)
        return (not docs.all(), not terms.all())

    if stream:
        cols = a_sp.tocsc()
        m = cols.shape[1]
        n_chunks = 2 * args.rounds
        w = -(-m // n_chunks)
        for i in range(n_chunks):
            add(passes, cover(cols[:, i * w:min((i + 1) * w, m)]))
        want["bsr_spmm"] += 1          # the transform of the corpus
        want["relu_topk"] += 1
    else:
        for _ in range(args.rounds):
            add(iters, full_cover, seed=True)
    ticks = -(-new_sp.shape[1] // 16)
    want["bsr_spmm"] += ticks
    want["relu_topk"] += ticks
    add(passes, cover(new_sp))        # the refresh: one partial_fit
    return want


def run_examples_slice(dev, a_sp, full_cover, smi, paths, results, lm_runs,
                       nmf_runs):
    """Phase 29: the port's examples.  (a) ``lm_runs`` / ``nmf_runs``, the
    futures of :func:`example_runs`, started beside the build; (b) the
    pipeline's ``main`` at PubMed size in this process, batch (resumed from
    a checkpoint of a known U, replayed on ``torch-dense``) and
    ``--stream``, its launches against :func:`pipeline_launches`."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch.backend import get_backend
    from repro_torch.checkpoint import (
        restore_nmf_factors_sparse, save_nmf_factors_sparse,
    )
    from repro_torch.core.nmf import init_u0
    from repro_torch.kernels import _build
    from repro_torch.nmf import EnforcedNMF

    t_phase = time.perf_counter()
    out = results["examples"] = {}
    pipe = _example("torch_topic_modeling_pipeline")
    args = pipe.parse_args(PIPELINE_ARGV)
    new_sp, _, _ = pipe.make_corpus(args.terms, pipe.NEW_DOCS, args.topics,
                                    seed=pipe.NEW_SEED)
    root = tempfile.mkdtemp(prefix="chip-smoke-pipeline-")

    def main(argv, stream):
        """The example's ``main`` at PubMed size with its launches read
        around it (and its printed lines kept)."""
        text = io.StringIO()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            got = pipe.main(PIPELINE_ARGV + argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _build.launch_counts()
        want = pipeline_launches(dev, a_sp, full_cover, new_sp, args, stream)
        for line in text.getvalue().splitlines():
            log(f"[pipeline]{' --stream' if stream else ''} {line}")
        differ = {k: (counts[k], v) for k, v in want.items()
                  if counts[k] != v}
        if differ:
            raise AssertionError(f"the pipeline's launches (got, worked out "
                                 f"from the code): {differ}")
        if not (got["answered"] == got["served"] == pipe.NEW_DOCS
                and got["refresh"]["folded"] == pipe.NEW_DOCS):
            raise AssertionError(f"the pipeline answered {got['answered']} "
                                 f"of {pipe.NEW_DOCS} requests and folded "
                                 f"{got['refresh']['folded']}")
        if not np.isfinite(got["accuracy"]):
            raise AssertionError("the pipeline's accuracy is not finite")
        log(f"[pipeline]{' --stream' if stream else ''} main({' '.join(argv)}"
            f") at PubMed size in {secs:.2f} s; stages "
            f"{ {k: round(v, 3) for k, v in got['stages'].items()} } s; "
            f"{got['served']} requests answered ({got['hits']} assigned a "
            f"topic) in {got['serve_s']:.3f} s, {got['refresh']['folded']} "
            f"folded back; launches {counts}, as worked out from the code")
        return got, dict(seconds=secs, launches=counts, stages=got["stages"])

    # -- (b) batch: resumed from a checkpoint of a known U --------------------
    gen = torch.Generator().manual_seed(29)
    u_known = init_u0(gen, args.terms, args.topics, device="cpu")
    v_known = init_u0(gen, args.docs, args.topics, device="cpu")
    batch_dir = str(Path(root) / "batch")
    save_nmf_factors_sparse(str(Path(batch_dir) / "factors.npz"), u_known,
                            v_known)
    got, out["batch"] = main(["--ckpt", batch_dir], False)
    paths["pipeline"] = out["batch"]["launches"]
    if not got["resumed"]:
        raise AssertionError("the pipeline did not resume from the seeded "
                             "checkpoint")
    # the same rounds on torch-dense from the same U: each round's final
    # error and residual within 1e-4 (the reference's trace bar), V within
    # 1e-4, U within 1e-4 of its largest entry (U is not normalized: phase
    # 13 holds a streamed fit's U so)
    t0 = time.perf_counter()
    dense_cfg = pipe.make_config(args).replace(backend="torch-dense")
    a_dense = get_backend("torch-dense").prepare(a_sp, device=dev)
    replay = EnforcedNMF(dense_cfg, device=dev)
    u0 = torch.clamp_min(u_known.to(dev), 0.0) + 1e-6
    traces = []
    for _ in range(args.rounds):
        replay.fit(a_dense, u0=u0)
        u0 = replay.u_
        traces.append((replay.result_.final_error,
                       replay.result_.final_residual))
    u_ck, v_ck = restore_nmf_factors_sparse(got["ckpt"], device=dev)
    du = float((u_ck - replay.u_).abs().max())
    dv = float((v_ck - replay.v_).abs().max())
    scale = float(replay.u_.abs().max())
    d_trace = max(max(abs(r["err"] - e), abs(r["resid"] - q))
                  for r, (e, q) in zip(got["rounds"], traces))
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    log(f"[pipeline] the checkpoint's factors against {args.rounds} rounds "
        f"of {dense_cfg.iters} iterations on torch-dense from the same U: "
        f"max abs diff U {du:.3e} ({du / scale:.3e} of max |U| "
        f"{scale:.4g}), V {dv:.3e}, each round's final error and residual "
        f"{d_trace:.3e} (bars 1e-4); NNZ(U) "
        f"{int((u_ck != 0).sum())} / {int((replay.u_ != 0).sum())}; replay "
        f"{replay_s:.2f} s")
    if du > 1e-4 * scale or dv > 1e-4 or d_trace > 1e-4:
        raise AssertionError(f"the pipeline's checkpoint differs from the "
                             f"torch-dense replay: U by {du:.3e} (max |U| "
                             f"{scale:.4g}), V by {dv:.3e}, the traces by "
                             f"{d_trace:.3e}")
    out["batch"].update(dense_diff_u=du, dense_diff_v=dv, u_max=scale,
                        dense_diff_trace=d_trace, replay_s=replay_s)
    del a_dense, replay, u0, u_ck, v_ck

    # -- (b) --stream ----------------------------------------------------------
    _, out["stream"] = main(["--stream", "--ckpt",
                             str(Path(root) / "stream")], True)
    paths["pipeline_stream"] = out["stream"]["launches"]
    shutil.rmtree(root, ignore_errors=True)
    out["b_seconds"] = time.perf_counter() - t_phase

    # -- (a) the examples as their docstrings run them ------------------------
    for runs in (lm_runs, nmf_runs):
        for name, r in runs.result().items():
            log(f"[examples] {name}: exit 0 in {r['seconds']:.1f} s, "
                f"{r['lines']} lines, every stage's line, finite, the card "
                f"named (beside the build); its last line: "
                f"{r['stdout'].splitlines()[-1]!r}")
            out.setdefault("runs", {})[name] = {
                k: v for k, v in r.items() if k != "stdout"}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[examples] phase 29 took {out['seconds']:.1f} s ((b) "
        f"{out['b_seconds']:.1f} s) on {smi}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    args = ap.parse_args(argv)
    t_script = time.perf_counter()

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

    from repro_torch.analysis import memory_guard
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
    clocks = results["phases"]["clock"] = {}

    def clock(label):
        """Seconds since the script started, at the start of ``label``
        (what each phase costs of the run's time limit)."""
        clocks[label] = time.perf_counter() - t_script
        log(f"[clock] {label} at {clocks[label]:.1f} s")

    # -- 21(c), 25(c): the train launcher in subprocesses ---------------------
    # Their smoke configs train on the plain path, which needs no kernel of
    # this build, so they run beside the build (a run's time limit), which
    # no metric reads, and end before the corpus is made: no timed window
    # shares the host with them.  Phases 21 and 25 report them.
    t_cli = time.perf_counter()
    train_cli = beside(launcher_kill_and_resume,
                       (LM_ARCH, MOE_ARCH, ENCDEC_ARCH), TRAIN["cli"], True)
    grid_cli = beside(launcher_across_grids, True)
    # -- 21(d) and 29(a): the compressed gradients' ranks and the LM
    # examples need no kernel either, and time nothing a metric reads
    compress = beside(compressed_grads_on_ranks, True, TRAIN["density"])
    card_name = torch.cuda.get_device_name(0)
    lm_examples = beside(example_runs, LM_EXAMPLES, card_name)
    # -- 28: the Wikipedia corpus, made beside the build and the launchers
    # (this thread only waits there), its padded SpCSR dropped at once;
    # then 28(c)'s command line, which makes its own (the two corpora's
    # peaks never share the host) and waits for this build's kernels
    wiki_corpus = beside(wikipedia_corpus)
    wiki_cli = beside(after, wiki_corpus, wikipedia_command_line, True)

    # -- 1. build ------------------------------------------------------------
    # a fresh build, so that ptxas reports every kernel of this checkout
    for source in _build.CSRC_DIR.glob("*.cu"):
        _build._target(source).unlink(missing_ok=True)
    # -- 17(f) and 29(a): the NMF command line's kill and resume and the NMF
    # examples, started with the build: each one's first kernel waits on
    # the build's lock of that library, taken below before any of them has
    # imported torch
    fault_cli = beside(command_line_kill_and_resume, True)
    nmf_examples = beside(example_runs, NMF_EXAMPLES, card_name)
    t0 = time.perf_counter()
    report = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, rep in report.items():
        log(f"[build] {name}.cu: {rep['seconds']:.2f} s")
        for line in rep["log"].splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "Compiling" in line):
                log(f"[build]   {line.strip()}")
    log(f"[build] CUDA sources built in {build_s:.2f} s (beside the train "
        "launcher's runs of 21(c) and 25(c))")
    results["phases"]["build_s"] = build_s
    beside_runs = {"the train launchers": train_cli,
                   "the grid launchers": grid_cli,
                   "the Wikipedia corpus": wiki_corpus,
                   "its command line": wiki_cli,
                   "21(d)'s ranks": compress, "17(f)'s command line": fault_cli,
                   "the LM examples": lm_examples,
                   "the NMF examples": nmf_examples}
    ends = {}
    for name, run in beside_runs.items():
        run.exception()
        ends[name] = time.perf_counter() - t_cli
    log(f"[build] the runs beside the build had all ended "
        f"{time.perf_counter() - t_cli:.1f} s after they started, "
        f"{time.perf_counter() - t0 - build_s:.1f} s after the build (each "
        f"joined at {', '.join(f'{n} {v:.1f} s' for n, v in ends.items())};"
        f" the Wikipedia corpus took {wiki_corpus.result()['seconds']:.1f}"
        f" s and its command line {wiki_cli.result()['seconds']:.1f} s)")
    results["phases"]["beside_build_s"] = dict(ends, build=build_s)

    # -- corpus and operand ---------------------------------------------------
    clock("phases 2-7")
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

    # the fit itself, on the already-ingested operand: one warm-up, whose
    # peak ``memory_guard`` reads (the arguments plus what the call added
    # to what was resident: phase 26's measured peak), then three timed
    # fits (host clock, ending in a synchronize)
    timed = EnforcedNMF(cfg, device=dev)
    fit_mem = memory_guard(timed.fit, op, u0=u0)
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
                  resident_before_fit_bytes=base_mem,
                  fit_guard_peak_bytes=fit_mem.peak_bytes,
                  fit_guard_argument_bytes=fit_mem.argument_bytes)
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
    clock("phases 8-11")
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
    clock("phase 12")
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
    clock("phases 13-16")
    keep = {}
    gram_k256 = run_stream_slice(dev, corpus, a_sp, op, model, new_sp, u0,
                                 paths, results, keep)
    # -- 17.-18. fault tolerance and the TopicServer ---------------------------
    clock("phases 17-18")
    t0 = time.perf_counter()
    run_fault_slice(dev, a_sp, op, model, u0, paths, results, keep,
                    fault_cli)
    run_topic_slice(dev, model, new_sp, paths, results)
    results["phases"]["fault_topic_s"] = time.perf_counter() - t0
    log(f"[fault] phases 17-18 took {results['phases']['fault_topic_s']:.1f} "
        "s")
    # -- 19. the mesh engines ------------------------------------------------
    clock("phase 19")
    run_mesh_slice(a_sp, res, u0, paths, results)
    # -- 20. the tile sweep, bf16, the fused half-step past k = 32 ---------
    clock("phase 20")
    run_tile_slice(dev, a_sp, op, res, u0, paths, results, rows)
    rows["gram"]["k_range"] = ("any k: one output tile up to k = 224, "
                               "128 x 128 tiles above")
    rows["gram"]["k256"] = {key: gram_k256[key] for key in
                            ("ms", "library_ms", "plain_ms", "bound_ms",
                             "bound_by")}
    # -- 21. the LM training half ------------------------------------------
    clock("phase 21")
    run_train_slice(dev, paths, results, train_cli, compress)
    # -- 22. the moe family: olmoe-1b-7b served, trained, expert-parallel ---
    clock("phase 22")
    run_moe_slice(dev, paths, results)
    # -- 23. the hybrid and ssm families: zamba2-7b and xlstm-125m ----------
    clock("phase 23")
    run_recurrent_slice(dev, paths, results, rows)
    # -- 24. the encdec family: seamless-m4t-large-v2 -----------------------
    clock("phase 24")
    run_encdec_slice(dev, paths, results, rows)
    # -- 25. parameter sharding over a 2x2 grid -----------------------------
    clock("phase 25")
    run_shard_slice(dev, paths, results, grid_cli)
    # -- 26. the dry-run on meta against phases 3/7, 9/11 and 25 -----------
    clock("phase 26")
    run_dryrun_slice(dev, op, u0, smi, paths, results, rows)
    # -- 27. the analyzer's runtime guards on the card -----------------------
    clock("phase 27")
    run_analysis_slice(dev, a_sp, op, u0, smi, results)
    # -- 28. the paper's Wikipedia configuration -----------------------------
    clock("phase 28")
    # whether A's orientations leave a block of rows unreferenced (the
    # pipeline's ingest of the same corpus is the same), for phase 29
    full_cover = (op.bsr.uncovered_rows is not None,
                  op.bsr_t.uncovered_rows is not None)
    del model, op
    run_wikipedia_slice(dev, wiki_corpus.result(), wiki_cli, smi, paths,
                        results, rows)

    # -- 29. the port's examples -------------------------------------------
    clock("phase 29")
    run_examples_slice(dev, a_sp, full_cover, smi, paths, results,
                       lm_examples, nmf_examples)

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
    clock("the end")
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
