"""End-to-end pipeline of the PyTorch/CUDA port (the port of
``examples/topic_modeling_pipeline.py``): corpus -> term/document matrix ->
enforced-sparsity ALS through ``EnforcedNMF``, with compressed-sparse
checkpoints and restart, or a ``partial_fit`` stream, then evaluation and
topic serving through the micro-batching ``TopicServer``.

    PYTHONPATH=src python examples/torch_topic_modeling_pipeline.py \\
        [--terms 20112 --docs 7510 --iters 200 --ckpt /tmp/nmf_ckpt] \\
        [--stream]   # fit by mini-batch partial_fit instead of full-batch
    PYTHONPATH=src python examples/torch_topic_modeling_pipeline.py --device cpu

It runs on the card unless ``--device cpu`` is given (the kernels' plain
versions); without a card and without that flag it raises.

Where it departs from the reference, and why:

* The estimator is configured with ``backend="cuda-bsr"``.  The reference
  hands its padded-CSR matrix to an estimator with no backend, which keeps
  the matrix in its format (``jnp-csr``); here that format is ``torch-csr``,
  which launches none of the hand-written kernels and takes ~0.4 s an
  iteration at PubMed size.  A is ingested for ``cuda-bsr`` once (stage 1)
  and every round's fit, the fold-in and the stream's ``transform`` read
  that one operand.
* ``--stream`` hands each chunk to ``partial_fit`` as a column slice of the
  scipy matrix, which the ``cuda-bsr`` ingest takes as it is; the reference
  builds a padded-CSR chunk from it first.
* A serving request's ``(term, weight)`` pairs are read off the new
  corpus's stored entries (scipy CSC), not off a dense copy: the same pairs
  in the same order.
* The default ``--ckpt`` is ``/tmp/nmf_pipeline_ckpt_torch``, so that a run
  never resumes from the reference's checkpoint by accident.  The file
  format is the reference's: a checkpoint written by either package resumes
  in the other (``--ckpt`` pointing at it).
* A fresh run's first U is the port's seeded draw (``torch.Generator``);
  the reference draws it from ``jax.random``.  From the same checkpoint both
  packages resume from the same U.

Each stage is a function of its inputs (a first U, the matrix, the model),
so that a caller can hand both packages the same ones.  ``main(argv)``
returns what it printed.
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.backend import get_backend
from repro_torch.checkpoint import (
    restore_nmf_factors_sparse, save_nmf_factors_sparse,
)
from repro_torch.core.metrics import mean_clustering_accuracy
from repro_torch.data import synthetic_journal_corpus
from repro_torch.device import device_name, resolve_device, synchronize
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
from repro_torch.serving import TopicRequest, TopicServer
from repro_torch.sparse import to_scipy

#: the backend of every fit, fold-in and stream chunk (see the docstring)
BACKEND = "cuda-bsr"
#: new documents served in stage 4, and the seed of their corpus
NEW_DOCS, NEW_SEED = 64, 123


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--terms", type=int, default=4000)
    ap.add_argument("--docs", type=int, default=1500)
    ap.add_argument("--topics", type=int, default=5)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=4,
                    help="checkpoint rounds (iters split across them)")
    ap.add_argument("--t-u", type=int, default=500)
    ap.add_argument("--t-v", type=int, default=3000)
    ap.add_argument("--stream", action="store_true",
                    help="fit with streaming partial_fit over doc chunks")
    ap.add_argument("--ckpt", default="/tmp/nmf_pipeline_ckpt_torch")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' (plain versions)")
    return ap.parse_args(argv)


def make_config(args) -> NMFConfig:
    return NMFConfig(k=args.topics, iters=args.iters // args.rounds,
                     sparsity=Sparsity(t_u=args.t_u, t_v=args.t_v),
                     backend=BACKEND)


def make_corpus(terms: int, docs: int, topics: int, seed: int = 0):
    """The synthetic corpus (bitwise the reference's) as a scipy CSR
    matrix, the planted journals and the stored-entry count."""
    a, dj = synthetic_journal_corpus(n_terms=terms, n_docs=docs,
                                     n_journals=topics, seed=seed)
    return to_scipy(a), dj, int(a.nnz())


def ingest(a_sp, device):
    """A, ingested once for ``cuda-bsr`` on ``device``."""
    return get_backend(BACKEND).prepare(a_sp, device=device)


def resume_u0(ck_path: str, device):
    """The first U of a resumed run, ``relu(U) + 1e-6`` of the
    checkpoint's U; None when there is no checkpoint."""
    if not os.path.exists(ck_path):
        return None
    u, _ = restore_nmf_factors_sparse(ck_path, device=device)
    return torch.clamp_min(u, 0.0) + 1e-6


def fit_rounds(model: EnforcedNMF, op, rounds: int, ck_path: str, u0=None):
    """``rounds`` fits, each from the previous round's U (the first from
    ``u0``, None for the seeded default), each saved to ``ck_path`` in
    compressed-sparse form; one record a round."""
    out = []
    for rnd in range(rounds):
        t0 = time.perf_counter()
        model.fit(op, u0=u0)
        synchronize(model.device)
        sizes = save_nmf_factors_sparse(ck_path, model.u_, model.v_)
        u0 = model.u_
        res = model.result_
        rec = dict(err=res.final_error, resid=res.final_residual,
                   nnz_u=res.final_nnz_u, ckpt_kb=sum(sizes.values()) // 1024,
                   seconds=time.perf_counter() - t0)
        print(f"   round {rnd + 1}/{rounds}: err={rec['err']:.4f} "
              f"resid={rec['resid']:.2e} nnz(U)={rec['nnz_u']} "
              f"ckpt={rec['ckpt_kb']}KB ({rec['seconds']:.1f}s)")
        out.append(rec)
    return out


def stream_fit(model: EnforcedNMF, a_sp, rounds: int, u0=None,
               on_chunk=None):
    """``2 * rounds`` calls of ``partial_fit``, one a slice of the
    document columns of ``a_sp`` (scipy; each chunk ingested on its way in,
    one chunk resident at a time).  ``u0`` sets the first U (None: the
    seeded default at the first chunk); ``on_chunk(i, model)`` runs after
    each chunk.  One record a chunk."""
    a_cols = a_sp.tocsc()
    docs = a_cols.shape[1]
    if u0 is not None:
        model.u_ = torch.as_tensor(u0, dtype=torch.float32).to(
            model.device).contiguous()
        model.n_features_ = model.u_.shape[0]
    n_chunks = rounds * 2
    chunk_w = -(-docs // n_chunks)
    out = []
    for i in range(n_chunks):
        t0 = time.perf_counter()
        chunk = a_cols[:, i * chunk_w:min((i + 1) * chunk_w, docs)]
        model.partial_fit(chunk)
        synchronize(model.device)
        rec = dict(docs=chunk.shape[1], seen=model.n_docs_seen_,
                   seconds=time.perf_counter() - t0)
        print(f"   chunk {i + 1}/{n_chunks} ({rec['docs']} docs): stream "
              f"total {rec['seen']} docs ({rec['seconds']:.1f}s)")
        if on_chunk is not None:
            on_chunk(i, model)
        out.append(rec)
    return out


def evaluate(model: EnforcedNMF, v_full, dj, topics: int):
    """Stage 3: Eq. 3.3 accuracy and the stored entries against dense."""
    acc = float(mean_clustering_accuracy(
        torch.from_numpy(np.asarray(dj)).to(v_full.device), v_full, topics))
    print(f"   clustering accuracy (Eq. 3.3): {acc:.3f}")
    stored = int((model.u_ != 0).sum()) + int((v_full != 0).sum())
    dense = (model.u_.shape[0] + v_full.shape[0]) * topics
    print(f"   memory: stored NNZ {stored} vs dense {dense} "
          f"({dense / max(stored, 1):.1f}x saving)")
    return dict(accuracy=acc, stored=stored, dense=dense)


def requests_for(a_new_sp, top: int = 1):
    """One ``TopicRequest`` a document (column) of ``a_new_sp``: its
    stored nonzero entries as ``(term, weight)`` pairs, in term order."""
    cols = a_new_sp.tocsc()
    cols.sum_duplicates()
    cols.sort_indices()
    reqs = []
    for rid in range(cols.shape[1]):
        lo, hi = cols.indptr[rid], cols.indptr[rid + 1]
        terms = [(int(i), float(v)) for i, v in
                 zip(cols.indices[lo:hi], cols.data[lo:hi]) if v != 0]
        reqs.append(TopicRequest(rid=rid, terms=terms, top=top))
    return reqs


def serve(model: EnforcedNMF, requests, max_batch: int = 16):
    """Stage 4: the requests through a ``TopicServer`` until drained."""
    server = TopicServer(model, max_batch=max_batch)
    for req in requests:
        server.submit(req)
    t0 = time.perf_counter()
    done = server.run_until_drained()
    synchronize(model.device)
    dt = time.perf_counter() - t0
    hits = sum(1 for req in done if req.topics)
    print(f"   served {server.served} docs in {dt:.2f}s "
          f"({server.served / max(dt, 1e-9):.0f} docs/s)")
    print(f"   {hits}/{len(done)} documents assigned a topic")
    return server, done, dict(served=server.served, serve_s=dt, hits=hits,
                              answered=len(done))


def refresh(server: TopicServer):
    """Stage 5: the served documents folded back with ``partial_fit``."""
    t0 = time.perf_counter()
    folded = server.refresh()
    synchronize(server.estimator.device)
    dt = time.perf_counter() - t0
    print(f"   folded {folded} served docs back into the model in {dt:.2f}s "
          f"(total docs seen: {server.estimator.n_docs_seen_})")
    return dict(folded=folded, seconds=dt,
                docs_seen=server.estimator.n_docs_seen_)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    out = dict(device=device_name(device), stream=args.stream, stages={})
    print(f"device: {out['device']}")

    print("== stage 1: corpus -> matrix ==")
    t0 = time.perf_counter()
    a_sp, dj, nnz = make_corpus(args.terms, args.docs, args.topics)
    op = ingest(a_sp, device)
    synchronize(device)
    out.update(shape=a_sp.shape, nnz=nnz)
    out["stages"]["corpus"] = time.perf_counter() - t0
    print(f"   {a_sp.shape[0]}x{a_sp.shape[1]}, nnz={nnz} "
          f"({out['stages']['corpus']:.1f}s)")

    model = EnforcedNMF(make_config(args), device=device)
    os.makedirs(args.ckpt, exist_ok=True)
    ck_path = os.path.join(args.ckpt, "factors.npz")
    out["ckpt"] = ck_path

    t0 = time.perf_counter()
    if args.stream:
        print("== stage 2: streaming partial_fit over document chunks ==")
        out["chunks"] = stream_fit(model, a_sp, args.rounds)
        v_full = model.transform(op)
        sizes = save_nmf_factors_sparse(ck_path, model.u_, v_full)
        out["ckpt_kb"] = sum(sizes.values()) // 1024
        print(f"   ckpt={out['ckpt_kb']}KB")
    else:
        print("== stage 2: enforced-sparsity ALS with checkpoint/restart ==")
        u0 = resume_u0(ck_path, device)
        out["resumed"] = u0 is not None
        if u0 is not None:
            print(f"   resuming from {ck_path}")
        out["rounds"] = fit_rounds(model, op, args.rounds, ck_path, u0)
        v_full = model.v_
    out["stages"]["fit"] = time.perf_counter() - t0

    print("== stage 3: evaluation ==")
    t0 = time.perf_counter()
    out.update(evaluate(model, v_full, dj, args.topics))
    out["stages"]["evaluate"] = time.perf_counter() - t0

    print("== stage 4: topic serving (fold-in of unseen documents) ==")
    t0 = time.perf_counter()
    a_new, _, _ = make_corpus(args.terms, NEW_DOCS, args.topics,
                              seed=NEW_SEED)
    server, done, served = serve(model, requests_for(a_new))
    out.update(served)
    out["topics"] = {req.rid: req.topics for req in done}
    out["stages"]["serve"] = time.perf_counter() - t0

    print("== stage 5: continuous refresh (served docs -> partial_fit) ==")
    t0 = time.perf_counter()
    out["refresh"] = refresh(server)
    out["stages"]["refresh"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    main()
