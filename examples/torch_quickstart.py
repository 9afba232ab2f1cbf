"""Quickstart of the PyTorch/CUDA port: enforced-sparsity NMF topic model
(the port of ``examples/quickstart.py``, line for line, with the card named).

    PYTHONPATH=src python examples/torch_quickstart.py             # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The corpus goes to the estimator as a scipy matrix (``to_scipy(a)``), which
the port ingests for ``cuda-bsr``: the hand-written BSR kernels and the
fused ``relu_topk`` epilogue.  A padded-CSR ``SpCSR`` would keep its format
(``torch-csr``, as the reference's ``jnp-csr``), which launches none of
them.  The first U is the port's seeded draw (``torch.Generator``), not
the reference's ``jax.random`` one, so the numbers differ from the
reference's run; the lines are the same.
"""
import argparse

import torch

from repro_torch.core.metrics import mean_clustering_accuracy
from repro_torch.data import synthetic_journal_corpus
from repro_torch.device import device_name
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
from repro_torch.sparse import to_scipy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' (plain versions)")
    args = ap.parse_args(argv)

    # 1. a corpus: 2000 terms x 1000 docs with 5 planted "journals"
    a, doc_journal = synthetic_journal_corpus(
        n_terms=2000, n_docs=1000, n_journals=5, seed=0)
    print(f"term/document matrix: {a.shape}, nnz={int(a.nnz())}")

    # 2. five-topic NMF with the paper's Algorithm 2 on the BSR kernel path
    model = EnforcedNMF(NMFConfig(k=5, iters=50, solver="enforced",
                                  sparsity=Sparsity(t_u=55, t_v=2000)),
                        device=args.device)
    model.fit(to_scipy(a))
    res = model.result_
    print(f"device                : {device_name(model.device)}")
    print(f"final relative error  : {res.final_error:.4f}")
    print(f"final residual        : {res.final_residual:.2e}")
    print(f"NNZ(U)={res.final_nnz_u}  NNZ(V)={res.final_nnz_v}  "
          f"max stored={int(res.max_nnz)} "
          f"(dense would be {(a.shape[0] + a.shape[1]) * 5})")

    # 3. cluster quality against the planted journals (paper Eq. 3.3)
    acc = mean_clustering_accuracy(
        torch.from_numpy(doc_journal).to(model.device), model.v_, 5)
    print(f"clustering accuracy   : {float(acc):.3f}")

    # 4. fold in documents the model has never seen (topic inference,
    #    U frozen)
    a_new, _ = synthetic_journal_corpus(
        n_terms=2000, n_docs=100, n_journals=5, seed=7)
    v_new = model.transform(to_scipy(a_new))
    fold = torch.argmax(v_new, dim=1)[:10].tolist()
    print(f"fold-in               : {v_new.shape[0]} new docs -> topics "
          f"{fold} ...")

    # 5. top terms per topic (indices: a real corpus maps these to words)
    topics = []
    for topic in range(5):
        col = model.u_[:, topic]
        top = torch.argsort(-col)[:5].tolist()
        weights = [round(float(col[i]), 3) for i in top]
        topics.append((top, weights))
        print(f"topic {topic}: terms {top} (weights {weights})")
    return dict(device=device_name(model.device), nnz=int(a.nnz()),
                final_error=res.final_error,
                final_residual=res.final_residual,
                nnz_u=res.final_nnz_u, nnz_v=res.final_nnz_v,
                max_nnz=int(res.max_nnz), accuracy=float(acc),
                fold_in=fold, topics=topics)


if __name__ == "__main__":
    main()
