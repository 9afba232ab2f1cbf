"""Quickstart of the PyTorch/CUDA port: enforced-sparsity NMF topic model.

    PYTHONPATH=src python examples/torch_quickstart.py             # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.core.metrics import mean_clustering_accuracy
from repro_torch.data import synthetic_journal_corpus
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
from repro_torch.sparse import to_scipy

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default=None,
                help="'cuda' (the default) or 'cpu' (plain versions)")
args = ap.parse_args()

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
print(f"device                : {model.device}")
print(f"final relative error  : {res.final_error:.4f}")
print(f"NNZ(U)={res.final_nnz_u}  NNZ(V)={res.final_nnz_v}  "
      f"max stored={int(res.max_nnz)} "
      f"(dense would be {(a.shape[0] + a.shape[1]) * 5})")

# 3. cluster quality against the planted journals (paper Eq. 3.3)
acc = mean_clustering_accuracy(torch.from_numpy(doc_journal).to(model.device),
                               model.v_, 5)
print(f"clustering accuracy   : {float(acc):.3f}")

# 4. fold in documents the model has never seen (topic inference, U frozen)
a_new, _ = synthetic_journal_corpus(
    n_terms=2000, n_docs=100, n_journals=5, seed=7)
v_new = model.transform(to_scipy(a_new))
print(f"fold-in               : {v_new.shape[0]} new docs -> topics "
      f"{torch.argmax(v_new, dim=1)[:10].tolist()} ...")
