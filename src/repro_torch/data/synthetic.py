"""Synthetic corpora statistically matched to the paper's datasets (port of
``repro.data.synthetic``).

Zipf-distributed term frequencies with a planted topic structure: each
"journal" owns a block of characteristic terms, and a document mixes its
journal's block with the global Zipf background.  The generator draws from
numpy's ``default_rng`` in the reference's exact order, so the port's corpus
is bitwise the reference's for the same seed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.data.textpipe import normalize_rows_by_nnz
from repro_torch.sparse.csr import SpCSR, from_coo

__all__ = ["synthetic_journal_corpus", "synthetic_corpus_matrix"]


def synthetic_journal_corpus(
    n_terms: int = 2000,
    n_docs: int = 1000,
    n_journals: int = 5,
    terms_per_doc: int = 60,
    topic_strength: float = 0.7,
    seed: int = 0,
    cap: int | None = None,
) -> Tuple[SpCSR, np.ndarray]:
    """Planted-cluster corpus.  Returns (A (terms x docs) on the CPU,
    doc_journal (m,))."""
    rng = np.random.default_rng(seed)
    doc_journal = rng.integers(0, n_journals, size=n_docs)
    block = n_terms // n_journals

    def zipf_weights(k: int) -> np.ndarray:
        w = 1.0 / np.arange(1, k + 1) ** 1.1
        return w / w.sum()

    bg_w = zipf_weights(n_terms)
    blk_w = zipf_weights(block)

    rows, cols, vals = [], [], []
    for j in range(n_docs):
        jl = doc_journal[j]
        n_topic = rng.binomial(terms_per_doc, topic_strength)
        topic_terms = jl * block + rng.choice(block, size=n_topic, p=blk_w)
        bg_terms = rng.choice(n_terms, size=terms_per_doc - n_topic, p=bg_w)
        terms, counts = np.unique(
            np.concatenate([topic_terms, bg_terms]), return_counts=True)
        rows.append(terms)
        cols.append(np.full(len(terms), j, np.int64))
        vals.append(counts.astype(np.float32))

    a = from_coo(
        np.concatenate(rows).astype(np.int64),
        np.concatenate(cols),
        np.concatenate(vals),
        (n_terms, n_docs),
        cap=cap,
    )
    return normalize_rows_by_nnz(a), doc_journal


def synthetic_corpus_matrix(
    n_terms: int = 6424,
    n_docs: int = 1985,
    seed: int = 0,
    cap: int | None = None,
) -> SpCSR:
    """Reuters-scale synthetic matrix (paper §3.1 uses 6424 x 1985)."""
    a, _ = synthetic_journal_corpus(
        n_terms=n_terms, n_docs=n_docs, n_journals=5, seed=seed, cap=cap)
    return a
