"""Text -> term/document matrix pipeline (port of ``repro.data.textpipe``,
paper §3).

Each column of A is a document, each row a term; ``a_ij`` is the count of
term i in document j.  Terms on the stop-word list and terms occurring
fewer than ``min_count`` times in the corpus are dropped, and each row is
divided by its NNZ to de-bias common terms.  Tokenizing and packing are
host work, step for step the reference's, so the vocabulary and the packed
arrays are identical to its.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sparse.csr import SpCSR, from_coo

__all__ = ["STOPWORDS", "tokenize", "build_term_document_matrix",
           "normalize_rows_by_nnz"]

#: the reference's compact English stop-word list (the paper uses "a stop
#: word list")
STOPWORDS = frozenset(
    """a about above after again against all am an and any are as at be because
    been before being below between both but by could did do does doing down
    during each few for from further had has have having he her here hers him
    his how i if in into is it its just me more most my no nor not of off on
    once only or other our out over own same she should so some such than that
    the their them then there these they this those through to too under until
    up very was we were what when where which while who whom why will with you
    your said say says would also may can one two new us mr mrs""".split()
)

_TOKEN_RE = re.compile(r"[a-z][a-z'-]+")


def tokenize(text: str) -> List[str]:
    """Lower-cased word tokens of ``text`` without the stop words."""
    return [t for t in _TOKEN_RE.findall(text.lower()) if t not in STOPWORDS]


def build_term_document_matrix(
    documents: Sequence[str],
    min_count: int = 2,
    cap: int | None = None,
) -> Tuple[SpCSR, Dict[str, int]]:
    """The (terms x documents) count matrix as padded CSR on the CPU, rows
    normalized by their NNZ, and the vocabulary (term -> row index, terms in
    sorted order).  Terms seen fewer than ``min_count`` times are dropped."""
    tokenized = [tokenize(d) for d in documents]
    corpus_counts: Counter = Counter()
    for toks in tokenized:
        corpus_counts.update(toks)
    vocab = {
        t: i
        for i, (t, c) in enumerate(
            sorted((t, c) for t, c in corpus_counts.items() if c >= min_count)
        )
    }
    rows, cols, vals = [], [], []
    for j, toks in enumerate(tokenized):
        counts = Counter(t for t in toks if t in vocab)
        for t, c in counts.items():
            rows.append(vocab[t])
            cols.append(j)
            vals.append(float(c))
    n, m = len(vocab), len(documents)
    a = from_coo(
        np.array(rows, np.int64),
        np.array(cols, np.int64),
        np.array(vals, np.float32),
        (n, m),
        cap=cap,
    )
    return normalize_rows_by_nnz(a), vocab


def normalize_rows_by_nnz(a: SpCSR) -> SpCSR:
    """Divide each row by its NNZ (paper §3: de-bias common terms)."""
    row_nnz = torch.clamp_min(
        torch.sum(a.values != 0, dim=1, keepdim=True), 1)
    return SpCSR(a.values / row_nnz, a.cols, a.shape)
