"""Corpus inputs of the port (port of ``repro.data``, first slice)."""
from repro_torch.data.synthetic import (
    synthetic_corpus_matrix, synthetic_journal_corpus,
)
from repro_torch.data.textpipe import normalize_rows_by_nnz

__all__ = ["normalize_rows_by_nnz", "synthetic_corpus_matrix",
           "synthetic_journal_corpus"]
