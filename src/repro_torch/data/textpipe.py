"""Row normalization of the term/document matrix (port of
``repro.data.textpipe``; ``tokenize`` and ``build_term_document_matrix``
are not ported yet).  Each row is divided by its NNZ to de-bias common
terms (paper §3)."""
from __future__ import annotations

import torch

from repro_torch.sparse.csr import SpCSR

__all__ = ["normalize_rows_by_nnz"]


def normalize_rows_by_nnz(a: SpCSR) -> SpCSR:
    """Divide each row by its NNZ (paper §3: de-bias common terms)."""
    row_nnz = torch.clamp_min(
        torch.sum(a.values != 0, dim=1, keepdim=True), 1)
    return SpCSR(a.values / row_nnz, a.cols, a.shape)
