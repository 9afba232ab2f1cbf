"""Static-capacity padded-CSR sparse matrices (port of ``repro.sparse``)."""
from repro_torch.sparse.csr import (
    SpCSR, from_coo, from_scipy, spmm, spmm_t, to_dense, to_scipy,
)

__all__ = ["SpCSR", "from_coo", "from_scipy", "spmm", "spmm_t", "to_dense",
           "to_scipy"]
