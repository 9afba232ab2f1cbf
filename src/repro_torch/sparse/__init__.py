"""Static-capacity padded-CSR sparse matrices (port of ``repro.sparse``)."""
from repro_torch.sparse.csr import (
    ColumnSlicer, SpCSR, column_block, from_coo, from_dense, from_scipy, spmm,
    spmm_chunked, spmm_t, spmm_t_chunked, to_dense, to_scipy,
)

__all__ = ["ColumnSlicer", "SpCSR", "column_block", "from_coo", "from_dense",
           "from_scipy", "spmm", "spmm_chunked", "spmm_t", "spmm_t_chunked",
           "to_dense", "to_scipy"]
