"""Hand-written Hopper kernels of the port and their plain versions (port
of ``repro.kernels``; see ``ops.py``).  The LM substrate's flash attention
is ``kernels/flash_attention.py``."""
from repro_torch.kernels.ops import (
    BSR, BSROperand, bsr_from_dense, bsr_from_scipy, bsr_operand,
    bsr_to_dense, bsr_transpose, fused_project_mask, gram_matrix, spmm,
    spmm_gram, spmm_t, spmm_t_gram,
)

__all__ = ["BSR", "BSROperand", "bsr_from_dense", "bsr_from_scipy",
           "bsr_operand", "bsr_to_dense", "bsr_transpose",
           "fused_project_mask", "gram_matrix", "spmm", "spmm_gram",
           "spmm_t", "spmm_t_gram"]
