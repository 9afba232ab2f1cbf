"""Training of the LM substrate (port of ``repro.training``): AdamW and
top-k compressed data-parallel gradients with error feedback."""
from repro_torch.training.optimizer import AdamW, AdamState
from repro_torch.training.compression import (
    make_compressed_grad_fn, init_error_state, sparsify_tree,
)

__all__ = ["AdamW", "AdamState", "make_compressed_grad_fn",
           "init_error_state", "sparsify_tree"]
