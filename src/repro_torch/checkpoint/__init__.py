"""Checkpoints of the port (port of ``repro.checkpoint``): atomic
step-indexed snapshots in the reference's on-disk layout, of a flat dict
(the NMF fits) or of a parameter tree (an LM and its optimizer state, also
written asynchronously), and the compressed top-t factor files."""
from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    latest_step,
    load_checkpoint_arrays,
    restore_checkpoint,
    restore_nmf_factors_sparse,
    save_checkpoint,
    save_nmf_factors_sparse,
)

__all__ = [
    "save_checkpoint",
    "latest_step",
    "load_checkpoint_arrays",
    "restore_checkpoint",
    "AsyncCheckpointer",
    "save_nmf_factors_sparse",
    "restore_nmf_factors_sparse",
]
