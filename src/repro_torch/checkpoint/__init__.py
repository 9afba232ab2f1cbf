"""Checkpoints of the port (port of ``repro.checkpoint``, its flat-dict and
NMF-factor half): atomic step-indexed snapshots in the reference's on-disk
layout, and the compressed top-t factor files."""
from repro_torch.checkpoint.store import (
    latest_step,
    load_checkpoint_arrays,
    restore_nmf_factors_sparse,
    save_checkpoint,
    save_nmf_factors_sparse,
)

__all__ = [
    "save_checkpoint",
    "latest_step",
    "load_checkpoint_arrays",
    "save_nmf_factors_sparse",
    "restore_nmf_factors_sparse",
]
