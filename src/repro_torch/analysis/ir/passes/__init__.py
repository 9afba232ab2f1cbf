"""Registered IR passes.  Importing this package populates the registry —
:func:`repro_torch.analysis.ir.framework.all_ir_passes` does so lazily."""
from repro_torch.analysis.ir.passes import (  # noqa: F401
    collectives,
    dense_blowup,
    pallas_tiles,
    peak_memory,
)
