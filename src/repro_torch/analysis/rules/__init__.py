"""Built-in rules.  Importing this package registers every rule module;
:func:`repro_torch.analysis.framework.all_rules` does so lazily.

The reference's ``jit_cache``, ``donation`` and ``pallas_purity`` rules
are not ported: eager PyTorch has no ``jax.jit`` executable cache, no
buffer donation and no Pallas kernel body (the port's kernels are CUDA
C++ sources), so there is nothing for them to check."""
from repro_torch.analysis.rules import (  # noqa: F401
    exception_hygiene,
    no_densify,
    psum_axis,
)
