"""PyTorch/CUDA port of the enforced-sparse NMF system.

A second package beside the JAX reference (``repro``), mirroring it module
for module: ``repro_torch.kernels.fused`` is the counterpart of
``repro.kernels.fused`` and so on.  The Pallas TPU kernels are hand-written
for Hopper (``sm_90a``) in CUDA C++: the BSR products and the Gram
(``csrc/bsr_spmm.cu``, ``csrc/gram.cu``), the relu + top-t epilogue with
its bisection threshold (``csrc/project_mask.cu``), and the LM substrate's
flash attention (``csrc/flash_attention.cu``; bf16 on the tensor cores with
wgmma and TMA, f32 on the CUDA cores), which the serving path's prefill runs
(``models/``, ``serving/``, ``launch/serve.py``).
On CPU tensors every kernel wrapper runs its plain PyTorch version instead
(``kernels/ref.py``), which is how the CPU test suite holds the port against
the reference.

Entry points run on the card unless the caller asks for the CPU::

    from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity

    model = EnforcedNMF(NMFConfig(k=5, sparsity=Sparsity(t_u=2011, t_v=751)))
    model.fit(scipy_term_document_matrix)       # device="cuda" by default

This package never imports ``jax`` or the reference package.
"""
from repro_torch.device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
