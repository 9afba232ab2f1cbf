"""Dense baseline backend, ``torch-dense`` (port of the ``jnp-dense`` half
of ``repro.backend.jnp_backends``).  Products by ``torch.matmul``, which the
reference left to XLA too; this is the oracle and small-matrix baseline,
not a kernel of the port.  Its epilogue is the port's one-launch
``relu_topk`` (the reference's unfused relu + bisection gives the same
factors).  The padded-CSR backend, with the reference's unfused
epilogue, is ``torch-csr`` (``backend/csr.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend.base import LocalExecution, register_backend
from repro_torch.device import resolve_device
from repro_torch.sparse.csr import SpCSR, to_dense


class TorchDenseBackend(LocalExecution):
    """Dense products on a dense tensor operand."""

    name = "torch-dense"
    fuse_epilogue = True

    def accepts(self, a) -> bool:
        return isinstance(a, torch.Tensor)

    def prepare(self, a, dtype=None, device=None):
        device = resolve_device(device)
        if isinstance(a, SpCSR):
            a = to_dense(a)  # repro: allow[no-densify] this IS the dense backend — densifying is its contract
        elif hasattr(a, "toarray"):  # scipy sparse, an explicitly dense ask
            a = torch.from_numpy(np.asarray(a.toarray()))  # repro: allow[no-densify] dense backend ingest boundary; the caller chose torch-dense
        elif not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a))
        return a.to(device=device, dtype=dtype)

    def matmul(self, a, v):
        return a @ v

    def matmul_t(self, a, u):
        return a.T @ u

    def gram(self, x):
        return x.T @ x


register_backend(TorchDenseBackend(), aliases=("jnp-dense",))
