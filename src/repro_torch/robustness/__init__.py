"""Fault tolerance for long fits (port of ``repro.robustness``).

* :mod:`repro_torch.robustness.snapshot` — :class:`FitCheckpointer`:
  periodic atomic snapshots with a config + data fingerprint, a resume that
  refuses a mismatched run, and the in-memory last good state a rollback
  returns to.
* :mod:`repro_torch.robustness.faults` — the deterministic fault-injection
  registry (fail a chunk load, corrupt a shard, NaN-poison a step, stop the
  prefetch worker, kill the process at a checkpoint commit).
* The engines carry a health index (the ``health`` of ``NMFResult`` /
  ``OnlineStepResult``): the first iteration whose factors went non-finite
  or whose residual exploded, ``-1`` when healthy, kept on the device.  The
  solver drivers read it at chunk and snapshot boundaries and roll back to
  the last snapshot with a reseeded perturbation instead of returning NaN
  topics.
"""
from repro_torch.robustness.faults import (
    Fault, InjectedFault, InjectedIOError, KILL_EXIT,
)
from repro_torch.robustness.snapshot import (
    CheckpointMismatchError, FitCheckpointer, FitHealthError,
    config_fingerprint, data_fingerprint,
)
from repro_torch.robustness import faults

__all__ = [
    "CheckpointMismatchError", "Fault", "FitCheckpointer", "FitHealthError",
    "InjectedFault", "InjectedIOError", "KILL_EXIT", "config_fingerprint",
    "data_fingerprint", "faults",
]
