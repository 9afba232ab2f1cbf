"""Checkpoint store, the flat-dict and NMF-factor half (port of
``repro.checkpoint.store``).

* **Atomicity** — a checkpoint is written to ``step_N.tmp/`` and renamed
  into place, so a crash mid-write never corrupts the newest checkpoint.
* **Restart** — :func:`latest_step` + :func:`load_checkpoint_arrays` resume
  from the newest complete checkpoint.
* **Layout** — the reference's: ``step_N/arrays.npz`` with keys ``a0``,
  ``a1``, … in the sorted order of the names, and ``step_N/manifest.json``
  with ``step``, ``names``, ``dtypes`` and ``meta``.  So either package
  reads the other's checkpoints.
* **NMF factors** — :func:`save_nmf_factors_sparse` stores U and V in the
  paper's compressed top-t form (flat indices + values), the reference's
  file format.

Tensors reach the host with ``.cpu()`` when they are saved, and nowhere
else.  The pytree half (``restore_checkpoint``, ``AsyncCheckpointer``),
which checkpoints an LM's parameters, is not ported.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["save_checkpoint", "latest_step", "load_checkpoint_arrays",
           "save_nmf_factors_sparse", "restore_nmf_factors_sparse"]


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(ckpt_dir: str, step: int, arrays: Dict[str, object],
                    meta: Optional[dict] = None) -> str:
    """Atomic save of a flat name -> array dict (tensors or numpy).
    ``meta`` is an optional JSON-serializable dict stored in the manifest:
    the channel for host scalars, histories and fingerprints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = sorted(arrays)
    payload = {f"a{i}": _host(arrays[name]) for i, name in enumerate(names)}
    dtypes = [str(a.dtype) for a in payload.values()]
    np.savez(os.path.join(tmp, "arrays.npz"), **payload)
    manifest = {"step": step, "names": names, "dtypes": dtypes}
    if meta is not None:
        manifest["meta"] = meta
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, ``None`` when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def load_checkpoint_arrays(ckpt_dir: str, step: int
                           ) -> Tuple[Dict[str, np.ndarray], Optional[dict]]:
    """Read a checkpoint as ``({name: np.ndarray}, meta)``."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"a{i}"] for i in range(len(data.files))]
    return dict(zip(manifest["names"], arrays)), manifest.get("meta")


def save_nmf_factors_sparse(path: str, u, v) -> Dict[str, int]:
    """Store U and V in top-t compressed form (flat indices, values); returns
    each stored array's bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out = {}
    for name, mat in (("u", u), ("v", v)):
        mat = _host(mat)
        idx = np.flatnonzero(mat)
        out[f"{name}_idx"] = idx.astype(np.int64)
        out[f"{name}_val"] = mat.ravel()[idx]
        out[f"{name}_shape"] = np.asarray(mat.shape)
    np.savez(path, **out)
    return {k: a.nbytes for k, a in out.items()}


def restore_nmf_factors_sparse(path: str, device: DeviceLike = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """U and V (float32) from :func:`save_nmf_factors_sparse`'s file, on
    ``device`` (the card unless the CPU is asked for)."""
    dev = resolve_device(device)
    with np.load(path) as d:
        mats = []
        for name in ("u", "v"):
            shape = tuple(int(s) for s in d[f"{name}_shape"])
            flat = np.zeros(int(np.prod(shape)), np.float32)
            flat[d[f"{name}_idx"]] = d[f"{name}_val"]
            mats.append(torch.from_numpy(flat.reshape(shape)).to(dev))
    return mats[0], mats[1]
