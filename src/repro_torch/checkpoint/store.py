"""Checkpoint store (port of ``repro.checkpoint.store``): atomic
step-indexed snapshots of a flat dict (the NMF fits) or of a parameter tree
(an LM's parameters and ``AdamState``), and the compressed NMF factors.

* **Atomicity** — a checkpoint is written to ``step_N.tmp/`` and renamed
  into place, so a crash mid-write never corrupts the newest checkpoint.
* **Restart** — :func:`latest_step` + :func:`load_checkpoint_arrays` resume
  from the newest complete checkpoint.
* **Layout** — the reference's: ``step_N/arrays.npz`` with keys ``a0``,
  ``a1``, … in the order of the names, and ``step_N/manifest.json`` with
  ``step``, ``names``, ``dtypes`` and ``meta``; bf16 is stored as its
  uint16 bits.  A flat dict's names are its sorted keys.  A tree's names
  and order are those of the reference's ``_flatten_with_names`` for the
  same tree in the reference's form: a tuple's items are ``0``, ``1``, …,
  a ``NamedTuple``'s fields ``.step``, ``.mu``, …, a dict's keys sorted,
  a list's items ``0``, ``1``, … in order, and a model's parameters (an
  ``nn.Module``, or a dict keyed by its ``named_parameters``, as
  ``AdamState.mu``) in the reference's layout of the model's family
  (``repro_torch.layout``; the family is read from the first model in
  the tree, the dense layout without one): ``layers.<i>.attn.wq`` is row
  i of the leaf ``layers/attn/wq``, a hybrid's ``groups.<g>.<e>.in_proj``
  row (g, e) of ``groups/in_proj``.  So either package restores the
  other's checkpoints.
* **NMF factors** — :func:`save_nmf_factors_sparse` stores U and V in the
  paper's compressed top-t form (flat indices + values), the reference's
  file format.

Tensors reach the host when they are saved, and nowhere else.
:func:`restore_checkpoint` copies into the tensors of ``like`` in place (on
their devices) and returns ``like``.  :class:`AsyncCheckpointer` copies to
the host on the caller and writes on a daemon thread.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layout import family_of, reference_leaf

__all__ = ["save_checkpoint", "latest_step", "load_checkpoint_arrays",
           "restore_checkpoint", "AsyncCheckpointer",
           "save_nmf_factors_sparse", "restore_nmf_factors_sparse"]


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array (a bf16 tensor as its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _owned(x) -> np.ndarray:
    """A host copy of ``x`` that nothing else writes (a CPU tensor's numpy
    view shares its memory; a card's tensor is copied by the move)."""
    a = _host(x)
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return a
    return np.array(a)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=x.dtype).numpy().dtype)
    return str(np.asarray(x).dtype)


def _is_flat(tree) -> bool:
    return isinstance(tree, Mapping) and not any(
        isinstance(v, (Mapping, tuple, list, nn.Module))
        for v in tree.values())


#: a leaf: its path, its tensors (the rows of a stacked leaf in order) and
#: the stacked axes' sizes (``()`` for a leaf that is not stacked)
Leaf = Tuple[Tuple[str, ...], list, Tuple[int, ...]]


def _order(leaf: Leaf):
    """The reference's flatten order: dict keys sorted, list items by
    index."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in leaf[0])


def _param_leaves(named: Mapping[str, Any], prefix: Tuple[str, ...],
                  family: Optional[str]) -> List[Leaf]:
    """A model's parameters (keyed by ``named_parameters``) as the
    reference's leaves of ``family``, in its order."""
    rows: Dict[Tuple[str, ...], Dict[Tuple[int, ...], Any]] = {}
    for name, t in named.items():
        path, index = reference_leaf(name, family)
        rows.setdefault(prefix + path, {})[index] = t
    out = []
    for path, by_index in rows.items():
        rank = len(next(iter(by_index)))
        shape = tuple(1 + max(i[a] for i in by_index) for a in range(rank))
        want = list(itertools.product(*map(range, shape)))
        if sorted(by_index) != want:
            raise ValueError(f"{'/'.join(path)}: rows {sorted(by_index)} do "
                             f"not fill a stack of {shape}")
        out.append((path, [by_index[i] for i in want], shape))
    return sorted(out, key=_order)


def _tree_leaves(tree, prefix: Tuple[str, ...] = (),
                 family: Optional[str] = None) -> List[Leaf]:
    """Every leaf of ``tree`` in the reference's flatten order, a model's
    parameters in ``family``'s layout."""
    if isinstance(tree, nn.Module):
        return _param_leaves(dict(tree.named_parameters()), prefix, family)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for f in tree._fields
                for leaf in _tree_leaves(getattr(tree, f),
                                         prefix + ("." + f,), family)]
    if isinstance(tree, (tuple, list)):
        return [leaf for i, sub in enumerate(tree)
                for leaf in _tree_leaves(sub, prefix + (str(i),), family)]
    if _is_flat(tree):
        return _param_leaves(tree, prefix, family)
    if isinstance(tree, Mapping):
        return [leaf for key in sorted(tree)
                for leaf in _tree_leaves(tree[key], prefix + (str(key),),
                                         family)]
    return [(prefix, [tree], ())]


def _host_leaves(tree, family: Optional[str] = None
                 ) -> Tuple[List[str], List[np.ndarray], List[str]]:
    """Names, owned host arrays and dtype names of ``tree``'s leaves, a
    model's parameters in ``family``'s layout (by default the family of the
    first model in the tree)."""
    names, arrays, dtypes = [], [], []
    for path, parts, stk in _tree_leaves(tree,
                                         family=family or family_of(tree)):
        host = [_owned(t) for t in parts]
        names.append("/".join(path))
        arrays.append(np.stack(host).reshape(stk + host[0].shape) if stk
                      else host[0])
        dtypes.append(_dtype_name(parts[0]))
    return names, arrays, dtypes


def _write(ckpt_dir: str, step: int, names: List[str],
           arrays: List[np.ndarray], dtypes: List[str],
           meta: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, a in enumerate(arrays)})
    manifest = {"step": step, "names": names, "dtypes": dtypes}
    if meta is not None:
        manifest["meta"] = meta
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    meta: Optional[dict] = None) -> str:
    """Atomic save of a flat name -> array dict (tensors or numpy) or of a
    tree (see the module's layout).  ``meta`` is an optional
    JSON-serializable dict stored in the manifest: the channel for host
    scalars, histories and fingerprints."""
    names, arrays, dtypes = _host_leaves(tree)
    return _write(ckpt_dir, step, names, arrays, dtypes, meta)


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


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, step: int, like,
                       block: Optional[Callable[[torch.Tensor], tuple]] = None):
    """Copy the checkpoint at ``step`` into the tensors of ``like`` (a tree
    of the checkpoint's names, shapes and dtypes: a model and its
    ``AdamState`` as the reference's ``(params, opt_state)``), in place and
    on their devices, and return ``like``.  The leaves are read one at a
    time (the npz file's members load one by one), so the host holds at
    most one of them.  ``block(t)`` gives, for a tensor ``t`` of ``like``
    that holds a block of its row (a rank of a grid), ``(the row's whole
    shape, the block's index in it)``; without it each tensor takes its
    whole row.  Raises ``ValueError`` when the names, shapes or dtypes
    differ."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names = manifest["names"]
    dtypes = dict(zip(names, manifest["dtypes"]))
    key = {name: f"a{i}" for i, name in enumerate(names)}
    leaves = [("/".join(p), parts, stk)
              for p, parts, stk in _tree_leaves(like,
                                                family=family_of(like))]
    want = [name for name, _, _ in leaves]
    if set(want) != set(names):
        raise ValueError(
            f"checkpoint {path} does not match the tree: missing "
            f"{sorted(set(want) - set(names))}, unexpected "
            f"{sorted(set(names) - set(want))}")
    if block is None:
        def block(t):
            return tuple(t.shape), ()
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for name, parts, stk in leaves:
            if not all(isinstance(t, torch.Tensor) for t in parts):
                raise TypeError(f"{name}: restore_checkpoint fills tensors, "
                                f"got {type(parts[0]).__name__}")
            a = data[key[name]]
            if dtypes.get(name) == "bfloat16":
                src = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                src = torch.from_numpy(a)
            row = tuple(block(parts[0])[0])
            if tuple(src.shape) != stk + row or src.dtype != parts[0].dtype:
                raise ValueError(f"{name}: checkpoint holds "
                                 f"{tuple(src.shape)} {src.dtype}, the tree "
                                 f"{stk + row} {parts[0].dtype}")
            rows = src.reshape((-1,) + row)
            for i, t in enumerate(parts):
                t.copy_(rows[i][block(t)[1]])
            # nothing of this leaf outlives it: the next one is read alone
            del a, src, rows
    return like


class AsyncCheckpointer:
    """Overlaps the write with training: :meth:`save` copies the tree to
    the host on the caller (after the previous write has finished), then
    writes it on a daemon thread; :meth:`wait` joins the write in flight and
    raises what it raised.  ``stats`` counts saves and the seconds of the
    copy (caller) and of the write (thread)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.stats = {"saves": 0, "copy_s": 0.0, "write_s": 0.0}

    def save(self, step: int, tree, meta: Optional[dict] = None,
             family: Optional[str] = None) -> None:
        """Copy ``tree`` to the host and start its write.  ``family`` names
        the layout of a tree whose parameters are dicts keyed by
        ``named_parameters`` names (a sharded run's gathered state), where
        no model in it says."""
        self.wait()
        t0 = time.perf_counter()
        host = _host_leaves(tree, family)
        self.stats["copy_s"] += time.perf_counter() - t0
        self.stats["saves"] += 1
        self._thread = threading.Thread(target=self._run,
                                        args=(step, host, meta), daemon=True)
        self._thread.start()

    def _run(self, step, host, meta) -> None:
        t0 = time.perf_counter()
        try:
            _write(self.ckpt_dir, step, *host, meta)
        except BaseException as exc:   # surfaced by wait() on the caller
            self._error = exc
        self.stats["write_s"] += time.perf_counter() - t0

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


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
