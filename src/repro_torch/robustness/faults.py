"""Deterministic fault injection (port of ``repro.robustness.faults``).

A *fault* is a (site, key, times) triple armed in a process-wide registry.
Library code consults the registry at a few instrumented sites and, when a
matching armed fault is found, simulates the failure at that point, so "chunk
3's read fails once", "iteration 20 goes NaN" or "the prefetch worker dies
mid-stream" are reproducible statements a test can make.  With nothing armed
a hook is one locked scan of an empty list.

Instrumented sites (each names the ``key`` it is consulted with):

* ``"chunk-load"`` — corpus chunk loads (key = chunk index):
  :meth:`~repro_torch.data.corpus.MmapCorpus.load` and
  :class:`~repro_torch.data.corpus.ResidentChunks` raise an
  :class:`InjectedIOError` (an ``OSError``), which the prefetcher retries as
  transient I/O.
* ``"corrupt-shard"`` — :meth:`MmapCorpus.load` flips the loaded shard's
  bytes before its checksum is checked (key = shard index).
* ``"poison-step"`` — the solver drivers NaN-poison the factor entering
  iteration / chunk ``key``; the engines' health index must flag it and the
  driver roll back (or raise).
* ``"prefetch-worker"`` — the prefetch worker exits silently before packing
  item ``key`` (no error, no end marker); the consumer's liveness check must
  notice.
* ``"kill"`` — :meth:`~repro_torch.robustness.snapshot.FitCheckpointer.save`
  exits the process (``os._exit(KILL_EXIT)``) right after committing
  checkpoint ``key``; armed with ``exc`` it raises that instead.

The reference's ``"pallas-dispatch"`` site has no counterpart: the port has
no kernel fallback to exercise.  A fault fires exactly ``times`` times at its
site and key and is then exhausted.  The registry is thread-safe (the
prefetch worker consults it off-thread).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import List, Optional

import torch

__all__ = [
    "Fault", "InjectedFault", "InjectedIOError", "KILL_EXIT", "active",
    "clear", "fire", "inject", "injected", "install", "maybe_kill",
    "poison", "should_fire", "uninstall",
]

#: exit status of a ``"kill"``-site exit, which tells the injected kill
#: apart from an ordinary crash
KILL_EXIT = 73


class InjectedFault(RuntimeError):
    """Raised by a fired fault with no specific exception class."""


class InjectedIOError(OSError):
    """The ``"chunk-load"`` site's transient I/O error (an ``OSError``, so
    retry policies treat it as a flaky read)."""


@dataclasses.dataclass
class Fault:
    """One armed fault.  ``key=None`` matches any key at the site;
    ``times`` is how many firings it has before it is exhausted."""

    site: str
    key: Optional[int] = None
    times: int = 1
    #: exception instance or class to raise when fired; ``None`` picks the
    #: site's default (``InjectedIOError`` for "chunk-load", else
    #: ``InjectedFault``).  At the "kill" site a non-None ``exc`` raises
    #: instead of exiting.
    exc: Optional[object] = None
    fired: int = 0

    def matches(self, site: str, key) -> bool:
        return (self.site == site and self.times > self.fired
                and (self.key is None or key is None or self.key == key))

    def make_exc(self) -> BaseException:
        if self.exc is None:
            cls = InjectedIOError if self.site == "chunk-load" else InjectedFault
            return cls(f"injected fault at site {self.site!r} "
                       f"(key={self.key}, firing {self.fired}/{self.times})")
        if isinstance(self.exc, BaseException):
            return self.exc
        return self.exc(f"injected fault at site {self.site!r}")


_LOCK = threading.Lock()
_FAULTS: List[Fault] = []


def install(site: str, key: Optional[int] = None, times: int = 1,
            exc: Optional[object] = None) -> Fault:
    """Arm a fault; returns it (for :func:`uninstall`)."""
    fault = Fault(site=site, key=key, times=int(times), exc=exc)
    with _LOCK:
        _FAULTS.append(fault)
    return fault


def uninstall(fault: Fault) -> None:
    with _LOCK:
        if fault in _FAULTS:
            _FAULTS.remove(fault)


def clear() -> None:
    """Disarm every fault."""
    with _LOCK:
        _FAULTS.clear()


def active() -> List[Fault]:
    with _LOCK:
        return list(_FAULTS)


@contextlib.contextmanager
def injected(*faults: Fault):
    """Arm already-built :class:`Fault` objects for a ``with`` block."""
    with _LOCK:
        _FAULTS.extend(faults)
    try:
        yield list(faults)
    finally:
        with _LOCK:
            for f in faults:
                if f in _FAULTS:
                    _FAULTS.remove(f)


@contextlib.contextmanager
def inject(site: str, key: Optional[int] = None, times: int = 1,
           exc: Optional[object] = None):
    """Arm one fault for a ``with`` block."""
    fault = install(site, key=key, times=times, exc=exc)
    try:
        yield fault
    finally:
        uninstall(fault)


def _claim(site: str, key) -> Optional[Fault]:
    with _LOCK:
        for fault in _FAULTS:
            if fault.matches(site, key):
                fault.fired += 1
                return fault
    return None


def should_fire(site: str, key=None) -> bool:
    """Consume one firing of a matching armed fault, if any: the hook of
    sites that simulate the failure themselves (a silent worker exit, a
    flipped byte) instead of raising."""
    return _claim(site, key) is not None


def fire(site: str, key=None) -> None:
    """Raise the matching armed fault's exception, if any."""
    fault = _claim(site, key)
    if fault is not None:
        raise fault.make_exc()


def poison(site: str, key, x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when no matching fault is armed; otherwise a new tensor
    on ``x``'s device whose first ``max(1, numel // 97)`` flat entries are
    NaN (``x`` is never written)."""
    if _claim(site, key) is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    flat = out.view(-1)
    flat[: max(1, flat.numel() // 97)] = float("nan")
    return out


def maybe_kill(site: str, key=None) -> None:
    """Exit the process with :data:`KILL_EXIT` when a matching fault is
    armed, or raise its ``exc`` if it carries one.  Placed after checkpoint
    commits, so a killed fit dies at a resumable point."""
    fault = _claim(site, key)
    if fault is None:
        return
    if fault.exc is not None:
        raise fault.make_exc()
    os._exit(KILL_EXIT)
