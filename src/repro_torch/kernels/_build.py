"""Build, load and count the port's hand-written kernels.

CUDA C++ sources live in ``src/repro_torch/csrc/``.  Each ``*.cu`` file is
compiled at first use by ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/kernels/`` at the repository root,
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  The one Triton kernel (``project_mask``)
compiles through Triton's own cache at first launch.

Every wrapper counts its kernel launches here (:func:`count_launch`), so a
run can show that the main path went through the kernels and not through
their plain versions.  A wrapper runs its kernel only for CUDA tensors
(:func:`on_card`); for CPU tensors it runs the plain version, and for a mix
it raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

__all__ = ["KERNELS", "count_launch", "launch_counts", "reset_launch_counts",
           "on_card", "check_rc", "library", "library_path", "build_all",
           "stream_ptr"]

#: the port's kernels, by wrapper name
KERNELS = ("project_mask", "gram", "bsr_spmm", "bsr_spmm_gram",
           "flash_attention")

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` (called by its wrapper right after
    the launch, and nowhere else)."""
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device (launch the kernel),
    False when every tensor is on the CPU (run the plain version); raises
    for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands span several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev} for a kernel operand")


def check_rc(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error code "
                           f"{rc}")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` (a CUDA device with its
    index), as an integer handle.  This is the raw getter Triton's launcher
    uses: the public ``torch.cuda.current_stream(device).cuda_stream``
    builds a Stream object, a few microseconds more per launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home
                  else []) + ["/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if Path(cand).is_file():
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
            "built from src/repro_torch/csrc at first use")
    return found


def _target(source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def _start_build(source: Path) -> subprocess.Popen | None:
    """Start ``nvcc`` for one source unless its library is already built;
    it writes to a temporary name that :func:`_finish_build` renames."""
    out = _target(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish_build(source: Path, proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    out = _target(source)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source.name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, dict]:
    """Build every CUDA source with one ``nvcc`` each, all started
    together.  Returns ``{name: {"seconds": s, "log": ptxas report}}``; an
    already-built library reports an empty log."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    procs = {n: _start_build(CSRC_DIR / f"{n}.cu") for n in names}
    report = {}
    for n, proc in procs.items():
        log = _finish_build(CSRC_DIR / f"{n}.cu", proc)
        report[n] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def library_path(name: str) -> Path:
    """The shared library built from ``csrc/<name>.cu`` (built if needed)."""
    source = CSRC_DIR / f"{name}.cu"
    _finish_build(source, _start_build(source))
    return _target(source)


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(library_path(name)))
