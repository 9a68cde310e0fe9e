"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded through :mod:`ctypes`.  The
library's file name carries a hash of the source and the flags, so an edited
kernel is rebuilt and an unchanged one is reused; builds land in ``build/``
at the repository root, which git ignores, each beside its ``nvcc`` output
(``ptxas``'s registers and spills of every kernel, :func:`build_log`).  Nothing builds at import time:
the first launch builds, or :func:`build_all` builds a set of kernels with
one ``nvcc`` each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels are built on "
                       "the machine with the GPU")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names: Iterable[str]) -> None:
    """Build every named kernel that is not built yet, one ``nvcc`` process
    per source, all running at once; raises if any build fails."""
    nvcc = _nvcc()
    jobs = []
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, target, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            target.with_suffix(".log").write_text(out)
            os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """``nvcc``'s output from the build of ``csrc/<name>.cu`` (``ptxas -v``:
    registers, stack and spills of each kernel), built first if need be."""
    build_all([name])
    return _target(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.

    Raises ``RuntimeError`` on a machine without CUDA: the kernels exist
    only for the card, and their callers never fall back to the CPU.
    """
    lib = _libs.get(name)
    if lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"kernel {name!r} needs a CUDA device and "
                               "none is available")
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def check(name: str, err: int) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"kernel {name!r} launch failed: CUDA error {err}")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the integer handle the
    C entry points take.  ``torch.cuda.current_stream`` builds a Stream
    object per call, which costs more host time than the launch itself;
    the raw getter that CUDA builds of torch carry returns the handle
    alone."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream
