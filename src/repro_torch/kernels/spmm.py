"""``spmm_ell`` — the pre-reduced ELL aggregation kernel (port of
:func:`repro.kernels.spmm.spmm_ell`).

``y[r] = Σ_k vals[r, k] · x[cols[r, k]]`` over one ``[nb, K]`` degree
bucket of an :class:`~repro_torch.kernels.edgeplan.EllTables`.  A CUDA
tensor goes to the hand-written kernel ``csrc/spmm_ell.cu``; a CPU tensor
goes to its plain version :func:`~repro_torch.kernels.ref.spmm_ell_ref`.
The transpose walk (the training backward) is the same call over the
plan's column-major tables.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import spmm_ell_ref

_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("spmm_ell")
    fn = lib.spmm_ell_launch
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return fn


def _check(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
           out: Optional[torch.Tensor]) -> None:
    if cols.dim() != 2 or vals.shape != cols.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must be one [nb, K] bucket")
    if x.dim() != 2:
        raise ValueError(f"x must be [n_src, d], got {tuple(x.shape)}")
    if cols.dtype != torch.int32 or vals.dtype != torch.float32 \
            or x.dtype != torch.float32:
        raise TypeError(f"spmm_ell takes int32 cols and float32 vals/x, got "
                        f"{cols.dtype}, {vals.dtype}, {x.dtype}")
    devices = {cols.device, vals.device, x.device}
    if out is not None:
        devices.add(out.device)
        if out.shape != (cols.shape[0], x.shape[1]) \
                or out.dtype != torch.float32:
            raise ValueError(f"out must be float32 [{cols.shape[0]}, "
                             f"{x.shape[1]}], got {out.dtype} "
                             f"{tuple(out.shape)}")
    if len(devices) != 1:
        raise ValueError(f"spmm_ell inputs span devices {devices}")


def spmm_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One bucket of the ELL walk: ``[nb, d]`` rows, written to ``out`` when
    given (a contiguous slice of a larger buffer).

    ``cols`` int32 ``[nb, K]`` (padding = ``n_src``), ``vals`` float32
    ``[nb, K]``, ``x`` float32 ``[n_src, d]`` without a zero row.
    """
    _check(cols, vals, x, out)
    nb, K = cols.shape
    n_src, d = x.shape
    if x.device.type == "cpu":
        y = spmm_ell_ref(cols, vals, x)
        if out is None:
            return y
        return out.copy_(y)
    if x.device.type != "cuda":
        raise RuntimeError(f"spmm_ell runs on CUDA (kernel) or CPU (plain "
                           f"version) tensors, got {x.device}")
    for name, t in (("cols", cols), ("vals", vals), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"spmm_ell needs a contiguous {name}")
    if out is None:
        out = torch.empty((nb, d), dtype=torch.float32, device=x.device)
    elif not out.is_contiguous():
        raise ValueError("spmm_ell needs a contiguous out")
    if nb == 0 or d == 0:
        return out
    fn = _lib()
    err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
             nb, K, n_src, d, _build.stream_ptr(x.device))
    _build.check("spmm_ell", err)
    spmm_ell.launches += 1
    return out


spmm_ell.launches = 0
