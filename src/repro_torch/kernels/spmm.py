"""``spmm_ell`` / ``spmm_ell_t`` — the pre-reduced ELL aggregation kernel
and its transpose walk (port of :func:`repro.kernels.spmm.spmm_ell` and
:func:`repro.kernels.spmm.spmm_ell_t`).

``y[r] = Σ_k vals[r, k] · x[cols[r, k]]`` over one ``[nb, K]`` degree
bucket of an :class:`~repro_torch.kernels.edgeplan.EllTables`.  A CUDA
tensor goes to the hand-written kernel ``csrc/spmm_ell.cu``; a CPU tensor
goes to its plain version :func:`~repro_torch.kernels.ref.spmm_ell_ref`.

Both wrappers take one bucket either as it is (``cols`` ``[nb, K]``, ``x``
``[n_src, d]``) or for ``P`` stacked sender cores (``cols`` ``[P, nb, K]``,
``x`` ``[P, n_src, d]``): one launch then walks the bucket for every core.
The transpose walk (the training backward, ``dx[c] = Σ_k t_vals[c, k] ·
e[t_cols[c, k]]``) is the same kernel over the plan's column-major
``t_*`` tables; it has a wrapper and a launch counter of its own, so a run
can show that its backward went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import spmm_ell_ref

_SIG_2D = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SIG_CORES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]


def _fn(symbol: str, sig):
    fn = getattr(_build.load("spmm_ell"), symbol)
    if fn.argtypes is None:
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, cols: torch.Tensor, vals: torch.Tensor,
           x: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    if cols.dim() not in (2, 3) or vals.shape != cols.shape:
        raise ValueError(f"{name}: cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must be one [nb, K] bucket "
                         "or one [P, nb, K] stacked bucket")
    if x.dim() != cols.dim() or (x.dim() == 3 and x.shape[0] != cols.shape[0]):
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match the "
                         f"bucket {tuple(cols.shape)} ([n_src, d] or "
                         "[P, n_src, d])")
    if cols.dtype != torch.int32 or vals.dtype != torch.float32 \
            or x.dtype != torch.float32:
        raise TypeError(f"{name} takes int32 cols and float32 vals/x, got "
                        f"{cols.dtype}, {vals.dtype}, {x.dtype}")
    devices = {cols.device, vals.device, x.device}
    if out is not None:
        devices.add(out.device)
        want = (*cols.shape[:-1], x.shape[-1])
        if out.shape != want or out.dtype != torch.float32:
            raise ValueError(f"{name}: out must be float32 {list(want)}, got "
                             f"{out.dtype} {tuple(out.shape)}")
    if len(devices) != 1:
        raise ValueError(f"{name} inputs span devices {devices}")


def _run(name: str, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
         out: Optional[torch.Tensor]) -> Tuple[torch.Tensor, bool]:
    """Check, then launch the kernel (CUDA) or run the plain version (CPU).
    Returns the output and whether the kernel was launched."""
    _check(name, cols, vals, x, out)
    if x.device.type == "cpu":
        y = spmm_ell_ref(cols, vals, x)
        return (y if out is None else out.copy_(y)), False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} runs on CUDA (kernel) or CPU (plain "
                           f"version) tensors, got {x.device}")
    for arg, t in (("cols", cols), ("vals", vals)):
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous {arg}")
    *lead, nb, K = cols.shape
    n_src, d = x.shape[-2:]
    if out is None:
        out = torch.empty((*lead, nb, d), dtype=torch.float32,
                          device=x.device)
    if cols.dim() == 2:
        if not x.is_contiguous() or not out.is_contiguous():
            raise ValueError(f"{name} needs a contiguous x and out")
        if nb == 0 or d == 0:
            return out, False
        err = _fn("spmm_ell_launch", _SIG_2D)(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            nb, K, n_src, d, _build.stream_ptr(x.device))
    else:
        if x.stride(-1) != 1 or out.stride(-1) != 1:
            raise ValueError(f"{name} needs unit-stride feature axes of x "
                             "and out")
        P = cols.shape[0]
        if P == 0 or nb == 0 or d == 0:
            return out, False
        err = _fn("spmm_ell_cores_launch", _SIG_CORES)(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            P, nb, K, n_src, d, x.stride(0), x.stride(1), out.stride(0),
            out.stride(1), _build.stream_ptr(x.device))
    _build.check(name, err)
    return out, True


def spmm_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One bucket of the forward ELL walk: ``[nb, d]`` rows (``[P, nb, d]``
    for stacked cores), written to ``out`` when given (a slice of a larger
    buffer: contiguous for one core, unit-stride features for stacked
    cores).

    ``cols`` int32 ``[nb, K]`` / ``[P, nb, K]`` (padding = ``n_src``),
    ``vals`` float32 of the same shape, ``x`` float32 ``[n_src, d]`` /
    ``[P, n_src, d]`` without a zero row (stacked cores may share one ``x``
    through a zero core stride).
    """
    y, launched = _run("spmm_ell", cols, vals, x, out)
    spmm_ell.launches += launched
    return y


def spmm_ell_t(t_cols: torch.Tensor, t_vals: torch.Tensor, e: torch.Tensor,
               *, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One bucket of the transpose walk: ``dx[c] = Σ_k t_vals[c, k] ·
    e[t_cols[c, k]]`` over the plan's column-major tables — the SAME kernel
    as :func:`spmm_ell` (no ``Aᵀ`` table, no scatter), counted on its own
    in ``spmm_ell_t.launches``."""
    y, launched = _run("spmm_ell_t", t_cols, t_vals, e, out)
    spmm_ell_t.launches += launched
    return y


spmm_ell.launches = 0
spmm_ell_t.launches = 0
