"""``gemm`` — the combination kernel (port of
:func:`repro.kernels.gemm.gemm`): ``relu(x @ w + bias)`` in fp32.

A CUDA tensor goes to the hand-written kernel ``csrc/gemm.cu`` (fixed K
order, no split-K: a row's bits never depend on how many rows share the
call); a CPU tensor goes to its plain version
:func:`~repro_torch.kernels.ref.gemm_ref`, which sums in the same order.
No tile padding is needed: the kernel masks ragged edges itself.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import gemm_ref
from .work import kernel_work

_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_MAX_DIM = 2 ** 31 - 1       # the kernel takes M, N and K as int


def _lib():
    lib = _build.load("gemm")
    fn = lib.gemm_launch
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return fn


def gemm(x: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor] = None, *, relu: bool = False
         ) -> torch.Tensor:
    """``relu(x @ w + bias)``: ``x`` float32 ``[m, k]``, ``w`` float32
    ``[k, n]``, ``bias`` float32 ``[n]`` or ``None``."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm shapes {tuple(x.shape)} @ {tuple(w.shape)} "
                         "do not chain")
    tensors = [x, w] + ([bias] if bias is not None else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("gemm takes float32 x, w and bias, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if bias is not None and bias.shape != (w.shape[1],):
        raise ValueError(f"bias must be [{w.shape[1]}], got "
                         f"{tuple(bias.shape)}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"gemm inputs span devices "
                         f"{sorted({str(t.device) for t in tensors})}")
    m, k = x.shape
    n = w.shape[1]
    # roofline work: 2 flops per multiply-add; x, w, bias read once, the
    # output written once
    with kernel_work(lambda: (2 * m * n * k, 4 * (m * k + k * n + m * n + (
            n if bias is not None else 0)))):
        if x.device.type == "cpu":
            return gemm_ref(x, w, bias, relu=relu)
        if x.device.type != "cuda":
            raise RuntimeError(f"gemm runs on CUDA (kernel) or CPU (plain "
                               f"version) tensors, got {x.device}")
        if any(not t.is_contiguous() for t in tensors):
            raise ValueError("gemm needs contiguous x, w and bias")
        if max(m, k, n) > _MAX_DIM:
            raise ValueError(f"gemm takes dimensions up to {_MAX_DIM}, got "
                             f"{m} x {k} x {n}")
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        if m == 0 or n == 0:
            return out
        fn = _lib()
        err = fn(x.data_ptr(), w.data_ptr(),
                 bias.data_ptr() if bias is not None else None, out.data_ptr(),
                 m, n, k, int(relu), _build.stream_ptr(x.device))
        _build.check("gemm", err)
        gemm.launches += 1
        return out


gemm.launches = 0
