"""``flash_mha`` — online-softmax attention (port of
:func:`repro.kernels.flash.flash_mha`), with the sliding window of the
reference's XLA ``flash_attend``.

A CUDA tensor goes to the hand-written kernel ``csrc/flash_mha.cu`` (one
8-warp CTA per 128-row query tile sweeping 64-key tiles on the tensor
cores: split 3 × TF32 ``mma.sync`` for f32, bf16 ``mma.sync`` for bf16;
causal tiles above the diagonal and, with a window, tiles below the band
skipped); a CPU tensor goes to its plain version
:func:`~repro_torch.kernels.ref.mha_ref`; any other device raises.  The
signature and the divisibility contract are the reference's: ``q_block``
and ``k_block`` must divide the sequence lengths, although the kernel
picks its own tile and masks ragged ends itself.  ``window=w`` (the port's
addition) also masks ``i - j >= w``.

``flash_mha.launches`` counts every launch of the kernel and
``flash_mha.window_launches`` those with a window.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build
from .ref import mha_ref
from .work import kernel_work

_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                      ctypes.c_void_p]
HEAD_DIMS = (16, 32, 64, 128)
_TYPES = (torch.float32, torch.bfloat16)
_TILE = 128                     # the kernel's query rows per CTA (BQ)
_MAX_CTAS = 2 ** 31 - 1         # grid.x limit


def _lib():
    fn = _build.load("flash_mha").flash_mha_launch
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return fn


def live_pairs(sq: int, sk: int, causal: bool,
               window: Optional[int] = None) -> int:
    """The (query, key) pairs that attention over ``sq`` queries and ``sk``
    keys computes: ``j <= i`` when causal, ``i - j < window`` with a
    window, rows counted from 0 on both axes (``flash_mha``'s masks)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(i - int(window) + 1, 0) if window is not None \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_block: int = 256, k_block: int = 256,
              window: Optional[int] = None) -> torch.Tensor:
    """q ``[bh, sq, hd]``, k/v ``[bh, sk, hd]`` (heads flattened into the
    leading dimension; the GQA repeat is the caller's) → ``[bh, sq, hd]``
    in ``q``'s type.  f32 or bf16; ``sq % q_block == sk % k_block == 0``
    or ``ValueError``.  ``window``: ``None``, or a band width ``>= 1``
    (query ``i`` attends keys ``j`` with ``i - j < window``)."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_mha shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if sq % q_block or sk % k_block:
        raise ValueError(f"seq ({sq},{sk}) not divisible by blocks "
                         f"({q_block},{k_block})")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_mha takes float32 or bfloat16 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_mha inputs span devices "
                         f"{sorted({str(t.device) for t in (q, k, v)})}")
    if window is not None and (isinstance(window, bool)
                               or int(window) != window or window < 1):
        raise ValueError(f"flash_mha window must be an int >= 1, got "
                         f"{window!r}")
    # roofline work: the two products of every live (query, key) pair
    # (the triangle when causal, the band with a window), 2 flops per
    # multiply-add; q, k, v read once, o written once
    with kernel_work(lambda: (4 * bh * hd * live_pairs(sq, sk, causal,
                                                       window),
                              (2 * q.numel() + k.numel() + v.numel())
                              * q.element_size())):
        if q.device.type == "cpu":
            return mha_ref(q, k, v, causal=causal, q_block=q_block,
                           window=window)
        if q.device.type != "cuda":
            raise RuntimeError(f"flash_mha runs on CUDA (kernel) or CPU "
                               f"(plain version) tensors, got {q.device}")
        if hd not in HEAD_DIMS:
            raise ValueError(f"flash_mha's kernel takes head dims "
                             f"{HEAD_DIMS}, got {hd}")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("flash_mha needs contiguous q, k and v")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_mha needs 16-byte aligned q, k and v (the "
                             "kernel copies 16-byte pieces)")
        if -(-sq // _TILE) * bh > _MAX_CTAS:
            raise ValueError(f"flash_mha grid too large: bh={bh}, sq={sq}")
        out = torch.empty_like(q)
        if out.numel() == 0:
            return out
        # a band wider than sq + sk masks nothing more: clamped to an int
        band = 0 if window is None else min(int(window), sq + sk)
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), bh, sq, sk, hd,
                     int(q.dtype == torch.bfloat16), int(causal), band,
                     1.0 / float(hd) ** 0.5, _build.stream_ptr(q.device))
        _build.check("flash_mha", err)
        flash_mha.launches += 1
        if window is not None:
            flash_mha.window_launches += 1
        return out


flash_mha.launches = 0
flash_mha.window_launches = 0
