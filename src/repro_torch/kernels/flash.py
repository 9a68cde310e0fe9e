"""``flash_mha`` — online-softmax attention (port of
:func:`repro.kernels.flash.flash_mha`), with the sliding window of the
reference's XLA ``flash_attend``, and its gradient ``flash_mha_bwd``.

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

``flash_mha`` is differentiable (a ``torch.autograd.Function``): with
autograd recording, its forward also keeps each row's log-sum-exp (the
kernel's ``lse`` output, base 2) beside ``o``, and its backward is
:func:`flash_mha_bwd`: the kernels of ``csrc/flash_mha_bwd.cu`` on the
card (a dQ kernel, then a dK / dV kernel, every product a ``wgmma`` on the
tensor cores: split 3 × TF32 for f32, bf16 directly with dS as two bf16
terms, hi + lo, so it keeps the plain version's f32 dS to 2^-17; no
atomics, so two calls give the same bits), :func:`~repro_torch.kernels.ref.mha_bwd_ref`
on the CPU.  The
reference differentiates its XLA scan with ``jax.grad``; the Pallas kernel
has no backward.

``flash_mha.launches`` counts every launch of the forward kernel and
``flash_mha.window_launches`` those with a window;
``flash_mha_bwd.launches`` / ``.window_launches`` count the backward's
calls (each launches its two kernels, dQ then dK / dV).  Under remat
(``torch.utils.checkpoint``) a layer's forward runs again in the
backward, so a trained layer launches ``flash_mha`` twice a step.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .ref import mha_bwd_ref, mha_ref
from .work import attention_work, kernel_work

_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                      ctypes.c_void_p]
_BWD_SIG = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                          ctypes.c_void_p]
HEAD_DIMS = (16, 32, 64, 128)
_TYPES = (torch.float32, torch.bfloat16)
_TILE = 128                     # the kernel's query rows per CTA (BQ)
_BWD_TILE = 64                  # the backward's fewest rows a CTA (hd 128)
_MAX_CTAS = 2 ** 31 - 1         # grid.x limit


def _entry(name: str, sig):
    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = sig
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


def _check_window(name: str, window) -> None:
    if window is not None and (isinstance(window, bool)
                               or int(window) != window or window < 1):
        raise ValueError(f"{name} window must be an int >= 1, got "
                         f"{window!r}")


def _check_card(name: str, tensors, hd: int, rows: int, bh: int,
                tile: int) -> None:
    """What the kernels take beyond the plain versions: a head dim they
    were built for, contiguous 16-byte aligned tensors, a grid that
    fits."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}'s kernel takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned inputs (the kernel "
                         "copies 16-byte pieces)")
    if -(-rows // tile) * bh > _MAX_CTAS:
        raise ValueError(f"{name} grid too large: bh={bh}, rows={rows}")


def _band(window: Optional[int], sq: int, sk: int) -> int:
    # a band wider than sq + sk masks nothing more: clamped to an int
    return 0 if window is None else min(int(window), sq + sk)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: Optional[int], q_block: int,
             want_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(o, lse or None)``: one launch of the kernel on the card, the
    plain version on the CPU."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
    with kernel_work(lambda: attention_work(
            bh, sq, sk, hd, live_pairs(sq, sk, causal, window),
            q.element_size())):
        if q.device.type == "cpu":
            if want_lse:
                return mha_ref(q, k, v, causal=causal, q_block=q_block,
                               window=window, return_lse=True)
            return mha_ref(q, k, v, causal=causal, q_block=q_block,
                           window=window), None
        if q.device.type != "cuda":
            raise RuntimeError(f"flash_mha runs on CUDA (kernel) or CPU "
                               f"(plain version) tensors, got {q.device}")
        _check_card("flash_mha", (q, k, v), hd, sq, bh, _TILE)
        out = torch.empty_like(q)
        lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device) \
            if want_lse else None
        if out.numel() == 0:
            return out, lse
        err = _entry("flash_mha", _SIG)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, bh, sq, sk, hd,
            int(q.dtype == torch.bfloat16), int(causal),
            _band(window, sq, sk), 1.0 / float(hd) ** 0.5,
            _build.stream_ptr(q.device))
        _build.check("flash_mha", err)
        flash_mha.launches += 1
        if window is not None:
            flash_mha.window_launches += 1
        return out, lse


class _FlashMHA(torch.autograd.Function):
    """``flash_mha`` with autograd: the forward keeps q, k, v, o and the
    rows' ``lse``; the backward is :func:`flash_mha_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block):
        o, lse = _forward(q, k, v, causal, window, q_block, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.q_block = causal, window, q_block
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_mha_bwd(q, k, v, o, lse, do.contiguous(),
                                   causal=ctx.causal, window=ctx.window,
                                   q_block=ctx.q_block)
        return dq, dk, dv, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_block: int = 256, k_block: int = 256,
              window: Optional[int] = None, return_lse: bool = False):
    """q ``[bh, sq, hd]``, k/v ``[bh, sk, hd]`` (heads flattened into the
    leading dimension; the GQA repeat is the caller's) → ``[bh, sq, hd]``
    in ``q``'s type.  f32 or bf16; ``sq % q_block == sk % k_block == 0``
    or ``ValueError``.  ``window``: ``None``, or a band width ``>= 1``
    (query ``i`` attends keys ``j`` with ``i - j < window``).
    ``return_lse``: return ``(o, lse)``, ``lse`` each row's log-sum-exp in
    base 2, f32 ``[bh, sq]``, ``-inf`` for a row with no live key (not
    differentiable).  Differentiable in q, k and v."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_mha shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    sq, sk = q.shape[1], k.shape[1]
    if sq % q_block or sk % k_block:
        raise ValueError(f"seq ({sq},{sk}) not divisible by blocks "
                         f"({q_block},{k_block})")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_mha takes float32 or bfloat16 q, k, v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_mha inputs span devices "
                         f"{sorted({str(t.device) for t in (q, k, v)})}")
    _check_window("flash_mha", window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o, lse = _FlashMHA.apply(q, k, v, causal, window, q_block)
    else:
        o, lse = _forward(q, k, v, causal, window, q_block, return_lse)
    return (o, lse) if return_lse else o


def flash_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_block: int = 512
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_mha`: ``(dq, dk, dv)`` in the inputs'
    type, from q ``[bh, sq, hd]``, k/v ``[bh, sk, hd]``, the forward's ``o``
    and base-2 ``lse`` (f32 ``[bh, sq]``, ``return_lse``) and ``do``
    (``[bh, sq, hd]``, the gradient of ``o``).  A CUDA tensor goes to the
    kernels of ``csrc/flash_mha_bwd.cu``, a CPU tensor to
    :func:`~repro_torch.kernels.ref.mha_bwd_ref` (``q_block`` its row
    block); any other device raises.  A row with no live key gets zero
    gradients."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2] \
            or o.shape != q.shape or do.shape != q.shape \
            or lse.shape != q.shape[:2]:
        raise ValueError(f"flash_mha_bwd shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, lse {tuple(lse.shape)}, do "
                         f"{tuple(do.shape)} do not match")
    if q.dtype not in _TYPES or any(t.dtype != q.dtype
                                    for t in (k, v, o, do)):
        raise TypeError("flash_mha_bwd takes float32 or bfloat16 q, k, v, o, "
                        "do of one type, got "
                        f"{[str(t.dtype) for t in (q, k, v, o, do)]}")
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_mha_bwd takes a float32 lse, got {lse.dtype}")
    tensors = (q, k, v, o, lse, do)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_mha_bwd inputs span devices "
                         f"{sorted({str(t.device) for t in tensors})}")
    _check_window("flash_mha_bwd", window)
    bh, sq, hd = q.shape
    sk = k.shape[1]
    with kernel_work(lambda: attention_work(
            bh, sq, sk, hd, live_pairs(sq, sk, causal, window),
            q.element_size(), backward=True)):
        if q.device.type == "cpu":
            return mha_bwd_ref(q, k, v, o, lse, do, causal=causal,
                               window=window, q_block=q_block)
        if q.device.type != "cuda":
            raise RuntimeError(f"flash_mha_bwd runs on CUDA (kernel) or CPU "
                               f"(plain version) tensors, got {q.device}")
        _check_card("flash_mha_bwd", tensors, hd, max(sq, sk), bh, _BWD_TILE)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        if dq.numel() == 0 and dk.numel() == 0:
            return dq, dk, dv
        err = _entry("flash_mha_bwd", _BWD_SIG)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), bh, sq, sk, hd,
            int(q.dtype == torch.bfloat16), int(causal),
            _band(window, sq, sk), 1.0 / float(hd) ** 0.5,
            _build.stream_ptr(q.device))
        _build.check("flash_mha_bwd", err)
        flash_mha_bwd.launches += 1
        if window is not None:
            flash_mha_bwd.window_launches += 1
        return dq, dk, dv


flash_mha.launches = 0
flash_mha.window_launches = 0
flash_mha_bwd.launches = 0
flash_mha_bwd.window_launches = 0
