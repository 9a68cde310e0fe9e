"""``flash_mha`` — online-softmax attention (port of
:func:`repro.kernels.flash.flash_mha`).

A CUDA tensor goes to the hand-written kernel ``csrc/flash_mha.cu`` (one
8-warp CTA per 128-row query tile sweeping 64-key tiles on the tensor
cores: split 3 × TF32 ``mma.sync`` for f32, bf16 ``mma.sync`` for bf16;
causal tiles above the diagonal skipped); a CPU tensor goes to its plain
version :func:`~repro_torch.kernels.ref.mha_ref`; any other device
raises.  The signature and the divisibility contract are the reference's:
``q_block`` and ``k_block`` must divide the sequence lengths, although the
kernel picks its own tile and masks ragged ends itself.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import mha_ref
from .work import kernel_work

_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float,
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


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_block: int = 256, k_block: int = 256
              ) -> torch.Tensor:
    """q ``[bh, sq, hd]``, k/v ``[bh, sk, hd]`` (heads flattened into the
    leading dimension; the GQA repeat is the caller's) → ``[bh, sq, hd]``
    in ``q``'s type.  f32 or bf16; ``sq % q_block == sk % k_block == 0``
    or ``ValueError``."""
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
    # roofline work as laid out: the two products of every (query, key)
    # pair, 2 flops per multiply-add; q, k, v read once, o written once
    with kernel_work(lambda: (4 * bh * sq * sk * hd,
                              (2 * q.numel() + k.numel() + v.numel())
                              * q.element_size())):
        if q.device.type == "cpu":
            return mha_ref(q, k, v, causal=causal, q_block=q_block)
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
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), bh, sq, sk, hd,
                     int(q.dtype == torch.bfloat16), int(causal),
                     1.0 / float(hd) ** 0.5, _build.stream_ptr(q.device))
        _build.check("flash_mha", err)
        flash_mha.launches += 1
        return out


flash_mha.launches = 0
