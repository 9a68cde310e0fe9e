"""Roofline accounting of one call (the port's counterpart of
:mod:`repro.launch.hlo_analysis`).

The reference parses a compiled HLO module for its dot flops and the bytes
its unfused ops move, and turns them into roofline seconds under a chip's
peaks.  PyTorch compiles no module, so this file counts the same two
numbers while the call runs:

  * :func:`count_work` — ``(flops, bytes)`` of one call under a
    :class:`WorkCounter` (a ``TorchDispatchMode``).  Every aten op adds
    the flops of ``torch.utils.flop_counter.flop_registry`` (dot products
    and convolutions only, as the reference counts dots only) and, unless
    it is a view or an allocation, the bytes of its tensor operands and
    outputs.  An op whose tensors lie on two devices is a host↔device
    transfer, not device memory traffic, and counts nothing.
  * :func:`repro_torch.kernels.work.kernel_work` — the port's kernel
    wrappers report their own ``(flops, bytes)`` through it, computed from
    the tensors as laid out (padded entries included, as HLO counting
    charges padded arrays), and nothing they run inside — the plain
    version on the CPU, a descriptor copy or an allocation on the card —
    is counted again.  So one call counts the same on the CPU and on the
    card.  A backward that reaches a kernel counts too: ``flash_mha``'s
    gradient reports its five products over the live pairs
    (``kernels.work.attention_work``), on autograd's own thread as well.
  * :func:`roofline_terms` — compute, memory and collective seconds and
    the dominant term, under a card's :class:`Peaks`
    (:func:`card_peaks`), never a TPU's.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class Peaks(NamedTuple):
    bw: float                        # device memory, bytes/s
    fp32: float                      # f32 flop/s outside the tensor cores
    tf32: float                      # dense TF32 tensor-core flop/s
    bf16: float                      # dense bf16 tensor-core flop/s


def card_peaks(name: str) -> Peaks:
    """The published rates of the part ``name`` (``nvidia-smi`` /
    ``torch.cuda.get_device_name``; NVIDIA's data sheets, tensor-core
    rates dense, without sparsity); any other name gets the H100 SXM's."""
    if "PCIe" in name:
        return Peaks(2.0e12, 51e12, 378e12, 756e12)
    if "NVL" in name:
        return Peaks(3.9e12, 60e12, 417.5e12, 835e12)
    if "H200" in name:
        return Peaks(4.8e12, 67e12, 495e12, 989e12)
    return Peaks(3.35e12, 67e12, 495e12, 989e12)      # H100 SXM


#: the rates a count is held to when it was made on the CPU
H100_SXM = card_peaks("H100 SXM")


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float,
                   n_chips: int, *, peaks: Peaks = H100_SXM
                   ) -> Dict[str, float]:
    """Three roofline terms in seconds and the dominant one (inputs are
    per device, as the reference's): f32 flops over ``peaks.fp32``, bytes
    over ``peaks.bw``, and wire bytes over ``peaks.bw`` too, since stacked
    cores on one card exchange through its memory.  ``n_chips`` is kept
    for the reference's signature."""
    t_compute = flops / peaks.fp32
    t_memory = hbm_bytes / peaks.bw
    t_coll = wire_bytes / peaks.bw
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_coll, "dominant": dominant}


aten = torch.ops.aten
#: ops that allocate without reading or writing memory
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class WorkCounter(TorchDispatchMode):
    """Flops and bytes of the aten ops dispatched while it is active, plus
    what kernel wrappers report through
    :func:`repro_torch.kernels.work.kernel_work` (module docstring).  Use
    through :func:`count_work`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.inside_kernel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.inside_kernel:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        flop_fn = flop_registry.get(packet)
        if flop_fn is not None:
            self.flops += int(flop_fn(*args, **kwargs, out_val=out))
        if func.is_view or packet in _NO_TRAFFIC:
            return
        tensors = _tensors((args, kwargs)) + _tensors(out)
        if len({t.device for t in tensors}) > 1:
            return                     # a host↔device transfer
        self.bytes += sum(t.numel() * t.element_size() for t in tensors)


def count_work(fn: Callable, *args, **kwargs) -> Tuple[int, int]:
    """``(flops, bytes)`` of one call ``fn(*args, **kwargs)`` (module
    docstring)."""
    with WorkCounter() as counter:
        fn(*args, **kwargs)
    return counter.flops, counter.bytes
