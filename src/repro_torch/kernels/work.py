"""What one kernel launch computes and moves, as laid out, reported to the
roofline counters of :mod:`repro_torch.launch.roofline`.

Each kernel wrapper opens :func:`kernel_work` around its call.  With a
counter active on this thread, the scope adds the wrapper's own
``(flops, bytes)`` to it, and nothing that runs inside the scope (the
plain version on the CPU, a descriptor copy or an allocation on the card)
is counted again; with none active, it does nothing.  A counter is any
torch dispatch mode with integer ``flops``, ``bytes`` and ``inside_kernel``
attributes (:class:`repro_torch.launch.roofline.WorkCounter`); it is found
on the dispatch-mode stack, which autograd's own thread for a CUDA
backward inherits too.  This module imports nothing of the port, so the
kernels depend on no layer above them.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Tuple

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


@contextlib.contextmanager
def _reported(counter, work: Tuple[int, int]):
    if not counter.inside_kernel:      # an outer kernel's report holds it
        counter.flops += int(work[0])
        counter.bytes += int(work[1])
    counter.inside_kernel += 1
    try:
        yield
    finally:
        counter.inside_kernel -= 1


def _active():
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "inside_kernel"):     # a counter (module docstring)
            return mode
    return None


def kernel_work(work: Callable[[], Tuple[int, int]]):
    """The scope of one kernel wrapper's call: with a counter active on
    this thread, adds ``work()``'s ``(flops, bytes)`` to it and counts
    nothing that runs inside the scope; without one, does nothing (and
    never calls ``work``)."""
    counter = _active()
    if counter is None:
        return contextlib.nullcontext()
    return _reported(counter, work())


def walk_work(entries: int, entry_bytes: int, d: int, out_rows: int
              ) -> Tuple[int, int]:
    """``(flops, bytes)`` of a gather-accumulate walk as laid out: 2 flops
    per stored entry and feature; each stored entry read once
    (``entry_bytes``) with its gathered ``x`` row (``d`` f32), and every
    output row written once."""
    return 2 * entries * d, entries * (entry_bytes + 4 * d) + out_rows * 4 * d


def attention_work(bh: int, sq: int, sk: int, hd: int, pairs: int,
                   itemsize: int, backward: bool = False
                   ) -> Tuple[int, int]:
    """``(flops, bytes)`` of attention over ``pairs`` live (query, key)
    pairs a head, 2 flops per multiply-add: the forward's two products
    (``q kᵀ``, ``p v``), q, k, v read and o written once; the backward's
    five (``q kᵀ``, ``dO vᵀ``, ``pᵀ dO``, ``dS k``, ``dSᵀ q``), q, k, v,
    o, dO and the f32 ``lse`` read and dq, dk, dv written once."""
    if backward:
        return (10 * bh * hd * pairs,
                4 * bh * (sq + sk) * hd * itemsize + 4 * bh * sq)
    return 4 * bh * hd * pairs, 2 * bh * (sq + sk) * hd * itemsize
