"""What one kernel launch computes and moves, as laid out, reported to the
roofline counters of :mod:`repro_torch.launch.roofline`.

Each kernel wrapper opens :func:`kernel_work` around its call.  With a
counter active on this thread, the scope adds the wrapper's own
``(flops, bytes)`` to it, and nothing that runs inside the scope (the
plain version on the CPU, a descriptor copy or an allocation on the card)
is counted again; with none active, it does nothing.  A counter is any
object with integer ``flops``, ``bytes`` and ``inside_kernel`` attributes
that :func:`push` / :func:`pop` while it is active
(:class:`repro_torch.launch.roofline.WorkCounter`).  This module imports
nothing of the port, so the kernels depend on no layer above them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Tuple

_local = threading.local()            # dispatch modes are per thread too


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def push(counter) -> None:
    """Make ``counter`` the active one on this thread."""
    _stack().append(counter)


def pop() -> None:
    """Drop the active counter of this thread."""
    _stack().pop()


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


def kernel_work(work: Callable[[], Tuple[int, int]]):
    """The scope of one kernel wrapper's call: with a counter active on
    this thread, adds ``work()``'s ``(flops, bytes)`` to it and counts
    nothing that runs inside the scope; without one, does nothing (and
    never calls ``work``)."""
    stack = _stack()
    if not stack:
        return contextlib.nullcontext()
    return _reported(stack[-1], work())


def walk_work(entries: int, entry_bytes: int, d: int, out_rows: int
              ) -> Tuple[int, int]:
    """``(flops, bytes)`` of a gather-accumulate walk as laid out: 2 flops
    per stored entry and feature; each stored entry read once
    (``entry_bytes``) with its gathered ``x`` row (``d`` f32), and every
    output row written once."""
    return 2 * entries * d, entries * (entry_bytes + 4 * d) + out_rows * 4 * d
