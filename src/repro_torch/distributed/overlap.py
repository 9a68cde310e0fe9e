"""Double-buffered exchange rounds (port of the collective part of
:mod:`repro.distributed.overlap`; microbatched gradient accumulation is not
ported yet, ROADMAP port Queue 1).

The dataflow form of the paper's ping-pong Block-Message buffers (§4.2):
a round's traffic is split into feature waves and every wave's send is
issued before any wave's local combine consumes a received half.  On the
stacked-core layout a send is an index permutation of the core axis, so
the order only fixes which values meet in each add: the per-element add
order is the serial schedule's, and results are bit-identical to it.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Sequence, Tuple

import torch


def double_buffered_exchange(chunks: Iterable[torch.Tensor],
                             split_fn: Callable,
                             permute_fn: Callable) -> List[torch.Tensor]:
    """One pipelined round over feature-wave ``chunks``:
    ``split_fn(chunk) -> (mine, send)``, ``permute_fn(send)`` is the round's
    exchange; all sends are issued before any ``mine + recv`` combine.
    ``chunks`` may be a generator: each chunk is then produced just before
    its send is issued."""
    mines, recvs = [], []
    for chunk in chunks:
        mine, send = split_fn(chunk)
        recvs.append(permute_fn(send))      # issued before any combine
        mines.append(mine)
    return [m + r for m, r in zip(mines, recvs)]


def double_buffered_rounds(chunks: Iterable[torch.Tensor],
                           rounds: Sequence[Tuple[Callable, Callable]]
                           ) -> List[torch.Tensor]:
    """A full pipelined exchange, one double-buffered round per topology
    step: ``rounds[i]`` is that round's ``(split_fn, permute_fn)``."""
    for split_fn, permute_fn in rounds:
        chunks = double_buffered_exchange(chunks, split_fn, permute_fn)
    return list(chunks)
