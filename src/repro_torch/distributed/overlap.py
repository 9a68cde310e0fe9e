"""Compute/communication overlap: double-buffered exchange rounds and
microbatched gradient accumulation (port of
:mod:`repro.distributed.overlap`).

The dataflow form of the paper's ping-pong Block-Message buffers (§4.2):
a round's traffic is split into feature waves and every wave's send is
issued before any wave's local combine consumes a received half.  On the
stacked-core layout a send is an index permutation of the core axis, so
the order only fixes which values meet in each add: the per-element add
order is the serial schedule's, and results are bit-identical to it.

:func:`grad_accum` splits a batch into microbatches and accumulates their
losses and gradients.  Its data-parallel reduction over device axes needs
the multi-GPU backend, which is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Sequence, Tuple

import torch

from repro_torch.optim import tree_leaves, tree_map


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


# ---------------------------------------------------------------------------
# Microbatched gradient accumulation.
# ---------------------------------------------------------------------------
def grad_accum(loss_fn: Callable, params, batch, *, n_micro: int,
               axis_names: Tuple[str, ...] = (), remat: bool = False):
    """Mean loss + mean grads over ``n_micro`` microbatches.

    ``batch``: tree of tensors with a leading dim divisible by
    ``n_micro``; ``params`` a tree of float tensors.  Microbatch *i* is the
    *i*-th contiguous slice of every leaf; losses and gradients add from
    zero in microbatch order, then divide by ``n_micro``.  ``remat``
    recomputes each microbatch's forward in its backward
    (``torch.utils.checkpoint``).  ``axis_names`` (the data-parallel axes
    to reduce over) needs the multi-GPU backend, which is not ported: a
    non-empty ``axis_names`` raises ``NotImplementedError``.
    """
    if axis_names:
        raise NotImplementedError(
            f"grad_accum over device axes {tuple(axis_names)}: the "
            "multi-GPU torch.distributed backend is not ported yet "
            "(ROADMAP); reduce over stacked cores in the loss instead")
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)

    def loss_of(micro):
        if remat:
            from torch.utils.checkpoint import checkpoint
            return checkpoint(loss_fn, live, micro, use_reentrant=False)
        return loss_fn(live, micro)

    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=leaves[0].device)
    grad_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
    for i in range(n_micro):
        micro = tree_map(lambda x: x[i * (x.shape[0] // n_micro):
                                     (i + 1) * (x.shape[0] // n_micro)],
                         batch)
        loss = loss_of(micro)
        grads = torch.autograd.grad(loss, leaves)
        loss_sum = loss_sum + loss.detach()
        grad_sum = [a + g for a, g in zip(grad_sum, grads)]
    mean = iter([g / n_micro for g in grad_sum])
    return loss_sum / n_micro, tree_map(lambda _: next(mean), live)
