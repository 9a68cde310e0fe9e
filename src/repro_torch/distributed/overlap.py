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
losses and gradients; with ``axis_names`` it all-reduces them over the
process groups of the current mesh's named axes
(:func:`repro_torch.distributed.sharding.use_mesh`, as ``jax.set_mesh`` is
in the reference): once at the end, or once a microbatch when
``bucketed`` (bytes × M, each reduction behind the next microbatch).
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Sequence, Tuple

import torch

from repro_torch.optim import tree_leaves, tree_map


class Received:
    """A receive in flight across ranks: its buffer and the requests of
    the round's send and receive; :meth:`wait` returns the buffer once both
    completed (a failed transfer raises there)."""

    def __init__(self, tensor: torch.Tensor, works):
        self.tensor, self.works = tensor, works

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self.tensor


def arrived(r) -> torch.Tensor:
    """A round's received half: a stacked permutation's tensor as it is,
    a :class:`Received` once its transfers completed."""
    return r.wait() if isinstance(r, Received) else r


def double_buffered_exchange(chunks: Iterable[torch.Tensor],
                             split_fn: Callable,
                             permute_fn: Callable) -> List[torch.Tensor]:
    """One pipelined round over feature-wave ``chunks``:
    ``split_fn(chunk) -> (mine, send)``, ``permute_fn(send)`` is the round's
    exchange (an index permutation on stacked cores, or a transfer in
    flight, :class:`Received`, across ranks); all sends are issued before
    any ``mine + recv`` combine.  ``chunks`` may be a generator: each chunk
    is then produced just before its send is issued."""
    mines, recvs = [], []
    for chunk in chunks:
        mine, send = split_fn(chunk)
        recvs.append(permute_fn(send))      # issued before any combine
        mines.append(mine)
    return [m + arrived(r) for m, r in zip(mines, recvs)]


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
               axis_names: Tuple[str, ...] = (), bucketed: bool = False,
               remat: bool = False):
    """Mean loss + mean grads over ``n_micro`` microbatches.

    ``batch``: tree of tensors with a leading dim divisible by
    ``n_micro`` (this rank's batch); ``params`` a tree of float tensors.
    Microbatch *i* is the *i*-th contiguous slice of every leaf; losses and
    gradients add from zero in microbatch order.  ``axis_names``: the
    data-parallel axes of the current mesh
    (:func:`~repro_torch.distributed.sharding.use_mesh`) to sum over, each
    an ``all_reduce(SUM)`` over its process group of the gradients and
    the loss flattened into one buffer: at the end, or after every
    microbatch when ``bucketed``.  Everything is then divided by
    ``n_micro × Π sizes`` (empty ``axis_names``: the caller reduces).
    ``remat`` recomputes each microbatch's forward in its backward
    (``torch.utils.checkpoint``).
    """
    groups = _axis_groups(axis_names)
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
        grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        if bucketed and groups:
            # early reduction: this microbatch's sums, before the next one
            loss, grads = _all_reduce(loss, grads, groups)
        loss_sum = loss_sum + loss
        grad_sum = [a + g for a, g in zip(grad_sum, grads)]
    if not bucketed and groups:
        loss_sum, grad_sum = _all_reduce(loss_sum, grad_sum, groups)
    denom = n_micro
    for _, size in groups:
        denom *= size
    mean = iter([g / denom for g in grad_sum])
    return loss_sum / denom, tree_map(lambda _: next(mean), live)


def _axis_groups(axis_names: Tuple[str, ...]):
    """``[(process group, size)]`` of the current mesh's named axes."""
    if not axis_names:
        return []
    from repro_torch.distributed.sharding import axis_size, current_mesh

    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"grad_accum over axes {tuple(axis_names)} needs a "
                         "current mesh: call it inside "
                         "repro_torch.distributed.sharding.use_mesh(mesh)")
    return [(mesh.get_group(a), axis_size(mesh, a)) for a in axis_names]


def _all_reduce(loss: torch.Tensor, grads, groups):
    """The loss and gradients summed over every group, in one buffer."""
    import torch.distributed as dist

    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
    for group, _ in groups:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    parts = flat.split([1] + [g.numel() for g in grads])
    return parts[0].reshape(()), [p.view_as(g)
                                  for p, g in zip(parts[1:], grads)]
