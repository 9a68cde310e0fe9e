"""Hypercube topology — the paper's 4-D NoC as dimension-ordered folds
(port of :mod:`repro.topology.hypercube`) on the stacked-core layout.

``log₂P`` rounds, high bit first.  A round's pairwise ``ppermute`` along
dimension ``b`` is the index permutation ``arange(P) ^ (1 << b)`` of the
core axis: core ``p`` receives what core ``p ^ (1 << b)`` sends.  Each core
keeps the half of its buffer whose owner bit ``b`` matches its own and adds
the half its partner sends, ``mine + recv``: the reference's fold order,
so the fp32 results are the reference's schedule's.

Across the ranks of a mesh (a :class:`~repro_torch.topology.base.
CoreLayout`: rank ``r`` stacks cores ``[r·c, (r+1)·c)``, ``c = P/W``) the
rounds below ``log₂c`` stay the index permutation above, and a round at
dimension ``b >= log₂c`` sends the round's half to rank
``r ^ (1 << (b − log₂c))`` (``batch_isend_irecv``, every wave's send
issued before any combine) and adds ``mine + recv`` in the same order: the
fold is the stacked fold's bits.  The gather is one ``all_gather`` of the
ranks' blocks, in core order.

Also home of the generalized bit-order fold (:func:`fold_bits` /
:func:`unfold_bits`): the same dimension exchange over any bit sequence,
which :mod:`repro_torch.topology.torus2d` routes its two feature halves
through along orthogonal dimension orders.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.schedule import feature_waves
from repro_torch.distributed.overlap import (Received, arrived,
                                             double_buffered_rounds)

from .base import CoreLayout, Topology, gather_every_core, post_p2p


def _round(b: int):
    """The ``(split, permute)`` pair of one fold round over dimension
    ``b``: ``split`` takes a ``[P, 2h, ...]`` buffer to each core's kept
    half and the half it sends (``[P, h, ...]`` each, by the core's bit
    ``b``); ``permute`` delivers each core's send to its partner across
    dimension ``b``."""
    def split(buf):
        P = buf.shape[0]
        cores = torch.arange(P, device=buf.device)
        bit = (cores >> b) & 1
        halves = buf.reshape(P, 2, buf.shape[1] // 2, *buf.shape[2:])
        return halves[cores, bit], halves[cores, 1 - bit]

    def permute(send):
        cores = torch.arange(send.shape[0], device=send.device)
        return send[cores ^ (1 << b)]

    return split, permute


def _ndim(n_cores: int) -> int:
    return max(n_cores.bit_length() - 1, 0)


def _rank_round(b: int, layout: CoreLayout):
    """The ``(split, permute)`` pair of a fold round across ranks, over
    rank dimension ``b``: every local core's bit is the rank's, so each
    keeps the same half, and ``permute`` sends the other to the partner
    rank ``rank ^ (1 << b)`` and posts the receive of its half
    (:class:`~repro_torch.distributed.overlap.Received`)."""
    bit = (layout.rank >> b) & 1
    peer = layout.rank ^ (1 << b)

    def split(buf):
        halves = buf.reshape(buf.shape[0], 2, buf.shape[1] // 2,
                             *buf.shape[2:])
        return halves[:, bit], halves[:, 1 - bit]

    def permute(send):
        recv = torch.empty(send.shape, dtype=send.dtype, device=send.device)
        return Received(recv, post_p2p(layout, [(send, peer)],
                                       [(recv, peer)]))

    return split, permute


def _bit_round(b: int, layout: Optional[CoreLayout]):
    """The ``(split, permute)`` pair of a fold round over core dimension
    ``b``: a transfer to the partner rank where ``b`` is a rank bit
    (``b >= log₂count``), else an index permutation of the stacked
    cores."""
    low = 0 if layout is None else _ndim(layout.count)
    if layout is None or b < low:
        return _round(b)
    return _rank_round(b - low, layout)


def _fold_rounds(n_cores: int, layout: Optional[CoreLayout]):
    """The fold's rounds, high dimension first."""
    return [_bit_round(b, layout) for b in reversed(range(_ndim(n_cores)))]


def hypercube_reduce_scatter(partial: torch.Tensor, n_cores: int,
                             layout: Optional[CoreLayout] = None
                             ) -> torch.Tensor:
    """Fold ``[P, P, t, ...]`` per-owner partials across the hypercube,
    high dimension first: after round *b* every core holds the blocks whose
    owner agrees with it on bits ≥ *b*; returns ``[P, t, ...]`` (across
    ranks, this rank's ``[count, P, t, ...]`` → ``[count, t, ...]``)."""
    bufs = double_buffered_rounds([partial], _fold_rounds(n_cores, layout))
    return bufs[0][:, 0]


def hypercube_allgather(x: torch.Tensor, n_cores: int,
                        layout: Optional[CoreLayout] = None) -> torch.Tensor:
    """Mirror schedule: ``log₂P`` doubling rounds, low dimension first;
    every core ends with all ``[P, t, ...]`` blocks in core order.  Across
    ranks the gather moves data only, so it is one all-gather of the
    ranks' blocks, seen by every local core (``[count, P, t, ...]``, zero
    stride): the same bits."""
    if layout is not None:
        return gather_every_core(x, layout)
    P = x.shape[0]
    cores = torch.arange(P, device=x.device)
    buf = x.unsqueeze(1)
    for b in range(_ndim(n_cores)):
        other = buf[cores ^ (1 << b)]
        first = (((cores >> b) & 1) == 0).view(P, *([1] * (buf.dim() - 1)))
        buf = torch.where(first, torch.cat([buf, other], 1),
                          torch.cat([other, buf], 1))
    return buf


def hypercube_allgather_pipelined(x: torch.Tensor, n_cores: int,
                                  layout: Optional[CoreLayout] = None
                                  ) -> torch.Tensor:
    """The backward's gather as one all-gather (the reference lowers each
    wave to the native ``all_gather``): every core sees the same blocks in
    core order, so on stacked cores it is a zero-stride view of ``x`` —
    no copy, bit-identical to :func:`hypercube_allgather`; across ranks one
    all-gather of the ranks' blocks, then that view."""
    if layout is not None:
        return hypercube_allgather(x, n_cores, layout)
    return x.unsqueeze(0).expand(n_cores, *x.shape)


def hypercube_fold_pipelined(n_cores: int, n_chunks: int, partials_fn,
                             x: torch.Tensor,
                             layout: Optional[CoreLayout] = None
                             ) -> torch.Tensor:
    """Fused local walk + double-buffered fold: per feature wave, the
    partials ``partials_fn(x_wave) -> [P, P, dpc, dc]`` are computed and
    the first (top-bit) round's send issued before the next wave's walk;
    the remaining rounds run double-buffered.  Returns ``[P, dpc, d]``."""
    # each wave's walk is produced lazily, so the top-bit round issues one
    # wave's send before the next wave's walk runs
    walks = (partials_fn(x[..., w.start:w.stop])
             for w in feature_waves(x.shape[-1], n_chunks))
    bufs = double_buffered_rounds(walks, _fold_rounds(n_cores, layout))
    return torch.cat([b[:, 0] for b in bufs], dim=-1)


# ---------------------------------------------------------------------------
# Generalized bit-order folds (torus2d routes feature halves along
# orthogonal dimension orders through these).
# ---------------------------------------------------------------------------
def fold_bits(partial: torch.Tensor, n_cores: int,
              bit_order: Sequence[int],
              layout: Optional[CoreLayout] = None) -> torch.Tensor:
    """Dimension-exchange reduce-scatter over any bit sequence:
    ``[P, P, t, ...]`` partials → ``[P, t, ...]`` (across ranks, this
    rank's ``[count, P, t, ...]`` → ``[count, t, ...]``).

    ``bit_order`` lists the hypercube dimension each round exchanges (every
    bit of ``log₂P`` once).  Before a round the buffer's blocks are
    reordered by a static permutation so the blocks whose owner bit is 0
    come first (the block axis is whole on every rank, so the reorder stays
    local); each core keeps the half matching its own bit and adds its
    partner's, ``mine + recv``.  A rank bit's round is
    :func:`_rank_round`'s transfer to rank ``rank ^ (1 << (b − log₂count))``
    (every local core shares that bit, so all keep the same half).
    ``[ndim-1, …, 0]`` is the hypercube's schedule (every reorder the
    identity), bit for bit."""
    buf = partial
    slots: List[int] = list(range(n_cores))
    for b in bit_order:
        order = sorted(range(len(slots)), key=lambda k: (slots[k] >> b) & 1)
        if order != list(range(len(slots))):
            buf = buf[:, order]
            slots = [slots[k] for k in order]
        split, permute = _bit_round(b, layout)
        mine, send = split(buf)
        buf = mine + arrived(permute(send))
        # the bit-b = 0 representatives: low[k] and high[k] agree on every
        # remaining bit (the stable sort keeps the subcube ascending)
        slots = slots[:len(slots) // 2]
    return buf[:, 0]


def unfold_bits(x: torch.Tensor, n_cores: int, bit_order: Sequence[int],
                layout: Optional[CoreLayout] = None) -> torch.Tensor:
    """Mirror of :func:`fold_bits`: doubling rounds over
    ``reversed(bit_order)``, then a static reorder to core order;
    ``[P, t, ...] → [P, P, t, ...]``.  With the hypercube order the reorder
    is the identity and this is :func:`hypercube_allgather`.  Across ranks
    the result is every block in core order whatever the order, so it is
    one all-gather (:func:`~repro_torch.topology.base.gather_every_core`)."""
    if layout is not None:
        return gather_every_core(x, layout)
    P = x.shape[0]
    cores = torch.arange(P, device=x.device)
    buf = x.unsqueeze(1)
    slots: List[int] = [0]
    for b in reversed(list(bit_order)):
        other = buf[cores ^ (1 << b)]
        first = (((cores >> b) & 1) == 0).view(P, *([1] * (buf.dim() - 1)))
        buf = torch.where(first, torch.cat([buf, other], 1),
                          torch.cat([other, buf], 1))
        slots = slots + [s | (1 << b) for s in slots]
    order = sorted(range(len(slots)), key=slots.__getitem__)
    if order != list(range(len(slots))):
        buf = buf[:, order]
    return buf


class HypercubeTopology(Topology):
    """log₂P dimension-ordered folds — the paper's 4-D NoC and the fp32
    oracle schedule."""

    description = ("log2(P)-step dimension-ordered pairwise exchange, high "
                   "bit first; the paper's 4-D NoC and the fp32 oracle "
                   "schedule")
    link_parallelism = 1.0    # one pairwise link set busy per round
    crosses_ranks = True

    def steps(self, n_cores):
        return _ndim(n_cores)

    def max_step_rows(self, n_rows, n_cores):
        return n_rows // 2 if n_cores > 1 else 0   # the top-bit round

    def reduce_scatter(self, partial, n_cores, layout=None):
        return hypercube_reduce_scatter(partial, n_cores, layout)

    def allgather(self, x, n_cores, layout=None):
        return hypercube_allgather(x, n_cores, layout)

    def allgather_pipelined(self, x, n_cores, n_chunks, layout=None):
        return hypercube_allgather_pipelined(x, n_cores, layout)

    def fold_pipelined(self, n_cores, n_chunks, partials_fn, x,
                       layout=None):
        return hypercube_fold_pipelined(n_cores, n_chunks, partials_fn, x,
                                        layout)
