"""Hypercube topology — the paper's 4-D NoC as dimension-ordered folds
(port of :mod:`repro.topology.hypercube`) on the stacked-core layout.

``log₂P`` rounds, high bit first.  A round's pairwise ``ppermute`` along
dimension ``b`` is the index permutation ``arange(P) ^ (1 << b)`` of the
core axis: core ``p`` receives what core ``p ^ (1 << b)`` sends.  Each core
keeps the half of its buffer whose owner bit ``b`` matches its own and adds
the half its partner sends, ``mine + recv``: the reference's fold order,
so the fp32 results are the reference's schedule's.

Also home of the generalized bit-order fold (:func:`fold_bits` /
:func:`unfold_bits`): the same dimension exchange over any bit sequence,
which :mod:`repro_torch.topology.torus2d` routes its two feature halves
through along orthogonal dimension orders.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.schedule import feature_waves
from repro_torch.distributed.overlap import double_buffered_rounds

from .base import Topology


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


def hypercube_reduce_scatter(partial: torch.Tensor,
                             n_cores: int) -> torch.Tensor:
    """Fold ``[P, P, t, ...]`` per-owner partials across the hypercube,
    high dimension first: after round *b* every core holds the blocks whose
    owner agrees with it on bits ≥ *b*; returns ``[P, t, ...]``."""
    bufs = double_buffered_rounds(
        [partial], [_round(b) for b in reversed(range(_ndim(n_cores)))])
    return bufs[0][:, 0]


def hypercube_allgather(x: torch.Tensor, n_cores: int) -> torch.Tensor:
    """Mirror schedule: ``log₂P`` doubling rounds, low dimension first;
    every core ends with all ``[P, t, ...]`` blocks in core order."""
    P = x.shape[0]
    cores = torch.arange(P, device=x.device)
    buf = x.unsqueeze(1)
    for b in range(_ndim(n_cores)):
        other = buf[cores ^ (1 << b)]
        first = (((cores >> b) & 1) == 0).view(P, *([1] * (buf.dim() - 1)))
        buf = torch.where(first, torch.cat([buf, other], 1),
                          torch.cat([other, buf], 1))
    return buf


def hypercube_allgather_pipelined(x: torch.Tensor,
                                  n_cores: int) -> torch.Tensor:
    """The backward's gather as one all-gather (the reference lowers each
    wave to the native ``all_gather``): every core sees the same blocks in
    core order, so on stacked cores it is a zero-stride view of ``x`` —
    no copy, bit-identical to :func:`hypercube_allgather`."""
    return x.unsqueeze(0).expand(n_cores, *x.shape)


def hypercube_fold_pipelined(n_cores: int, n_chunks: int, partials_fn,
                             x: torch.Tensor) -> torch.Tensor:
    """Fused local walk + double-buffered fold: per feature wave, the
    partials ``partials_fn(x_wave) -> [P, P, dpc, dc]`` are computed and
    the first (top-bit) round's send issued before the next wave's walk;
    the remaining rounds run double-buffered.  Returns ``[P, dpc, d]``."""
    # each wave's walk is produced lazily, so the top-bit round issues one
    # wave's send before the next wave's walk runs
    walks = (partials_fn(x[..., w.start:w.stop])
             for w in feature_waves(x.shape[-1], n_chunks))
    bufs = double_buffered_rounds(
        walks, [_round(b) for b in reversed(range(_ndim(n_cores)))])
    return torch.cat([b[:, 0] for b in bufs], dim=-1)


# ---------------------------------------------------------------------------
# Generalized bit-order folds (torus2d routes feature halves along
# orthogonal dimension orders through these).
# ---------------------------------------------------------------------------
def fold_bits(partial: torch.Tensor, n_cores: int,
              bit_order: Sequence[int]) -> torch.Tensor:
    """Dimension-exchange reduce-scatter over any bit sequence:
    ``[P, P, t, ...]`` partials → ``[P, t, ...]``.

    ``bit_order`` lists the hypercube dimension each round exchanges (every
    bit of ``log₂P`` once).  Before a round the buffer's blocks are
    reordered by a static permutation so the blocks whose owner bit is 0
    come first; each core keeps the half matching its own bit and adds its
    partner's, ``mine + recv``.  ``[ndim-1, …, 0]`` is the hypercube's
    schedule (every reorder the identity), bit for bit."""
    P = partial.shape[0]
    cores = torch.arange(P, device=partial.device)
    buf = partial
    slots: List[int] = list(range(n_cores))
    for b in bit_order:
        order = sorted(range(len(slots)), key=lambda k: (slots[k] >> b) & 1)
        if order != list(range(len(slots))):
            buf = buf[:, order]
            slots = [slots[k] for k in order]
        half = len(slots) // 2
        first = (((cores >> b) & 1) == 0).view(P, *([1] * (buf.dim() - 1)))
        low, high = buf[:, :half], buf[:, half:]
        mine = torch.where(first, low, high)
        send = torch.where(first, high, low)
        buf = mine + send[cores ^ (1 << b)]
        # the bit-b = 0 representatives: low[k] and high[k] agree on every
        # remaining bit (the stable sort keeps the subcube ascending)
        slots = slots[:half]
    return buf[:, 0]


def unfold_bits(x: torch.Tensor, n_cores: int,
                bit_order: Sequence[int]) -> torch.Tensor:
    """Mirror of :func:`fold_bits`: doubling rounds over
    ``reversed(bit_order)``, then a static reorder to core order;
    ``[P, t, ...] → [P, P, t, ...]``.  With the hypercube order the reorder
    is the identity and this is :func:`hypercube_allgather`."""
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

    def steps(self, n_cores):
        return _ndim(n_cores)

    def max_step_rows(self, n_rows, n_cores):
        return n_rows // 2 if n_cores > 1 else 0   # the top-bit round

    def reduce_scatter(self, partial, n_cores):
        return hypercube_reduce_scatter(partial, n_cores)

    def allgather(self, x, n_cores):
        return hypercube_allgather(x, n_cores)

    def allgather_pipelined(self, x, n_cores, n_chunks):
        return hypercube_allgather_pipelined(x, n_cores)

    def fold_pipelined(self, n_cores, n_chunks, partials_fn, x):
        return hypercube_fold_pipelined(n_cores, n_chunks, partials_fn, x)
