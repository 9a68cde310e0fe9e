"""All-pairs topology — the dense all-to-all reference (port of
:mod:`repro.topology.allpairs`) on the stacked-core layout.

Every (sender, receiver) pair exchanges its block directly: ``P − 1``
rotation rounds, rotation *s* shipping each core's block for peer
``(p + s) mod P`` straight to it (on stacked cores: core ``p`` receives
from core ``(p − s) mod P``).  Each core starts from its own block and adds
the received blocks in rotation order, as the reference does.  Bytes per
core are the optimal ``n_rows·(1 − 1/P)``; the cost is ``P − 1`` rounds
against the hypercube's ``log₂P``.

Across ranks (a :class:`~repro_torch.topology.base.CoreLayout`, rank ``r``
stacking cores ``[r·c, (r+1)·c)``) the ``c`` senders of a rank's cores in
rotation *s* are ``c`` consecutive cores, on at most two ranks: the blocks
from this rank are an index permutation, the others arrive as one message
from each other rank, and the rank ships its own blocks the same way — at
most two send / receive pairs a rotation, ``c·(P − c)`` blocks in all.
The sum keeps the stacked order (own block, then rotations 1 … P − 1).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .base import (Topology, gather_every_core, gather_in_core_order,
                   post_p2p)


def _runs(cores, count: int) -> List[Tuple[int, int, int]]:
    """``[(rank, lo, hi)]``: the local indices ``lo:hi`` whose target core
    in ``cores`` (consecutive modulo P) lives on ``rank``."""
    runs: List[Tuple[int, int, int]] = []
    for i, q in enumerate(cores):
        if runs and runs[-1][0] == q // count:
            runs[-1] = (runs[-1][0], runs[-1][1], i + 1)
        else:
            runs.append((q // count, i, i + 1))
    return runs


def _rotate(send: torch.Tensor, s: int, n_cores: int, layout
            ) -> torch.Tensor:
    """Rotation ``s`` across ranks: ``send[i]`` is local core ``i``'s block
    for core ``first + i + s``; returns, for each local core ``p``, the
    block core ``p − s`` sent it."""
    c, first, rank = layout.count, layout.first, layout.rank
    sends = [(send[lo:hi], r) for r, lo, hi in
             _runs([(first + i + s) % n_cores for i in range(c)], c)
             if r != rank]
    parts, recvs = [], []
    for r, lo, hi in _runs([(first + i - s) % n_cores for i in range(c)], c):
        if r == rank:       # senders on this rank: local cores from lo - s
            src = (first + lo - s) % n_cores - first
            parts.append(send[src:src + hi - lo])
        else:
            buf = torch.empty((hi - lo, *send.shape[1:]), dtype=send.dtype,
                              device=send.device)
            parts.append(buf)
            recvs.append((buf, r))
    for w in post_p2p(layout, sends, recvs):
        w.wait()
    return parts[0] if len(parts) == 1 else torch.cat(parts)


class AllPairsTopology(Topology):
    """Dense all-to-all: one direct message per (sender, receiver) pair."""

    description = ("dense all-to-all reference: P-1 rotation rounds, one "
                   "direct block per peer, no fold-tree reuse")
    link_parallelism = 1.0    # one rotation permutation busy per round
    crosses_ranks = True

    def steps(self, n_cores):
        return n_cores - 1

    def reduce_scatter(self, partial, n_cores, layout=None):
        if n_cores == 1:
            return partial[:, 0]
        local = torch.arange(partial.shape[0], device=partial.device)
        cores = local + (0 if layout is None else layout.first)
        acc = partial[local, cores]                # own contribution first
        for s in range(1, n_cores):
            send = partial[local, (cores + s) % n_cores]
            recv = send[(cores - s) % n_cores] if layout is None \
                else _rotate(send, s, n_cores, layout)
            acc = acc + recv
        return acc

    def allgather(self, x, n_cores, layout=None):
        if n_cores == 1:
            return x.unsqueeze(1)
        if layout is not None:
            return gather_every_core(x, layout)
        P = x.shape[0]
        cores = torch.arange(P, device=x.device)
        blocks = [x] + [x[(cores - s) % P] for s in range(1, n_cores)]
        return gather_in_core_order(blocks)
