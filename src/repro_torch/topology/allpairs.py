"""All-pairs topology — the dense all-to-all reference (port of
:mod:`repro.topology.allpairs`) on the stacked-core layout.

Every (sender, receiver) pair exchanges its block directly: ``P − 1``
rotation rounds, rotation *s* shipping each core's block for peer
``(p + s) mod P`` straight to it (on stacked cores: core ``p`` receives
from core ``(p − s) mod P``).  Each core starts from its own block and adds
the received blocks in rotation order, as the reference does.  Bytes per
core are the optimal ``n_rows·(1 − 1/P)``; the cost is ``P − 1`` rounds
against the hypercube's ``log₂P``.
"""
from __future__ import annotations

import torch

from .base import Topology, gather_in_core_order


class AllPairsTopology(Topology):
    """Dense all-to-all: one direct message per (sender, receiver) pair."""

    description = ("dense all-to-all reference: P-1 rotation rounds, one "
                   "direct block per peer, no fold-tree reuse")
    link_parallelism = 1.0    # one rotation permutation busy per round

    def steps(self, n_cores):
        return n_cores - 1

    def reduce_scatter(self, partial, n_cores):
        if n_cores == 1:
            return partial[:, 0]
        P = partial.shape[0]
        cores = torch.arange(P, device=partial.device)
        acc = partial[cores, cores]                # own contribution first
        for s in range(1, n_cores):
            send = partial[cores, (cores + s) % P]
            acc = acc + send[(cores - s) % P]
        return acc

    def allgather(self, x, n_cores):
        if n_cores == 1:
            return x.unsqueeze(1)
        P = x.shape[0]
        cores = torch.arange(P, device=x.device)
        blocks = [x] + [x[(cores - s) % P] for s in range(1, n_cores)]
        return gather_in_core_order(blocks)
