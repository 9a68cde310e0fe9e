"""Ring topology — bandwidth-optimal reduce-scatter / all-gather (port of
:mod:`repro.topology.ring`) on the stacked-core layout.

Each core talks only to its right neighbour: a hop's ``ppermute`` is the
index permutation in which core ``p`` receives from core ``(p − 1) mod
P``.  The reduce-scatter passes running partial sums around the ring:
block *b* starts at core ``b + 1``, each hop adds one core's partial
(``recv + own partial``, the reference's order) and it arrives fully
reduced at its owner after ``P − 1`` hops.  The all-gather is the mirror:
each block circulates ``P − 1`` hops until every core holds all of them.
"""
from __future__ import annotations

import torch

from .base import Topology, gather_in_core_order


class RingTopology(Topology):
    """Neighbour-only ring: P-1 steps, one n_rows/P block per link-step."""

    description = ("bandwidth-optimal ring: P-1 neighbour hops of running "
                   "partial sums, minimum per-step message size")
    link_parallelism = 1.0    # one neighbour link direction busy per hop

    def steps(self, n_cores):
        return n_cores - 1

    def reduce_scatter(self, partial, n_cores):
        if n_cores == 1:
            return partial[:, 0]
        P = partial.shape[0]
        cores = torch.arange(P, device=partial.device)
        left = (cores - 1) % P
        # at hop s core p ships the running sum for owner (p - s); what
        # arrives is the sum for (p - s - 1), to which p adds its partial
        send = partial[cores, left]
        for s in range(1, n_cores):
            send = send[left] + partial[cores, (cores - s - 1) % P]
        return send        # after P-1 hops: each core's own block, reduced

    def allgather(self, x, n_cores):
        if n_cores == 1:
            return x.unsqueeze(1)
        P = x.shape[0]
        left = (torch.arange(P, device=x.device) - 1) % P
        blocks = [x]                    # blocks[k] on core p: core p - k's
        for _ in range(1, n_cores):
            blocks.append(blocks[-1][left])
        return gather_in_core_order(blocks)
