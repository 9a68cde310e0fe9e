"""Ring topology — bandwidth-optimal reduce-scatter / all-gather (port of
:mod:`repro.topology.ring`) on the stacked-core layout.

Each core talks only to its right neighbour: a hop's ``ppermute`` is the
index permutation in which core ``p`` receives from core ``(p − 1) mod
P``.  The reduce-scatter passes running partial sums around the ring:
block *b* starts at core ``b + 1``, each hop adds one core's partial
(``recv + own partial``, the reference's order) and it arrives fully
reduced at its owner after ``P − 1`` hops.  The all-gather is the mirror:
each block circulates ``P − 1`` hops until every core holds all of them.

Across ranks (a :class:`~repro_torch.topology.base.CoreLayout`, rank ``r``
stacking cores ``[r·c, (r+1)·c)``) a hop shifts the running sums one core
to the right inside the rank, and the rank's last core sends its one
``[t, ...]`` block to rank ``r + 1`` while its first core receives from
rank ``r − 1`` (one send / receive pair a hop; with ``c = 1``, the
reference's one core a device, every hop crosses ranks).  The owner index
uses the global core, so each rank's rows are the stacked call's bits.
"""
from __future__ import annotations

import torch

from .base import (Topology, gather_every_core, gather_in_core_order,
                   post_p2p)


def _shift_right(send: torch.Tensor, layout) -> torch.Tensor:
    """One hop: core ``p`` gets core ``p − 1``'s block (``[c, t, ...]``);
    across ranks the edge block travels to the next rank."""
    if layout is None:
        left = (torch.arange(send.shape[0], device=send.device) - 1) \
            % send.shape[0]
        return send[left]
    edge = torch.empty(send.shape[1:], dtype=send.dtype, device=send.device)
    world, rank = layout.world, layout.rank
    for w in post_p2p(layout, [(send[-1], (rank + 1) % world)],
                      [(edge, (rank - 1) % world)]):
        w.wait()
    return torch.cat([edge.unsqueeze(0), send[:-1]])


class RingTopology(Topology):
    """Neighbour-only ring: P-1 steps, one n_rows/P block per link-step."""

    description = ("bandwidth-optimal ring: P-1 neighbour hops of running "
                   "partial sums, minimum per-step message size")
    link_parallelism = 1.0    # one neighbour link direction busy per hop
    crosses_ranks = True

    def steps(self, n_cores):
        return n_cores - 1

    def reduce_scatter(self, partial, n_cores, layout=None):
        if n_cores == 1:
            return partial[:, 0]
        local = torch.arange(partial.shape[0], device=partial.device)
        cores = local + (0 if layout is None else layout.first)
        # at hop s core p ships the running sum for owner (p - s); what
        # arrives is the sum for (p - s - 1), to which p adds its partial
        send = partial[local, (cores - 1) % n_cores]
        for s in range(1, n_cores):
            send = _shift_right(send, layout) \
                + partial[local, (cores - s - 1) % n_cores]
        return send        # after P-1 hops: each core's own block, reduced

    def allgather(self, x, n_cores, layout=None):
        if n_cores == 1:
            return x.unsqueeze(1)
        if layout is not None:
            return gather_every_core(x, layout)
        P = x.shape[0]
        left = (torch.arange(P, device=x.device) - 1) % P
        blocks = [x]                    # blocks[k] on core p: core p - k's
        for _ in range(1, n_cores):
            blocks.append(blocks[-1][left])
        return gather_in_core_order(blocks)
