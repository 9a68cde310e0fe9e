"""Routing → collective schedule (port of :mod:`repro.core.schedule`).

The paper's routing table programs per-cycle switch states.  The port's
exchange runs as collective rounds on the stacked core axis
(:mod:`repro_torch.topology.hypercube`), so the network layer is lowered in
two steps:

  1. **Dimension-ordered hypercube schedule** (:func:`reduce_scatter_rounds`):
     the deterministic special case of Algorithm 1 in which every message
     resolves its differing bits in a fixed dimension order.  All messages
     then finish in exactly ``ndim`` rounds, and the traffic of round *r* is
     a single pairwise exchange along dimension *r*.  Local pre-reduction
     folds into a segment-sum before each send: the wire carries partial
     sums, never raw neighbor rows — the paper's Reduced-Register-File
     compression, in collective form.

  2. **Equivalence accounting** (:func:`compare_schedules`): Algorithm 1's
     adaptive table and the dimension-ordered schedule deliver the same
     messages; Alg. 1 wins cycles when waves are irregular (it races short
     messages first), dimension order wins determinism.

The deadlock-freedom constraints of §4.3.2 translate too: Constraint 1
(≤4 receives) holds because each round uses one dimension (one receive per
core per round); Constraint 2 (distinct senders) because a round's traffic
is a permutation.  What remains meaningful is load balance — bytes per
round — which :func:`round_bytes` exposes.

:func:`feature_waves` chunks the feature dimension for the pipelined fold.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .routing import popcount, route_messages


@dataclasses.dataclass(frozen=True)
class Round:
    """One collective round: every core ``d`` exchanges with ``d ^ mask``."""

    dim: int        # which hypercube dimension this round resolves
    mask: int       # partner XOR mask == 1 << dim

    def partner(self, core: int) -> int:
        return core ^ self.mask


def reduce_scatter_rounds(ndim: int) -> List[Round]:
    """Hypercube reduce-scatter: after round r, partial sums whose destination
    differs from the holder in bit r have moved across dimension r.  After
    ``ndim`` rounds every aggregate row sits fully reduced on its owner.

    The list runs low dimension to high, as the reference's does, although
    the fold that executes it (:func:`repro_torch.topology.hypercube.
    hypercube_reduce_scatter`) exchanges the high bit first: the rounds
    commute in what they deliver, and this list is the accounting order."""
    return [Round(dim=r, mask=1 << r) for r in range(ndim)]


def allgather_rounds(ndim: int) -> List[Round]:
    """Mirror schedule (backward pass uses the same edges, reversed)."""
    return [Round(dim=r, mask=1 << r) for r in reversed(range(ndim))]


def dimension_ordered_table(src: Sequence[int], dst: Sequence[int],
                            ndim: int = 4) -> np.ndarray:
    """Static routing table of the dimension-ordered schedule.

    Returns [ndim, p]: position of each message after each round (messages
    whose bit-r matches stay put that round).  Always exactly ``ndim`` rounds
    — the price of determinism is that short messages cannot finish early.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    cur = src.copy()
    out = np.zeros((ndim, len(src)), np.int64)
    for r in range(ndim):
        flip = ((cur ^ dst) >> r) & 1
        cur = cur ^ (flip << r)
        out[r] = cur
    assert np.all(cur == dst)
    return out


def round_bytes(src: Sequence[int], dst: Sequence[int], msg_bytes: int,
                ndim: int = 4) -> np.ndarray:
    """Bytes crossing each dimension under the static schedule ([ndim]
    array): each round is a bidirectional neighbor exchange on its own
    link."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    moves = np.zeros(ndim, np.int64)
    for r in range(ndim):
        moves[r] = int((((src ^ dst) >> r) & 1).sum())
    return moves * msg_bytes


def compare_schedules(src: Sequence[int], dst: Sequence[int], *, ndim: int = 4,
                      seed: int = 0) -> Dict[str, float]:
    """Adaptive (Alg. 1) vs dimension-ordered cycle counts for one wave."""
    adaptive = route_messages(src, dst, ndim=ndim, seed=seed)
    static_cycles = ndim if len(src) else 0
    shortest = int(popcount(np.asarray(src) ^ np.asarray(dst)).max()) \
        if len(src) else 0
    return {
        "adaptive_cycles": float(adaptive.cycles),
        "static_cycles": float(static_cycles),
        "lower_bound": float(shortest),
        "adaptive_stalls": float(np.sum(adaptive.table == -1)),
    }


@dataclasses.dataclass(frozen=True)
class FeatureWave:
    """One feature-dimension chunk of the pipelined fold (half-open)."""

    start: int
    size: int

    @property
    def stop(self) -> int:
        return self.start + self.size


def feature_waves(d: int, n_chunks: int) -> Tuple[FeatureWave, ...]:
    """Chunk a feature dimension into the double-buffer wave schedule.

    Chunks are contiguous, cover ``[0, d)`` exactly and differ in size by
    at most one column, so the math is bit-identical to the unchunked
    schedule (same per-element add order).
    """
    if d <= 0:
        raise ValueError(f"feature dim must be positive, got {d}")
    n_chunks = max(1, min(int(n_chunks), d))
    base, rem = divmod(d, n_chunks)
    waves = []
    start = 0
    for k in range(n_chunks):
        size = base + (1 if k < rem else 0)
        waves.append(FeatureWave(start=start, size=size))
        start += size
    return tuple(waves)


@dataclasses.dataclass(frozen=True)
class AggregationPlan:
    """The rounds of a P-core aggregation: each core computes local partials
    for ALL destination cores from its own source rows (the
    Index-Compressor pre-reduction), then ``rounds`` fold the partials
    across the hypercube; after the last round core i holds the
    fully-reduced rows it owns."""

    ndim: int
    rounds: Tuple[Round, ...]

    @property
    def n_cores(self) -> int:
        return 1 << self.ndim


def make_plan(n_cores: int) -> AggregationPlan:
    ndim = int(np.log2(n_cores))
    if (1 << ndim) != n_cores:
        raise ValueError(f"core count {n_cores} is not a power of two")
    return AggregationPlan(ndim=ndim, rounds=tuple(reduce_scatter_rounds(ndim)))
