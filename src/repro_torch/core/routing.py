"""Algorithm 1 — Parallel Multicast Routing on the 4-D hypercube (paper
§4.3; port of :mod:`repro.core.routing`).

A cycle-stepped model of the Router-St control plane:

  * **XOR Array** (Alg. 1 line 1): for every in-flight message the set of
    single-step next hops toward its destination is the set of nodes obtained
    by flipping one differing bit of ``cur XOR dst``; the step length is the
    popcount (= remaining shortest-path cycles).
  * **Sorter** (line 3): messages are scheduled shortest-step-first — they
    free channels earliest; long-step messages have more alternative paths
    and can afford to wait.
  * **Routing Set Filter** (line 4, Constraint 1): a core has one input port
    per dimension, so it can accept at most ``ndim`` (=4) messages per cycle.
    Candidate targets that appear too often across the path sets are pruned,
    removing from the *richest* path sets first (dynamic priority).
  * **Routing Table Filler** (lines 8-9): pick one next hop at random from
    the filtered set (the paper's ``Rand_sel``).
  * **Routing Set Remover** (line 10, Constraint 2): a receiver never takes
    two messages from the same sender in one cycle (one physical line per
    direction per dimension) — after a fill, conflicting candidates are
    removed from the remaining path sets.
  * **Virtual channels**: a message whose path set was emptied by the
    filter/remover is marked ``x`` and stalls one cycle (buffered in the
    virtual channel), re-entering the race next cycle.

It reproduces the paper's Fig. 9 (Fuse1..Fuse4 cycle counts) and the
§5.2 aggregate-bandwidth arithmetic, and routes the Block-Message waves of
:func:`repro_torch.core.blockmsg.build_waves`.

A host control plane, so it stays numpy.  Every random choice draws from
one ``np.random.default_rng(seed)`` in the reference's order (the filter's
``counts`` built over ``np.flatnonzero(active)`` and each path set in
order, ``max`` breaking ties by first insertion, ``rng.choice`` drawn
before the last-alternative override, one ``rng.integers`` per active
message that still has candidates in the stable-sorted order), so the
tables, positions and cycle counts are array-equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Sentinels in the routing table.
STALL = -1   # 'x' — parked in a virtual channel this cycle
DONE = -2    # message already delivered


def popcount(x: np.ndarray) -> np.ndarray:
    """Vectorized popcount for small non-negative ints."""
    x = np.asarray(x)
    out = np.zeros_like(x)
    v = x.copy()
    while np.any(v):
        out += v & 1
        v >>= 1
    return out


def xor_path_set(cur: int, dst: int, ndim: int) -> List[int]:
    """Single-step path set of a message at ``cur`` heading to ``dst``.

    One candidate per differing bit: flip that bit of ``cur``.  (Paper
    Fig. 8(b): negate the bit positions where the XOR result is 1.)
    """
    diff = cur ^ dst
    return [cur ^ (1 << b) for b in range(ndim) if (diff >> b) & 1]


@dataclasses.dataclass(frozen=True)
class RoutingResult:
    """Output of Algorithm 1.

    table: [cycles, p] int — next hop chosen for message i at each cycle
           (STALL = virtual channel, DONE = already arrived).
    positions: [cycles + 1, p] int — node of each message before each cycle.
    cycles: total cycles until the last message arrived.
    per_message_cycles: arrival cycle of each message (1-based).
    """

    table: np.ndarray
    positions: np.ndarray
    cycles: int
    per_message_cycles: np.ndarray

    @property
    def n_messages(self) -> int:
        return int(self.table.shape[1])


def _set_filter(path_sets: List[List[int]], active: np.ndarray,
                max_receive: int, rng: np.random.Generator) -> None:
    """Constraint 1 (Routing Set Filter), in place.

    Any candidate target appearing more than ``max_receive`` times across the
    active path sets is pruned until it fits; pruning removes from the
    path sets with the most alternatives first and never empties a set unless
    every holder is down to its last alternative (those fall through to the
    virtual channel).  The priority queue is re-evaluated after each removal
    (the paper calls this a dynamic process).
    """
    while True:
        counts: Dict[int, List[int]] = {}
        for i in np.flatnonzero(active):
            for t in path_sets[i]:
                counts.setdefault(t, []).append(i)
        over = {t: holders for t, holders in counts.items()
                if len(holders) > max_receive}
        if not over:
            return
        # prune the most-overloaded target first
        target = max(over, key=lambda t: len(over[t]))
        holders = over[target]
        # remove from the richest path set; tie-break randomly (Rand_sel spirit)
        sizes = np.array([len(path_sets[i]) for i in holders])
        rich = np.flatnonzero(sizes == sizes.max())
        victim = holders[int(rng.choice(rich))]
        if sizes.max() <= 1:
            # every holder is at its last alternative: drop from a random one —
            # it will stall in a virtual channel this cycle (paper's 'x').
            victim = holders[int(rng.integers(len(holders)))]
        path_sets[victim].remove(target)


def route_messages(src: Sequence[int], dst: Sequence[int], *, ndim: int = 4,
                   seed: int = 0, max_cycles: int = 256) -> RoutingResult:
    """Run Algorithm 1 on one wave of messages.

    ``src``/``dst`` are core ids in ``[0, 2**ndim)``; entry ``i`` is one
    message (the paper's 4 groups × 16 starting-point vector is simply a
    ``p = 64`` wave).  Returns the full routing table.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if src.shape != dst.shape:
        raise ValueError("src/dst length mismatch")
    p = len(src)
    n_nodes = 1 << ndim
    if np.any((src < 0) | (src >= n_nodes) | (dst < 0) | (dst >= n_nodes)):
        raise ValueError(f"core ids must be in [0, {n_nodes})")
    rng = np.random.default_rng(seed)

    cur = src.copy()
    arrived = cur == dst
    per_message_cycles = np.zeros(p, np.int64)
    table_rows: List[np.ndarray] = []
    position_rows: List[np.ndarray] = [cur.copy()]

    cycle = 0
    while not np.all(arrived):
        cycle += 1
        if cycle > max_cycles:
            raise RuntimeError("routing did not converge (deadlock?)")
        active = ~arrived
        # --- XOR Array: path sets + step lengths (Alg. 1 line 1 / line 17)
        path_sets: List[List[int]] = [
            xor_path_set(int(cur[i]), int(dst[i]), ndim) if active[i] else []
            for i in range(p)
        ]
        steps = np.where(active, popcount(cur ^ dst), 0)
        # --- Routing Set Filter (Constraint 1)
        _set_filter(path_sets, active, max_receive=ndim, rng=rng)
        # --- Sorter: shortest step first; stable so group order breaks ties
        order = np.argsort(steps[active], kind="stable")
        act_idx = np.flatnonzero(active)[order]

        row = np.full(p, DONE, np.int64)
        recv_count: Dict[int, int] = {}          # Constraint 1 at fill time
        used_channel: set = set()                # (sender, receiver) pairs
        for i in act_idx:
            cands = [t for t in path_sets[i]
                     if recv_count.get(t, 0) < ndim
                     and (int(cur[i]), t) not in used_channel]
            if not cands:
                row[i] = STALL                   # 'x' → virtual channel
                continue
            # Routing Table Filler: random pick among survivors
            t = int(cands[int(rng.integers(len(cands)))])
            row[i] = t
            recv_count[t] = recv_count.get(t, 0) + 1
            used_channel.add((int(cur[i]), t))
            # Routing Set Remover (Constraint 2): same-sender conflicts die
            for j in act_idx:
                if j != i and row[j] == DONE and cur[j] == cur[i]:
                    if t in path_sets[j]:
                        path_sets[j].remove(t)
        # --- commit moves
        moved = row >= 0
        cur = np.where(moved, row, cur)
        newly = moved & (cur == dst)
        per_message_cycles[newly] = cycle
        arrived |= newly
        table_rows.append(row)
        position_rows.append(cur.copy())

    return RoutingResult(
        table=np.stack(table_rows) if table_rows else np.zeros((0, p), np.int64),
        positions=np.stack(position_rows),
        cycles=cycle,
        per_message_cycles=per_message_cycles,
    )


def validate_routing(res: RoutingResult, src: Sequence[int],
                     dst: Sequence[int], ndim: int = 4) -> None:
    """Assert the hardware invariants of §4.3.2 over a routing table.

    * every hop is a hypercube edge (single bit flip),
    * Constraint 1: ≤ ``ndim`` receives per (cycle, core),
    * Constraint 2: ≤ 1 message per (cycle, sender, receiver) channel,
    * ≤ ``ndim`` sends per (cycle, core) (one output line per dimension),
    * every message ends at its destination.
    Raises AssertionError on violation (used by tests + hypothesis).
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    p = len(src)
    cur = src.copy()
    for c in range(res.cycles):
        row = res.table[c]
        recv: Dict[int, int] = {}
        send: Dict[int, int] = {}
        chan: set = set()
        for i in range(p):
            nxt = row[i]
            if nxt in (STALL, DONE):
                continue
            edge = int(cur[i]) ^ int(nxt)
            assert edge != 0 and (edge & (edge - 1)) == 0, \
                f"cycle {c}: msg {i} hop {cur[i]}→{nxt} is not a hypercube edge"
            key = (int(cur[i]), int(nxt))
            assert key not in chan, f"cycle {c}: channel {key} used twice"
            chan.add(key)
            recv[int(nxt)] = recv.get(int(nxt), 0) + 1
            send[int(cur[i])] = send.get(int(cur[i]), 0) + 1
            cur[i] = nxt
        for node, k in recv.items():
            assert k <= ndim, f"cycle {c}: node {node} received {k} > {ndim}"
        for node, k in send.items():
            assert k <= ndim, f"cycle {c}: node {node} sent {k} > {ndim}"
    assert np.all(cur == dst), "some messages did not arrive"


# ---------------------------------------------------------------------------
# Fig. 9 experiment harness — Fuse1..Fuse4 waves.
# ---------------------------------------------------------------------------
def make_fuse_wave(n_groups: int, rng: np.random.Generator, ndim: int = 4
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Build a FuseK wave like §5.2: each group's source vector is a random
    permutation of the 16 cores ("a random sequence from 0 to 15") and each
    column is sent to a distinct target (ascending destination ids — the
    Message Start Point Generator sorts Block Messages by destination core).
    """
    n = 1 << ndim
    srcs, dsts = [], []
    for _ in range(n_groups):
        srcs.append(rng.permutation(n))
        dsts.append(np.arange(n))
    return np.concatenate(srcs), np.concatenate(dsts)


def fuse_experiment(n_groups: int, n_trials: int = 1000, seed: int = 0,
                    ndim: int = 4) -> Dict[str, float]:
    """Reproduce one Fig. 9 series: average / max receiving cycle over random
    waves for ``FuseK = K×16`` messages."""
    rng = np.random.default_rng(seed)
    cycles = np.zeros(n_trials, np.int64)
    for t in range(n_trials):
        src, dst = make_fuse_wave(n_groups, rng, ndim)
        res = route_messages(src, dst, ndim=ndim, seed=seed * 7919 + t)
        cycles[t] = res.cycles
    return {
        "fuse": float(n_groups),
        "messages": float(n_groups * (1 << ndim)),
        "avg_cycles": float(cycles.mean()),
        "p95_cycles": float(np.percentile(cycles, 95)),
        "max_cycles": float(cycles.max()),
    }


def aggregate_bandwidth_model(avg_period_ns: float, *, line_bytes: int = 64,
                              n_cores: int = 16, fan_in: int = 4,
                              compression: float = 16.0) -> Dict[str, float]:
    """§5.2's bandwidth arithmetic, parameterized.

    effective = line_bytes × fan_in × n_cores × compression / avg_period
    raw       = same without the local pre-reduction compression factor.
    With the paper's numbers (64 B, 16 cores, fan-in 4, 16× compression,
    20.13 ns average routed-wave period) this gives 2.96 TB/s wait — the
    paper counts 64 B × 4 × 16 × 16 / 20.13 ns = 3.26e12 … their printed
    value is 2.96 TB/s from measured average period; we expose the formula
    and let the benchmark feed the measured simulator period in.
    """
    eff = line_bytes * fan_in * n_cores * compression / (avg_period_ns * 1e-9)
    raw = line_bytes * fan_in * n_cores / (avg_period_ns * 1e-9)
    return {"effective_Bps": eff, "raw_Bps": raw}
