"""Mutable serving-time graph — the adjacency the InferenceEngine queries
(port of :mod:`repro.serving.graph`; host-side numpy, unchanged).

Training samples from a frozen :class:`~repro_torch.graph.CSRGraph`; serving has
to absorb edge updates between queries, so this wraps the same adjacency in
a per-vertex mutable form with BOTH directions indexed:

* **in-neighbors** (``u`` such that ``u → v``) drive aggregation: a GCN
  layer for row ``v`` averages over ``N_in(v) ∪ {v}`` with uniform
  ``1 / |N_in(v) ∪ {v}|`` weights (the row-mean normalization of
  :func:`repro_torch.graph.mean_normalize` — row ``v``'s weights depend only on
  its own degree, so an edge update touches exactly its dst row's weights,
  never the whole matrix as a symmetric ``D^{-1/2} A D^{-1/2}`` norm
  would).
* **out-neighbors** (``w`` such that ``v → w``) drive invalidation: they
  are exactly the rows whose layer-(l+1) aggregation reads ``v``'s
  layer-l embedding, i.e. the next ring of the invalidation frontier walk.

Neighbor lists are kept canonically SORTED (ascending vertex id) so the
rectangular per-query COO the engine builds is identical no matter which
other rows share the micro-batch — the property the incremental cache's
bit-match guarantee rests on.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np

Edge = Tuple[int, int]


class DynamicGraph:
    """Mutable directed adjacency with sorted in-lists + out-sets.

    Build from a :class:`~repro_torch.graph.CSRGraph` (whose CSR is src-major:
    ``indices[indptr[s]:indptr[s+1]]`` are the out-neighbors of ``s``;
    datasets emit both directions for undirected graphs) or from nothing
    (``DynamicGraph(n_nodes=n)``) and grow it with :meth:`update_edges`.
    """

    def __init__(self, csr=None, *, n_nodes: int = 0):
        if csr is not None:
            n_nodes = int(csr.n_nodes)
        self.n_nodes = int(n_nodes)
        self._in: List[Set[int]] = [set() for _ in range(self.n_nodes)]
        self._out: List[Set[int]] = [set() for _ in range(self.n_nodes)]
        self.edges_added = 0
        self.edges_removed = 0
        self.noop_updates = 0       # add-existing / remove-missing requests
        self._sorted_in: Dict[int, np.ndarray] = {}
        if csr is not None:
            indptr = np.asarray(csr.indptr)
            indices = np.asarray(csr.indices)
            for s in range(self.n_nodes):
                for t in indices[indptr[s]:indptr[s + 1]]:
                    t = int(t)
                    self._out[s].add(t)
                    self._in[t].add(s)

    # -- reads ----------------------------------------------------------------
    def in_neighbors(self, v: int) -> np.ndarray:
        """Sorted in-neighbors of ``v`` (cached until ``v``'s row mutates)."""
        v = int(v)
        arr = self._sorted_in.get(v)
        if arr is None:
            arr = np.fromiter(sorted(self._in[v]), np.int64,
                              len(self._in[v]))
            self._sorted_in[v] = arr
        return arr

    def agg_set(self, v: int) -> np.ndarray:
        """``N_in(v) ∪ {v}`` sorted — the rows layer ``l`` reads at l-1."""
        v = int(v)
        nbrs = self.in_neighbors(v)
        pos = np.searchsorted(nbrs, v)
        if pos < len(nbrs) and nbrs[pos] == v:
            return nbrs
        return np.insert(nbrs, pos, v)

    def out_neighbors(self, v: int) -> Set[int]:
        return self._out[int(v)]

    def in_degree(self, v: int) -> int:
        return len(self._in[int(v)])

    def expand_out(self, vertices: Iterable[int]) -> Set[int]:
        """``vertices ∪ out(vertices)`` — one ring of the invalidation
        frontier walk."""
        out: Set[int] = set(int(v) for v in vertices)
        for v in list(out):
            out |= self._out[v]
        return out

    # -- writes ---------------------------------------------------------------
    def update_edges(self, add: Sequence[Edge] = (),
                     remove: Sequence[Edge] = ()) -> Set[int]:
        """Apply ``(src, dst)`` additions/removals; returns the set of dst
        vertices whose in-list (and therefore mean-normalized row weights)
        actually changed.  Duplicate adds and missing removes are counted
        no-ops, never errors — an idempotent update stream replays safely.
        """
        dirty: Set[int] = set()
        for s, t in add:
            s, t = int(s), int(t)
            if not (0 <= s < self.n_nodes and 0 <= t < self.n_nodes):
                raise ValueError(f"edge ({s}, {t}) outside the "
                                 f"{self.n_nodes}-node graph")
            if t in self._out[s]:
                self.noop_updates += 1
                continue
            self._out[s].add(t)
            self._in[t].add(s)
            self.edges_added += 1
            dirty.add(t)
        for s, t in remove:
            s, t = int(s), int(t)
            if t not in self._out[s] if 0 <= s < self.n_nodes else True:
                self.noop_updates += 1
                continue
            self._out[s].discard(t)
            self._in[t].discard(s)
            self.edges_removed += 1
            dirty.add(t)
        for t in dirty:
            self._sorted_in.pop(t, None)
        return dirty
