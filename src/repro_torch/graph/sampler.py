"""GraphSAGE neighbour sampler and the full-graph CSR container (port of
:mod:`repro.graph.sampler`; paper §5.1: fanouts 25 → 10).

Pure-numpy host-side pipeline, statement for statement the reference's, so
the same seeds and generators give array-equal mini-batches.  Emits
static-shaped, padded COO per hop: ``layers[l]`` aggregates hop-(l+1)
nodes into hop-l nodes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .coo import COO, mean_normalize, pad_coo
from .partition import pad_to_multiple


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Host-side full-graph container (indptr/indices CSR)."""

    indptr: np.ndarray   # [n+1] int64
    indices: np.ndarray  # [e] int64, neighbor ids
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def degree(self, nodes: np.ndarray) -> np.ndarray:
        return self.indptr[nodes + 1] - self.indptr[nodes]


def csr_from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSRGraph:
    """Build CSR adjacency (out-neighbors of each node); symmetrizing is the
    caller's business (datasets emit both directions for undirected)."""
    order = np.argsort(src, kind="stable")
    src = src[order]
    dst = dst[order]
    counts = np.bincount(src, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int64),
                    n_nodes=n_nodes)


@dataclasses.dataclass(frozen=True)
class MiniBatch:
    """One sampled mini-batch: per-layer adjacencies + input/seed ids.

    ``layers[l]`` aggregates hop-(l+1) nodes into hop-l nodes;
    ``layers[-1]`` consumes the raw input features.  Every hop's node
    count is padded to ``pad_multiple`` (and the edge count to the static
    bound), so each hop splits evenly across the cores.
    """

    layers: Tuple[COO, ...]          # rectangular, row-major sorted, padded
    input_nodes: np.ndarray          # [n_last_padded] global ids of frontier
    seed_nodes: np.ndarray           # [batch] global ids of the batch
    n_real: Tuple[int, ...]          # true (unpadded) node count per hop


class NeighborSampler:
    """Uniform neighbour sampling with a capped fanout (with replacement
    inside each seed's CSR row, as the reference draws it)."""

    def __init__(self, graph: CSRGraph, fanouts: Sequence[int],
                 pad_multiple: int = 16, seed: int = 0):
        self.graph = graph
        self.fanouts = tuple(fanouts)
        self.pad_multiple = pad_multiple
        self.rng = np.random.default_rng(seed)

    def _sample_layer(self, seeds: np.ndarray, fanout: int,
                      rng: Optional[np.random.Generator] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows_local, frontier_nodes, cols_local): for each seed (row r)
        up to ``fanout`` sampled neighbours; the frontier starts with the
        seeds themselves (self loop, GCN-style Ã = A + I)."""
        g = self.graph
        rng = rng if rng is not None else self.rng
        deg = g.degree(seeds)
        take = np.minimum(deg, fanout)
        rows = np.repeat(np.arange(len(seeds), dtype=np.int64), take)
        total = int(take.sum())
        if total:
            u = rng.random(total)
            row_start = np.repeat(g.indptr[seeds], take)
            row_deg = np.repeat(deg, take).astype(np.float64)
            offs = np.floor(u * row_deg).astype(np.int64)
            picked = g.indices[row_start + offs]
        else:
            picked = np.zeros(0, np.int64)
        frontier, inv = np.unique(np.concatenate([seeds, picked]),
                                  return_inverse=True)
        # remap so that seeds occupy [0, len(seeds)) in the frontier order
        seed_pos = inv[:len(seeds)]
        remap = np.full(len(frontier), -1, np.int64)
        remap[seed_pos] = np.arange(len(seeds))
        rest = np.flatnonzero(remap < 0)
        remap[rest] = len(seeds) + np.arange(len(rest))
        frontier_sorted = np.empty_like(frontier)
        frontier_sorted[remap] = frontier
        cols = remap[inv[len(seeds):]]
        self_rows = np.arange(len(seeds), dtype=np.int64)
        rows = np.concatenate([rows, self_rows])
        cols = np.concatenate([cols, self_rows])
        return rows, frontier_sorted, cols

    def sample(self, seeds: np.ndarray,
               nnz_pad: Optional[Sequence[int]] = None,
               rng: Optional[np.random.Generator] = None) -> MiniBatch:
        """``rng``: a per-batch generator for resume-exact pipelines (the
        sampler's own stream otherwise)."""
        seeds = np.asarray(seeds, np.int64)
        layers: List[COO] = []
        n_real = [len(seeds)]
        cur = seeds
        for l, fanout in enumerate(self.fanouts):
            rows, frontier, cols = self._sample_layer(cur, fanout, rng)
            n_dst = pad_to_multiple(len(cur), self.pad_multiple)
            n_src = pad_to_multiple(len(frontier), self.pad_multiple)
            coo = mean_normalize(rows, cols, n_dst=n_dst, n_src=n_src)
            if nnz_pad is not None:
                coo = pad_coo(coo, nnz_pad[l])
            layers.append(coo)
            n_real.append(len(frontier))
            cur = frontier
        frontier_padded = np.zeros(pad_to_multiple(len(cur),
                                                   self.pad_multiple),
                                   np.int64)
        frontier_padded[:len(cur)] = cur
        return MiniBatch(layers=tuple(layers), input_nodes=frontier_padded,
                         seed_nodes=seeds, n_real=tuple(n_real))

    def static_nnz(self, batch_size: int) -> Tuple[int, ...]:
        """Worst-case padded nnz per layer (fanout + self-loop bound)."""
        sizes = []
        cur = batch_size
        for fanout in self.fanouts:
            sizes.append(pad_to_multiple(cur * (fanout + 1), 128))
            cur = cur * (fanout + 1)
        return tuple(sizes)


def epoch_batches(n_nodes: int, batch_size: int, rng: np.random.Generator):
    """Shuffled full-epoch seed batches (the ragged tail is dropped, as the
    paper's fixed 1024-node batches do)."""
    perm = rng.permutation(n_nodes)
    n_full = (n_nodes // batch_size) * batch_size
    for s in range(0, n_full, batch_size):
        yield perm[s:s + batch_size]
