"""Full-graph CSR container (port of the CSR part of
:mod:`repro.graph.sampler`; the neighbour sampler is ported with the
training path)."""
from __future__ import annotations

import dataclasses

import numpy as np


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
