"""Graph partitioning for the stacked-core layout (port of
:mod:`repro.graph.partition`).

P cores own contiguous row ranges (``node // tile``, the paper's address
decode: high bits = core id, low bits = local slot), and the adjacency is
tiled into P×P blocks by (destination core, source core).  Partition
quality is an Engine axis (spec part 4): ``"naive"`` is that striping;
``"mincom"`` relabels nodes with a capacity-constrained greedy label
propagation so fewer (destination row, sender core) pairs cross cores, and
:func:`exchange_rows` counts those pairs — the post-merge wire volume.
Host-side numpy, array for array the reference's (the same greedy order
and stable tie-breaks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .coo import COO


def core_of(node: np.ndarray, nodes_per_core: int) -> np.ndarray:
    """High bits = core id (paper Fig. 7 address decode)."""
    return node // nodes_per_core


def local_addr(node: np.ndarray, nodes_per_core: int) -> np.ndarray:
    """Low bits = local buffer address."""
    return node % nodes_per_core


@dataclasses.dataclass(frozen=True)
class BlockedCOO:
    """Adjacency tiled into P×P blocks with per-block local indices.

    ``block_edges[(i, j)]`` holds (local_rows, local_cols, vals) of the block
    whose destinations live on core ``i`` and sources on core ``j``.
    """

    n_cores: int
    dst_per_core: int
    src_per_core: int
    block_edges: Dict[Tuple[int, int],
                      Tuple[np.ndarray, np.ndarray, np.ndarray]]

    def block_nnz(self) -> np.ndarray:
        out = np.zeros((self.n_cores, self.n_cores), np.int64)
        for (i, j), (r, _, _) in self.block_edges.items():
            out[i, j] = len(r)
        return out

    def nnz(self) -> int:
        return int(self.block_nnz().sum())


def block_partition(coo: COO, n_cores: int) -> BlockedCOO:
    """Tile a (padded-to-multiple) adjacency into P×P core blocks; edges
    inside a block keep the (row, col) sort order."""
    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    vals = np.asarray(coo.vals, np.float32)
    if coo.n_dst % n_cores or coo.n_src % n_cores:
        raise ValueError(
            f"n_dst={coo.n_dst}, n_src={coo.n_src} must be multiples of "
            f"P={n_cores}; pad the graph first")
    dpc = coo.n_dst // n_cores
    spc = coo.n_src // n_cores
    keep = vals != 0  # drop padding edges
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    bi = core_of(rows, dpc)
    bj = core_of(cols, spc)
    block_edges = {}
    order = np.lexsort((cols, rows, bj, bi))
    bi, bj = bi[order], bj[order]
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = bi * n_cores + bj
    boundaries = np.flatnonzero(np.diff(key)) + 1
    for seg_rows, seg_cols, seg_vals, seg_key in zip(
            np.split(rows, boundaries), np.split(cols, boundaries),
            np.split(vals, boundaries), np.split(key, boundaries)):
        if len(seg_rows) == 0:
            continue
        i, j = divmod(int(seg_key[0]), n_cores)
        block_edges[(i, j)] = (
            (seg_rows - i * dpc).astype(np.int32),
            (seg_cols - j * spc).astype(np.int32),
            seg_vals,
        )
    return BlockedCOO(n_cores=n_cores, dst_per_core=dpc, src_per_core=spc,
                      block_edges=block_edges)


def sender_blocks(blocked: BlockedCOO, src_core: int
                  ) -> List[Tuple[int, Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]]:
    """Column ``src_core`` of the block grid, ascending by destination core
    (the blocks one sender owns)."""
    return [(i, blocked.block_edges[(i, src_core)])
            for i in range(blocked.n_cores)
            if (i, src_core) in blocked.block_edges]


def pad_to_multiple(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def anti_diagonal_stages(n_cores: int, group_size: int = 4
                         ) -> List[List[List[Tuple[int, int]]]]:
    """Stage/group schedule of blocks (paper Fig. 6(a)):
    ``stages[s][g] = [(i, j), ...]``, group ``g`` one anti-diagonal
    ``(i - j) % P == d`` (every destination and source core distinct), a
    stage ``group_size`` consecutive anti-diagonals."""
    diagonals = [[(i, (i - d) % n_cores) for i in range(n_cores)]
                 for d in range(n_cores)]
    return [diagonals[s:s + group_size]
            for s in range(0, n_cores, group_size)]


def diagonal_storage_mask(n_cores: int) -> np.ndarray:
    """Upper-triangle block mask — the "diagonal storage" of an undirected
    adjacency (paper §4.3.3)."""
    return np.triu(np.ones((n_cores, n_cores), dtype=bool))


def partition_features(n_nodes: int, n_cores: int) -> np.ndarray:
    """Contiguous row partition of the feature matrix: core *i* owns rows
    ``[i·tile, (i+1)·tile)``."""
    if n_nodes % n_cores:
        raise ValueError("pad nodes to a multiple of the core count first")
    tile = n_nodes // n_cores
    return np.arange(n_nodes).reshape(n_cores, tile)


# ---------------------------------------------------------------------------
# Partition quality (spec part 4: "naive" | "mincom").
# ---------------------------------------------------------------------------
PARTITIONS: Tuple[str, ...] = ("naive", "mincom")


def validate_partition(name: str) -> str:
    if name not in PARTITIONS:
        raise ValueError(
            f"unknown partition {name!r}; registered partitions: {PARTITIONS}")
    return name


def mincom_assignment(rows: np.ndarray, cols: np.ndarray, n_nodes: int,
                      n_cores: int, n_rounds: int = 8) -> np.ndarray:
    """Capacity-constrained greedy label propagation over ONE node space.

    Nodes start on their naive core.  Each round counts every node's
    neighbour votes against the previous round's assignment, then places
    all nodes greedily by decreasing degree into their plurality core,
    falling down the vote order when a core is full (exactly
    ``n_nodes // n_cores`` per core).  Stops at a fixed point.  The edges
    are symmetrized; self loops do not vote.
    """
    if n_nodes % n_cores:
        raise ValueError("pad nodes to a multiple of the core count first")
    cap = n_nodes // n_cores
    assign = (np.arange(n_nodes) // cap).astype(np.int64)
    if n_cores == 1:
        return assign
    u = np.concatenate([rows, cols]).astype(np.int64)
    v = np.concatenate([cols, rows]).astype(np.int64)
    keep = u != v
    u, v = u[keep], v[keep]
    deg = np.bincount(u, minlength=n_nodes)
    order = np.argsort(-deg, kind="stable")
    for _ in range(max(1, int(n_rounds))):
        votes = np.zeros((n_nodes, n_cores), np.int64)
        np.add.at(votes, (u, assign[v]), 1)
        new = np.full(n_nodes, -1, np.int64)
        fill = np.zeros(n_cores, np.int64)
        for node in order:
            pref = np.argsort(-votes[node], kind="stable") if deg[node] \
                else np.argsort(fill, kind="stable")
            for core in pref:
                if fill[core] < cap:
                    new[node] = core
                    fill[core] += 1
                    break
        if np.array_equal(new, assign):
            break
        assign = new
    return assign


def mincom_bipartite(rows_assign: np.ndarray, rows: np.ndarray,
                     cols: np.ndarray, n_src: int,
                     n_cores: int) -> np.ndarray:
    """Assign one SOURCE space given its destination space's cores: source
    node *u* votes for the cores of its destination rows and takes the
    plurality core with room (exactly ``n_src // n_cores`` per core, nodes
    by decreasing degree, stable ties)."""
    if n_src % n_cores:
        raise ValueError("pad nodes to a multiple of the core count first")
    cap = n_src // n_cores
    naive = (np.arange(n_src) // cap).astype(np.int64)
    if n_cores == 1:
        return naive
    votes = np.zeros((n_src, n_cores), np.int64)
    np.add.at(votes, (cols.astype(np.int64),
                      rows_assign[rows.astype(np.int64)]), 1)
    deg = votes.sum(axis=1)
    assign = np.full(n_src, -1, np.int64)
    fill = np.zeros(n_cores, np.int64)
    for node in np.argsort(-deg, kind="stable"):
        placed = False
        for core in np.argsort(-votes[node], kind="stable"):
            if fill[core] < cap:
                assign[node] = core
                fill[core] += 1
                placed = True
                break
        if not placed:              # unreachable: capacities sum to n_src
            assign[node] = int(np.argmin(fill))
            fill[assign[node]] += 1
    return assign


def mincom_layer_perms(layers, n_cores: int) -> List[np.ndarray]:
    """Per-space relabeling permutations for a sampled layer chain
    (``mb.layers`` order: layer *i* maps source space *i+1* → destination
    space *i*).  Space 0 (the labeled batch) stays identity; each deeper
    space is assigned against the space it feeds
    (:func:`mincom_bipartite`).  Returns ``len(layers) + 1`` arrays,
    ``perms[s][old_id] = new_id``."""
    perms = [np.arange(layers[0].n_dst, dtype=np.int64)]
    assign = (np.arange(layers[0].n_dst, dtype=np.int64)
              // max(layers[0].n_dst // n_cores, 1))
    for coo in layers:
        rows = np.asarray(coo.rows, np.int64)
        cols = np.asarray(coo.cols, np.int64)
        keep = np.asarray(coo.vals) != 0
        # rows are in the previous space's OLD numbering, which is what
        # `assign` (old id → core) indexes
        assign = mincom_bipartite(assign, rows[keep], cols[keep],
                                  coo.n_src, n_cores)
        perms.append(partition_permutation(assign, n_cores))
    return perms


def partition_permutation(assign: np.ndarray, n_cores: int) -> np.ndarray:
    """Assignment → relabeling permutation ``perm[old_id] = new_id``: core
    *c* owns ``[c·cap, (c+1)·cap)``, old relative order kept within a core
    (the naive assignment maps to the identity)."""
    order = np.argsort(assign, kind="stable")      # old ids in new order
    perm = np.empty_like(order)
    perm[order] = np.arange(len(assign))
    return perm


def exchange_rows(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  n_dst: int, n_src: int, n_cores: int) -> int:
    """Post-merge wire volume of a partition, in partial rows: the distinct
    (destination row, sender core) pairs that cross cores — after the
    sender-side merge each ships one partial row.  Feed it to
    :meth:`repro_torch.topology.Topology.plan` as ``wire_rows``."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    keep = np.asarray(vals) != 0
    rows, cols = rows[keep], cols[keep]
    dpc = n_dst // n_cores
    spc = n_src // n_cores
    dst_core = rows // dpc
    src_core = cols // spc
    cross = dst_core != src_core
    return int(np.unique(rows[cross] * n_cores + src_core[cross]).size)
