"""Graph partitioning for the stacked-core layout (port of the part of
:mod:`repro.graph.partition` the training slice runs).

P cores own contiguous row ranges (``node // tile``, the paper's address
decode: high bits = core id, low bits = local slot), and the adjacency is
tiled into P×P blocks by (destination core, source core).  Host-side
numpy, array for array the reference's.  The ``mincom`` partition and
``exchange_rows`` are not ported yet (ROADMAP, port Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .coo import COO


def core_of(node: np.ndarray, nodes_per_core: int) -> np.ndarray:
    """High bits = core id (paper Fig. 7 address decode)."""
    return node // nodes_per_core


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
