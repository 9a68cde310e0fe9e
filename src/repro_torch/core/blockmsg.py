"""Block-Message compression (port of the part of
:mod:`repro.core.blockmsg` the ELL plan builder needs).

Per adjacency block, edges with the same aggregate slot B are merged at the
sender (the paper's Reduced Register File): a block compresses from ``nnz``
edges to ``N = |unique B|`` messages.  :func:`compress_block` computes that
merge plan; :mod:`repro_torch.kernels.edgeplan` materializes it as ELL
tables, per sender core through :func:`sender_merge_flat`.  The staged
multicast waves and block tiles are not ported yet (ROADMAP, port
Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockMessage:
    """One compressed block: neighbors of ``n_msgs`` aggregate slots travel
    from ``src_core`` to ``dst_core`` (the paper's ``A + C + N``)."""

    dst_core: int           # A
    src_core: int           # C
    n_msgs: int             # N  = unique aggregate slots in the block
    nnz: int                # raw edges the N messages replace
    agg_slots: np.ndarray   # [N] int32 — the B values (sorted)
    seg_ids: np.ndarray     # [nnz] int32 — message index of each edge
    nbr_slots: np.ndarray   # [nnz] int32 — D values, seg-sorted
    weights: np.ndarray     # [nnz] float32 — Ã values, seg-sorted

    @property
    def compression(self) -> float:
        return self.nnz / max(self.n_msgs, 1)


def compress_block(local_rows: np.ndarray, local_cols: np.ndarray,
                   vals: np.ndarray, dst_core: int, src_core: int
                   ) -> BlockMessage:
    """Index Compressor: COO block → Block Message.

    Edges are sorted by aggregate slot (B); each unique B becomes one wire
    message whose payload is the pre-reduced Σ w·x over its D slots.
    """
    order = np.argsort(local_rows, kind="stable")
    r = np.asarray(local_rows, np.int32)[order]
    c = np.asarray(local_cols, np.int32)[order]
    v = np.asarray(vals, np.float32)[order]
    uniq, seg = np.unique(r, return_inverse=True)
    return BlockMessage(
        dst_core=int(dst_core), src_core=int(src_core),
        n_msgs=int(len(uniq)), nnz=int(len(r)),
        agg_slots=uniq.astype(np.int32),
        seg_ids=seg.astype(np.int32), nbr_slots=c, weights=v,
    )


def sender_merge_flat(blocked, src_core: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All of one sender's edges in pre-reduction order, global row ids.

    Runs :func:`compress_block` on every block of column ``src_core`` and
    concatenates the merge-ordered edges with rows lifted to the global
    partial-row space (``dst_core·dpc + B``) and cols kept sender-local
    (the D slots): the flat input the distributed builder buckets into the
    sender's ELL tables.
    """
    from repro_torch.graph.partition import sender_blocks
    from repro_torch.kernels.edgeplan import flat_from_compressed

    dpc = blocked.dst_per_core
    parts = [flat_from_compressed(
        compress_block(lr, lc, v, dst_core=i, src_core=src_core),
        row_offset=i * dpc)
        for i, (lr, lc, v) in sender_blocks(blocked, src_core)]
    if not parts:
        z = np.zeros(0, np.int64)
        return z, z.copy(), np.zeros(0, np.float32)
    return tuple(np.concatenate(a) for a in zip(*parts))
