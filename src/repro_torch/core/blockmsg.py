"""Block-Message compression, tiles and multicast waves (port of
:mod:`repro.core.blockmsg`).

Per adjacency block, edges with the same aggregate slot B are merged at the
sender (the paper's Reduced Register File): a block compresses from ``nnz``
edges to ``N = |unique B|`` messages.  :func:`compress_block` computes that
merge plan; :mod:`repro_torch.kernels.edgeplan` materializes it as ELL
tables, per sender core through :func:`sender_merge_flat`.

:class:`BlockTiles` is the Block-Message layout in array form — dense
padded per-destination-block COO tiles with block-local rows (the B values
of the paper's Fig. 7) — which the ``block`` format's ``spmm_block`` walks:
:func:`block_tiles` for one sender core (the distributed path),
:func:`dst_tiles` for the single-device layer.

:func:`build_waves` stages the P×P block grid into the anti-diagonal
multicast waves of the paper's Fig. 6, each one Algorithm-1 wave
(:func:`repro_torch.core.routing.route_messages`), and
:func:`wave_statistics` gives the §5.2 compression behind them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


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


def message_rowlists(bm: BlockMessage):
    """Iterate one Block Message's merge plan: ``(B, D_slots, weights)`` per
    wire message — the neighbors the Reduced Register File pre-reduces into
    a single payload.  ``seg_ids`` is seg-sorted, so each message's edges
    are one contiguous slice."""
    bounds = np.flatnonzero(np.diff(bm.seg_ids)) + 1
    for b, d_slots, w in zip(bm.agg_slots, np.split(bm.nbr_slots, bounds),
                             np.split(bm.weights, bounds)):
        yield int(b), d_slots, w


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


@dataclasses.dataclass(frozen=True)
class BlockTiles:
    """Dense padded per-destination-block COO tiles of ONE sender core (or
    of every source, :func:`dst_tiles`).

    Tile *i* holds the edges whose destinations live on core *i*, with
    block-local row offsets — what the block-layout walk consumes, so
    aggregation never builds anything over all ``n_dst`` rows.  Padding
    entries carry ``val == 0``.
    """

    rows: np.ndarray        # [B, eb] int32 — dst slot WITHIN the dst block
    cols: np.ndarray        # [B, eb] int32 — local src slot (D values)
    vals: np.ndarray        # [B, eb] float32 (0 = padding)
    dst_per_core: int
    src_per_core: int

    @property
    def n_blocks(self) -> int:
        return int(self.rows.shape[0])

    @property
    def e_per_block(self) -> int:
        return int(self.rows.shape[1])


def _pack_tiles(stripes, eb_max: Optional[int], dpc: int, spc: int,
                what: str) -> BlockTiles:
    """Pad per-tile (rows, cols, vals) triples (None = empty) to a common
    length — the one packing loop both tile layouts share."""
    if eb_max is None:
        eb_max = max((len(t[0]) for t in stripes if t is not None),
                     default=1)
        eb_max = max(int(eb_max), 1)
    n = len(stripes)
    rows = np.zeros((n, eb_max), np.int32)
    cols = np.zeros((n, eb_max), np.int32)
    vals = np.zeros((n, eb_max), np.float32)
    for i, t in enumerate(stripes):
        if t is None:
            continue
        lr, lc, v = t
        if len(lr) > eb_max:
            raise ValueError(
                f"{what} {i} has {len(lr)} edges > eb_max={eb_max}")
        rows[i, :len(lr)] = lr
        cols[i, :len(lc)] = lc
        vals[i, :len(v)] = v
    return BlockTiles(rows=rows, cols=cols, vals=vals,
                      dst_per_core=dpc, src_per_core=spc)


def block_tiles(blocked, src_core: int,
                eb_max: Optional[int] = None) -> BlockTiles:
    """Column ``src_core`` of the block grid as dense padded tiles.

    Edges keep :func:`repro_torch.graph.partition.block_partition`'s
    (row, col) order inside every tile, so a row-ordered walk of the tiles
    adds every row's terms in the same order as the flat ``coo`` walk —
    the blocked and flat aggregates stay bit-identical in fp32.
    """
    P = blocked.n_cores
    per_block = [blocked.block_edges.get((i, src_core)) for i in range(P)]
    return _pack_tiles(per_block, eb_max, blocked.dst_per_core,
                       blocked.src_per_core, f"block (·, {src_core}): tile")


def dst_tiles(blocked, eb_max: Optional[int] = None) -> BlockTiles:
    """Receiver-side tiles for the single-device block layer.

    Tile *i* holds ALL edges whose destinations live in row-stripe *i* of
    the block grid — block-local rows, GLOBAL column ids (one feature
    matrix on one device).  A stripe concatenates its blocks in source-core
    order, so it is not row-sorted; each row's terms are in column order.
    """
    P = blocked.n_cores
    spc = blocked.src_per_core
    by_stripe: List[list] = [[] for _ in range(P)]
    for (bi, j), (lr, lc, v) in sorted(blocked.block_edges.items()):
        by_stripe[bi].append((lr, lc.astype(np.int64) + j * spc, v))
    stripes = [tuple(np.concatenate(a) for a in zip(*parts)) if parts
               else None for parts in by_stripe]
    return _pack_tiles(stripes, eb_max, blocked.dst_per_core, spc, "stripe")


@dataclasses.dataclass(frozen=True)
class Wave:
    """One multicast wave = up to ``groups × P`` block messages whose
    (src, dst) vectors feed Algorithm 1 directly."""

    stage: int
    src: np.ndarray          # [m] core ids
    dst: np.ndarray          # [m] core ids
    messages: Tuple[BlockMessage, ...]

    @property
    def total_msgs(self) -> int:
        return int(sum(m.n_msgs for m in self.messages))

    @property
    def total_nnz(self) -> int:
        return int(sum(m.nnz for m in self.messages))


def build_waves(blocked, group_size: int = 4) -> List[Wave]:
    """Stage the P×P block grid into anti-diagonal waves (Fig. 6(a)).

    Each stage bundles ``group_size`` anti-diagonals; within a group every
    (dst, src) pair is unique and every core appears once as sender and once
    as receiver, so a stage is exactly one Algorithm-1 wave of ≤ 4×16
    messages with ≤4 per sender — the deadlock-free start condition of the
    Message Start Point Generator.  Diagonal blocks are aggregated in the
    core and never routed; empty blocks send nothing.
    """
    from repro_torch.graph.partition import anti_diagonal_stages

    P = blocked.n_cores
    waves: List[Wave] = []
    for s, groups in enumerate(anti_diagonal_stages(P, group_size)):
        src, dst, msgs = [], [], []
        for group in groups:
            for (i, j) in group:
                if i == j:
                    continue
                edges = blocked.block_edges.get((i, j))
                if edges is None:
                    continue
                bm = compress_block(edges[0], edges[1], edges[2],
                                    dst_core=i, src_core=j)
                msgs.append(bm)
                src.append(j)
                dst.append(i)
        if msgs:
            waves.append(Wave(stage=s, src=np.asarray(src, np.int64),
                              dst=np.asarray(dst, np.int64),
                              messages=tuple(msgs)))
    return waves


def wave_statistics(waves: Sequence[Wave]) -> Dict[str, float]:
    """Compression and traffic statistics of the waves (§5.2)."""
    nnz = sum(w.total_nnz for w in waves)
    msgs = sum(w.total_msgs for w in waves)
    blocks = sum(len(w.messages) for w in waves)
    return {
        "waves": float(len(waves)),
        "blocks": float(blocks),
        "raw_edges": float(nnz),
        "wire_messages": float(msgs),
        "compression": nnz / max(msgs, 1.0),
    }


@dataclasses.dataclass(eq=False)
class BlockLayout:
    """The ``block`` format's single-device layout: the receiver-side
    :func:`dst_tiles` of one COO and both of its walks' row groupings
    (:func:`repro_torch.kernels.ref.tile_groupings`), built on the host
    once per graph."""

    tiles: BlockTiles
    n_src: int
    groups: Dict[str, np.ndarray]
    _device: Dict[str, Dict] = dataclasses.field(default_factory=dict,
                                                 repr=False)

    def device_tables(self, device) -> Dict[str, torch.Tensor]:
        """The tiles (``rows``/``cols``/``vals``) and the groupings as
        tensors on ``device``, converted once per device."""
        device = torch.device(device)
        tables = self._device.get(str(device))
        if tables is None:
            host = {"rows": self.tiles.rows, "cols": self.tiles.cols,
                    "vals": self.tiles.vals, **self.groups}
            tables = {k: torch.from_numpy(v).to(device)
                      for k, v in host.items()}
            self._device[str(device)] = tables
        return tables


def block_layout(coo, n_tiles: int) -> BlockLayout:
    """COO → :class:`BlockLayout` over ``n_tiles`` destination stripes
    (``coo.n_dst`` and ``coo.n_src`` must be multiples of ``n_tiles``)."""
    from repro_torch.graph.partition import block_partition
    from repro_torch.kernels.ref import tile_groupings

    tiles = dst_tiles(block_partition(coo, n_tiles))
    groups = tile_groupings(*(torch.from_numpy(a) for a in
                              (tiles.rows, tiles.cols, tiles.vals)),
                            tiles.dst_per_core, int(coo.n_src))
    return BlockLayout(tiles=tiles, n_src=int(coo.n_src),
                       groups={k: v.numpy() for k, v in groups.items()})
