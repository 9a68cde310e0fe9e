"""Distributed graph aggregation on stacked cores (port of
:mod:`repro.distributed.aggregate`).

The paper's P on-chip cores are a leading core axis of one tensor on one
GPU.  Core *i* owns a contiguous row range of every node space (NUMA: the
feature rows ``x[i]`` of ``[P, n_src/P, d]``) and the edge blocks whose
*sources* live on it (column *i* of the block grid).  Aggregation runs in
two stages:

  1. **Local pre-reduction** (the Index Compressor / Reduced Register
     File): each core reduces its own sources into partial rows for every
     destination core — ``[P, P, n_dst/P, d]`` partials;
  2. **Topology exchange** (:mod:`repro_torch.topology`): the partial
     row-blocks fold down to their owner cores over the configured
     interconnect (the ``log₂P`` dimension-ordered hypercube).

The backward is the paper's mirror schedule: all-gather the error rows
over the SAME topology and walk the SAME local edge table column-major
(``Aᵀ`` without an ``Aᵀ``).  Both aggregates are ``torch.autograd``
Functions whose backward is written out, never derived by autograd.

  * ``coo`` — :func:`shard_edges` + :func:`hypercube_aggregate`: flat
    per-sender edge lists walked by the flat ``spmm`` kernel (one launch
    for all senders, every row in edge order, no atomics); the serial
    fold; the oracle.
  * ``block`` — :func:`shard_edges_blocked` +
    :func:`hypercube_aggregate_pipelined`: per-sender Block-Message tiles
    walked by the ``spmm_block`` kernel inside the pipelined fold; the
    backward walks the same tiles column-major with the flat ``spmm``
    kernel.  Bit-equal to ``coo``: every partial row adds its terms in the
    same order, and both fold over the same rounds.
  * ``ell`` — :func:`shard_edges_ell` + :func:`hypercube_aggregate_ell`:
    per-sender pre-reduced ELL plans stacked shape-aligned and walked by
    the ``spmm_ell`` kernel (one launch per bucket for all cores) inside
    the pipelined fold; the backward walks the ``t_*`` tables with the
    ``spmm_ell_t`` wrapper of the same kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.blockmsg import block_tiles
from repro_torch.core.gcn import _spmm_blocked, _spmm_t_blocked
from repro_torch.graph.coo import COO
from repro_torch.graph.partition import block_partition
from repro_torch.kernels.ref import tile_groupings, walk_groupings
from repro_torch.kernels.spmm import spmm, spmm_block


def _topo(name: str):
    from repro_torch.engine.registry import get_topology
    return get_topology(name)


# ---------------------------------------------------------------------------
# coo: flat per-sender edge lists (the oracle).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EdgeShards:
    """Sender-side edge lists, stacked per source core and padded.

    rows_global: [P, e_max] int32 — destination id in GLOBAL row numbering
                 (owner core × tile + slot).
    cols_local:  [P, e_max] int32 — source slot on the owning core.
    vals:        [P, e_max] f32   — weights (0 = padding).
    """

    rows_global: np.ndarray
    cols_local: np.ndarray
    vals: np.ndarray
    n_dst: int
    n_src: int
    n_cores: int

    @property
    def dst_per_core(self) -> int:
        return self.n_dst // self.n_cores

    @property
    def src_per_core(self) -> int:
        return self.n_src // self.n_cores


def shard_edges(coo: COO, n_cores: int,
                e_max: Optional[int] = None) -> EdgeShards:
    """Partition a (padded) COO by SOURCE core — column stripes of the
    block grid — and pad each core's edge list to a common length."""
    blocked = block_partition(coo, n_cores)
    dpc = blocked.dst_per_core
    per_core: list = [[] for _ in range(n_cores)]
    for (i, j), (lr, lc, v) in blocked.block_edges.items():
        per_core[j].append((lr.astype(np.int64) + i * dpc, lc, v))
    if e_max is None:
        e_max = max((sum(len(t[0]) for t in lst) for lst in per_core),
                    default=1)
        e_max = max(int(e_max), 1)
    rows = np.zeros((n_cores, e_max), np.int32)
    cols = np.zeros((n_cores, e_max), np.int32)
    vals = np.zeros((n_cores, e_max), np.float32)
    for j, lst in enumerate(per_core):
        if not lst:
            continue
        r = np.concatenate([t[0] for t in lst])
        c = np.concatenate([t[1] for t in lst])
        v = np.concatenate([t[2] for t in lst])
        if len(r) > e_max:
            raise ValueError(f"core {j} has {len(r)} edges > e_max={e_max}")
        rows[j, :len(r)] = r
        cols[j, :len(c)] = c
        vals[j, :len(v)] = v
    return EdgeShards(rows_global=rows, cols_local=cols, vals=vals,
                      n_dst=coo.n_dst, n_src=coo.n_src, n_cores=n_cores)


def shard_leaves(es: EdgeShards) -> Dict[str, np.ndarray]:
    """An :class:`EdgeShards`' host leaves: the edge lists and both walks'
    row groupings (:func:`repro_torch.kernels.ref.walk_groupings`: by
    global partial row, and by sender-local source slot), built once per
    batch on the host."""
    rows, cols, vals = (torch.from_numpy(a) for a in
                        (es.rows_global, es.cols_local, es.vals))
    groups = walk_groupings(rows, cols, vals, es.n_dst, es.src_per_core)
    return {"rows": es.rows_global, "cols": es.cols_local, "vals": es.vals,
            **{k: v.numpy() for k, v in groups.items()}}


class _SenderWalk(torch.autograd.Function):
    """Each core's pre-reduction into per-owner partial rows through the
    flat ``spmm`` kernel (one launch for every sender); its backward walks
    the SAME edges column-major (dst ↔ src roles) — ``Aᵀe`` without an
    ``Aᵀ`` table.  Both directions add every row's terms in edge order,
    from 0, with no atomics: deterministic on the card."""

    @staticmethod
    def forward(ctx, n_dst: int, rows_g: torch.Tensor, cols_l: torch.Tensor,
                vals: torch.Tensor, x: torch.Tensor, groups):
        ctx.save_for_backward(rows_g, cols_l, vals)
        ctx.spc, ctx.groups = x.shape[1], groups
        return spmm(rows_g, cols_l, vals, x, n_dst,
                    perm=groups.get("perm"), ptr=groups.get("ptr"))

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        rows_g, cols_l, vals = ctx.saved_tensors
        g = ctx.groups
        dx = spmm(cols_l, rows_g, vals, ct.contiguous(), ctx.spc,
                  perm=g.get("t_perm"), ptr=g.get("t_ptr"))
        return None, None, None, None, dx, None


def hypercube_aggregate(n_dst: int, rows_g: torch.Tensor,
                        cols_l: torch.Tensor, vals: torch.Tensor,
                        x: torch.Tensor, topology: str = "hypercube",
                        groups: Optional[Dict] = None) -> torch.Tensor:
    """``y = A @ x`` on stacked cores via pre-reduce + serial fold.

    Edge tensors are an :class:`EdgeShards` on the device (int32 indices),
    ``x`` is ``[P, n_src/P, d]``; returns ``[P, n_dst/P, d]``.  ``groups``
    holds the walks' row groupings (:func:`shard_leaves`); without them the
    kernel wrappers group on the device.  The backward all-gathers the
    error rows over ``topology`` and walks the same edges column-major.
    """
    from repro_torch.topology import reduce_scatter

    P, _, d = x.shape
    partial = _SenderWalk.apply(n_dst, rows_g, cols_l, vals, x, groups or {})
    # the mirror backward — all-gather the error rows over the SAME
    # topology — is reduce_scatter's own backward
    return reduce_scatter(topology, P, partial.view(P, P, n_dst // P, d))


# ---------------------------------------------------------------------------
# block: per-sender Block-Message tiles, walked by the spmm_block kernel.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockEdgeShards:
    """Sender-side edges in the Block-Message tile layout, stacked per core.

    Core *j* (= source core *j*) holds ``rows_local[j]``: ``[B, eb]``
    block-LOCAL destination slots (Fig. 7's B values) for each of the B
    destination-core tiles, plus matching ``cols_local`` (D values, local
    source slots) and ``vals``: :func:`repro_torch.core.blockmsg.
    block_tiles` per sender, padded to one common tile size.
    """

    rows_local: np.ndarray   # [P, B, eb] int32 — dst slot within dst block
    cols_local: np.ndarray   # [P, B, eb] int32 — source slot on the sender
    vals: np.ndarray         # [P, B, eb] f32   — weights (0 = padding)
    n_dst: int
    n_src: int
    n_cores: int

    @property
    def dst_per_core(self) -> int:
        return self.n_dst // self.n_cores

    @property
    def src_per_core(self) -> int:
        return self.n_src // self.n_cores


def shard_edges_blocked(coo: COO, n_cores: int,
                        eb_max: Optional[int] = None) -> BlockEdgeShards:
    """Partition a (padded) COO into per-sender Block-Message tiles.

    Same source-core striping as :func:`shard_edges`, but each sender's
    edges stay grouped per destination-core block with block-local row
    offsets.  Edge order inside every tile is the block partition's
    (row, col) order — the flat layout's order for every destination row,
    so the blocked and flat aggregates are fp32 bit-equal.
    """
    blocked = block_partition(coo, n_cores)
    if eb_max is None:
        eb_max = max((len(r) for (r, _, _) in blocked.block_edges.values()),
                     default=1)
        eb_max = max(int(eb_max), 1)
    tiles = [block_tiles(blocked, j, eb_max=eb_max) for j in range(n_cores)]
    return BlockEdgeShards(
        rows_local=np.stack([t.rows for t in tiles]),
        cols_local=np.stack([t.cols for t in tiles]),
        vals=np.stack([t.vals for t in tiles]),
        n_dst=coo.n_dst, n_src=coo.n_src, n_cores=n_cores)


def block_leaves(eb: BlockEdgeShards) -> Dict[str, np.ndarray]:
    """A :class:`BlockEdgeShards`' host leaves: the tiles, the forward
    walk's grouping by partial row ``b·dpc + r``, and the transpose walk's
    grouping by source slot with the entries' global rows ``t_rows``
    (:func:`repro_torch.kernels.ref.tile_groupings`), built once per batch
    on the host."""
    groups = tile_groupings(*(torch.from_numpy(a) for a in
                              (eb.rows_local, eb.cols_local, eb.vals)),
                            eb.dst_per_core, eb.src_per_core)
    return {"rows": eb.rows_local, "cols": eb.cols_local, "vals": eb.vals,
            **{k: v.numpy() for k, v in groups.items()}}


def _local_partials_blocked(tables: Dict, x: torch.Tensor,
                            dpc: int) -> torch.Tensor:
    """Every sender's per-destination-block partial rows in ONE stacked
    ``spmm_block`` launch: ``[P, B, eb]`` tiles, ``x`` ``[P, spc, dc]`` (a
    feature wave may be a strided slice) → ``[P, B, dpc, dc]``."""
    P, B = tables["rows"].shape[:2]
    return _spmm_blocked(tables, x, dpc).view(P, B, dpc, x.shape[-1])


class _HypercubeAggregatePipelined(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n_dst: int, n_chunks: int, topology: str, tables: Dict,
                x: torch.Tensor):
        P = x.shape[0]
        n_tiles = tables["rows"].shape[1]
        if n_tiles != P:
            raise ValueError(
                f"tile count {n_tiles} != P = {P}; the tiles must come from "
                "shard_edges_blocked for the same core count")
        dpc = n_dst // P
        ctx.tables, ctx.n_dst, ctx.spc = tables, n_dst, x.shape[1]
        ctx.n_chunks, ctx.topology = n_chunks, topology
        return _topo(topology).fold_pipelined(
            P, n_chunks, lambda xc: _local_partials_blocked(tables, xc, dpc),
            x)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        P = ct.shape[0]
        # mirror schedule, same topology, same waves: all-gather the error
        e_full = _topo(ctx.topology).allgather_pipelined(
            ct.contiguous(), P, ctx.n_chunks)
        # then the column-major walk of the SAME tiles (the flat kernel,
        # roles swapped), every core reading the one error (zero stride)
        dx = _spmm_t_blocked(ctx.tables, e_full.reshape(P, ctx.n_dst, -1),
                             ctx.spc)
        return None, None, None, None, dx


def hypercube_aggregate_pipelined(n_dst: int, rows_b: torch.Tensor,
                                  cols_b: torch.Tensor, vals_b: torch.Tensor,
                                  x: torch.Tensor, n_chunks: int = 1,
                                  topology: str = "hypercube",
                                  groups: Optional[Dict] = None
                                  ) -> torch.Tensor:
    """``y = A @ x`` on stacked cores with the double-buffered schedule:
    the stacked ``spmm_block`` walk fused with the topology's fold.

    Edge tensors are a :class:`BlockEdgeShards` on the device (``[P, B,
    eb]``, int32 indices), ``x`` is ``[P, n_src/P, d]``; returns ``[P,
    n_dst/P, d]``.  ``groups`` holds the walks' groupings and ``t_rows``
    (:func:`block_leaves`); without them they are built on the device.
    Bit-equal to :func:`hypercube_aggregate` on the hypercube, forward and
    backward, for any wave count.
    """
    if groups is None or "perm" not in groups:
        P = x.shape[0]
        groups = tile_groupings(rows_b, cols_b, vals_b, n_dst // P,
                                x.shape[1])
    tables = {**groups, "rows": rows_b, "cols": cols_b, "vals": vals_b}
    return _HypercubeAggregatePipelined.apply(n_dst, int(n_chunks), topology,
                                              tables, x)


# ---------------------------------------------------------------------------
# ell: per-sender pre-reduced ELL plans, walked by the spmm_ell kernel.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EllEdgeShards:
    """Per-sender pre-reduced ELL plans, stacked on a leading core axis.

    ``tables`` has the keys of
    :meth:`repro_torch.kernels.edgeplan.EdgePlan.device_tables` with every
    leaf stacked: ``cols``/``vals`` are per-bucket ``[P, nb, K]`` tables
    over the GLOBAL partial-row space (``dst_core·dpc + B``) with
    sender-local source slots, ``inv`` is ``[P, n_dst]``, and the ``t_*``
    leaves are the column-major mirror (rows = sender-local source slots,
    columns = global error rows).  Bucket capacities and per-bucket row
    counts are shared across senders, so one launch per bucket walks every
    core.  Built once per graph and cached.
    """

    tables: Dict
    n_dst: int
    n_src: int
    n_cores: int

    @property
    def dst_per_core(self) -> int:
        return self.n_dst // self.n_cores

    @property
    def src_per_core(self) -> int:
        return self.n_src // self.n_cores


def _stack_sender_tables(flats, n_rows: int, n_cols: int, caps) -> Dict:
    """Per-sender flat edges → shape-aligned stacked ELL tables (one
    direction).  Two passes: degrees fix the shared capacities and the
    per-bucket row pads, then every sender builds against them; buckets no
    sender uses are dropped."""
    from repro_torch.kernels import edgeplan

    degs = [edgeplan.merged_degrees(r, c, v, n_rows, n_cols)
            for (r, c, v) in flats]
    max_deg = max((int(d.max()) for d in degs if d.size), default=0)
    caps_t = edgeplan.resolve_caps(caps, max_deg)
    caps_arr = np.asarray(caps_t, np.int64)
    nb_pad = np.zeros(len(caps_t), np.int64)
    for d in degs:
        listed = d[d > 0]
        counts = np.bincount(np.searchsorted(caps_arr, listed, side="left"),
                             minlength=len(caps_t))
        nb_pad = np.maximum(nb_pad, counts)
    tabs = [edgeplan.build_tables(r, c, v, n_rows, n_cols, caps=caps_t,
                                  nb_pad=nb_pad.tolist())
            for (r, c, v) in flats]
    keep = [b for b in range(len(caps_t)) if nb_pad[b] > 0]
    return {
        "cols": tuple(np.stack([t.cols[b] for t in tabs]) for b in keep),
        "vals": tuple(np.stack([t.vals[b] for t in tabs]) for b in keep),
        "inv": np.stack([t.inv_perm for t in tabs]),
    }


def shard_edges_ell(coo: COO, n_cores: int, caps=None,
                    merge: str = "dedup") -> EllEdgeShards:
    """Partition a (padded) COO into per-sender pre-reduced ELL plans.

    Same source-core striping as :func:`shard_edges`; each sender's edges
    go through the Index Compressor
    (:func:`repro_torch.core.blockmsg.sender_merge_flat`) and land as
    degree-bucketed ELL tables, forward and column-major.  Cached on the
    COO's identity.  ``merge="redundancy"`` is not ported yet.
    """
    from repro_torch.core.blockmsg import sender_merge_flat
    from repro_torch.kernels import edgeplan

    edgeplan.validate_merge(merge)
    if merge == "redundancy":
        raise NotImplementedError(
            "merge='redundancy' (the virtual-vertex pre-pass) is not ported "
            "yet (ROADMAP, port Queue 1); use merge='dedup'")
    if caps is None:
        from repro_torch.kernels.tune import get_config
        caps = get_config()["caps"]
    caps_key = caps if isinstance(caps, str) else tuple(caps)

    def _build() -> EllEdgeShards:
        blocked = block_partition(coo, n_cores)
        spc = blocked.src_per_core
        fwd_flats = [sender_merge_flat(blocked, j) for j in range(n_cores)]
        bwd_flats = [(c, r, v) for (r, c, v) in fwd_flats]
        tables = _stack_sender_tables(fwd_flats, coo.n_dst, spc, caps)
        bwd = _stack_sender_tables(bwd_flats, spc, coo.n_dst, caps)
        tables.update(t_cols=bwd["cols"], t_vals=bwd["vals"],
                      t_inv=bwd["inv"])
        return EllEdgeShards(tables=tables, n_dst=coo.n_dst,
                             n_src=coo.n_src, n_cores=n_cores)

    return edgeplan.cached(
        edgeplan.coo_key(coo, "ell-shards", n_cores, caps_key, merge),
        (coo.rows, coo.cols, coo.vals), _build)


class _HypercubeAggregateEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n_dst: int, n_chunks: int, topology: str, tables: Dict,
                x: torch.Tensor):
        from repro_torch.kernels.ops import ell_apply

        P = x.shape[0]
        dpc = n_dst // P
        ctx.tables, ctx.n_dst = tables, n_dst
        ctx.n_chunks, ctx.topology = n_chunks, topology
        return _topo(topology).fold_pipelined(
            P, n_chunks,
            lambda xc: ell_apply(tables, xc).view(P, P, dpc, -1), x)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        from repro_torch.kernels.ops import ell_apply

        P, _, d = ct.shape
        # mirror schedule, same topology, same waves: all-gather the error
        e_full = _topo(ctx.topology).allgather_pipelined(
            ct.contiguous(), P, ctx.n_chunks)
        # then the column-major walk of the SAME plan — scatter-free Aᵀ
        dx = ell_apply(ctx.tables, e_full.reshape(P, ctx.n_dst, d),
                       transpose=True)
        return None, None, None, None, dx


def hypercube_aggregate_ell(n_dst: int, tables: Dict, x: torch.Tensor,
                            n_chunks: int = 1,
                            topology: str = "hypercube") -> torch.Tensor:
    """``y = A @ x`` on stacked cores through the pre-reduced ELL plans and
    the double-buffered fold.

    ``tables`` is an :class:`EllEdgeShards`' tables on ``x``'s device
    (``inv``/``t_inv`` as int64), ``x`` is ``[P, n_src/P, d]``; returns
    ``[P, n_dst/P, d]``.  The backward all-gathers the error in mirror
    order and walks the ``t_*`` tables with the same kernel.  Matches
    :func:`hypercube_aggregate` to fp32 roundoff (the merge reorders
    additions).
    """
    return _HypercubeAggregateEll.apply(n_dst, int(n_chunks), topology,
                                        tables, x)
