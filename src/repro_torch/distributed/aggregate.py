"""Distributed graph aggregation on stacked cores (port of the ``coo`` and
``ell`` parts of :mod:`repro.distributed.aggregate`).

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
    per-sender edge lists and a segment sum (``index_add_``); the serial
    fold; the oracle.
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

from repro_torch.graph.coo import COO
from repro_torch.graph.partition import block_partition


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


def _segment_walk(dst: torch.Tensor, src: torch.Tensor, vals: torch.Tensor,
                  x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Per core *p*: ``out[p, dst[p, e]] += vals[p, e] · x[p, src[p, e]]``
    — ``[P, n_in, d]`` → ``[P, n_out, d]``, one segment sum over the flat
    stacked row space (``x`` may share one row set across cores through a
    zero core stride)."""
    P, n_in, d = x.shape
    core = torch.arange(P, device=x.device).view(P, 1)
    xs = x.reshape(P * n_in, d)
    gathered = xs.index_select(0, (src + core * n_in).view(-1)) \
        * vals.reshape(-1, 1)
    out = x.new_zeros((P * n_out, d))
    out.index_add_(0, (dst + core * n_out).view(-1), gathered)
    return out.view(P, n_out, d)


class _SenderWalk(torch.autograd.Function):
    """Each core's pre-reduction into per-owner partial rows; its backward
    walks the SAME edges column-major (dst ↔ src roles) — ``Aᵀe`` without
    an ``Aᵀ`` table."""

    @staticmethod
    def forward(ctx, n_dst: int, rows_g: torch.Tensor, cols_l: torch.Tensor,
                vals: torch.Tensor, x: torch.Tensor):
        ctx.save_for_backward(rows_g, cols_l, vals)
        ctx.spc = x.shape[1]
        return _segment_walk(rows_g, cols_l, vals, x, n_dst)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        rows_g, cols_l, vals = ctx.saved_tensors
        dx = _segment_walk(cols_l, rows_g, vals, ct.contiguous(), ctx.spc)
        return None, None, None, None, dx


def hypercube_aggregate(n_dst: int, rows_g: torch.Tensor,
                        cols_l: torch.Tensor, vals: torch.Tensor,
                        x: torch.Tensor, topology: str = "hypercube"
                        ) -> torch.Tensor:
    """``y = A @ x`` on stacked cores via pre-reduce + serial fold.

    Edge tensors are an :class:`EdgeShards` on the device (index tensors
    as int64), ``x`` is ``[P, n_src/P, d]``; returns ``[P, n_dst/P, d]``.
    The backward all-gathers the error rows over ``topology`` and walks
    the same edges column-major.
    """
    from repro_torch.topology import reduce_scatter

    P, _, d = x.shape
    partial = _SenderWalk.apply(n_dst, rows_g, cols_l, vals, x)
    # the mirror backward — all-gather the error rows over the SAME
    # topology — is reduce_scatter's own backward
    return reduce_scatter(topology, P, partial.view(P, P, n_dst // P, d))


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
