"""GCN layer forward (port of the forward half of :mod:`repro.core.gcn`).

    CoAg:  Y = σ( A (X W) )          — combine first (the default)
    AgCo:  Y = σ( (A X) W )          — aggregate first

Every format runs the combination through the port's ``gemm`` kernel,
whose fixed K order makes a row's bits independent of the row count — the
serving path's incremental == cold contract needs that on the card.
Aggregation is per-row deterministic in every format: ``coo`` sums each
row's edges one position at a time (:func:`segment_sum_rows`), ``ell``
walks the plan's buckets with the ``spmm_ell`` kernel, and its backward
(:func:`repro_torch.kernels.ops.ell_aggregate`) walks the transpose tables
with the same kernel; ``block`` walks Block-Message tiles with the
``spmm_block`` kernel, every row in the ``coo`` order (so the two are
bit-equal), and its written backward walks the same tiles column-major
with the flat ``spmm`` kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.coo import COO
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.spmm import spmm, spmm_block

Order = str  # 'coag' | 'agco'


def segment_sum_rows(A: COO, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` with every row summed over its own edges in edge order.

    The deterministic counterpart of the reference's segment-sum: edges are
    stably grouped by row, and step *k* adds the *k*-th edge of every row
    that has one (``index_add_`` over distinct rows, so no two additions
    race).  A row's value therefore depends only on its own edges, on any
    device — CUDA's ``index_add_`` over a whole edge list would add in no
    fixed order.  Zero-weight edges are padding and add nothing.  The host
    prep is numpy on the COO's CPU tensors; the step count is the largest
    row degree.
    """
    rows = A.rows.cpu().numpy().astype(np.int64)
    cols = A.cols.cpu().numpy().astype(np.int64)
    vals = A.vals.cpu().numpy()
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    deg = np.bincount(rows, minlength=A.n_dst)
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int64)
    slot = np.arange(len(rows), dtype=np.int64) - starts[rows]
    by_slot = np.argsort(slot, kind="stable")
    counts = np.bincount(slot) if len(slot) else np.zeros(0, np.int64)
    dev = x.device
    r = torch.from_numpy(rows[by_slot]).to(dev)
    c = torch.from_numpy(cols[by_slot]).to(dev)
    v = torch.from_numpy(vals[by_slot]).to(dev)
    gathered = x[c] * v[:, None]
    out = x.new_zeros((A.n_dst, x.shape[1]))
    off = 0
    for cnt in counts.tolist():
        out.index_add_(0, r[off:off + cnt], gathered[off:off + cnt])
        off += cnt
    return out


def gcn_layer(A: COO, x: torch.Tensor, w: torch.Tensor, *,
              order: Order = "coag", activate: bool = True) -> torch.Tensor:
    """GCN/SAGE-mean layer ``σ(A (X W))`` or ``σ((A X) W)`` over the
    (rectangular) COO of this hop — the ``coo`` format's layer."""
    if x.shape[0] != A.n_src:
        raise ValueError(f"x rows {x.shape[0]} != A.n_src {A.n_src}")
    if order == "coag":
        z = segment_sum_rows(A, gemm(x, w))
        return torch.relu(z) if activate else z
    if order == "agco":
        return gemm(segment_sum_rows(A, x), w, relu=activate)
    raise ValueError(order)


# ---------------------------------------------------------------------------
# Block-layout variant: aggregation through the Block-Message tile kernel.
# ---------------------------------------------------------------------------
def _spmm_blocked(tables, x: torch.Tensor, dpc: int) -> torch.Tensor:
    """``y = A @ x`` through the ``spmm_block`` kernel over per-destination
    tiles with block-local rows (``[B, eb]``, or ``[P, B, eb]`` stacked
    senders), grouped by output row on the host."""
    return spmm_block(tables["rows"], tables["cols"], tables["vals"], x, dpc,
                      perm=tables["perm"], ptr=tables["ptr"])


def _spmm_t_blocked(tables, e: torch.Tensor, n_src: int) -> torch.Tensor:
    """``y = Aᵀ @ e`` walking the SAME tiles column-major: the flat ``spmm``
    kernel with the roles swapped, ``y[c] += v · e[b·dpc + r]`` — no
    ``Aᵀ`` table, no scatter, and ``e`` may be shared by stacked cores
    through a zero core stride."""
    flat = tables["t_rows"].shape
    return spmm(tables["cols"].reshape(flat), tables["t_rows"],
                tables["vals"].reshape(flat), e, n_src,
                perm=tables["t_perm"], ptr=tables["t_ptr"])


class _BlockLayer(torch.autograd.Function):
    """``σ(A (X W))`` (CoAg) or ``σ((A X) W)`` (AgCo) over Block-Message
    tiles, with the reference's written backward: the aggregation's
    cotangent walks the same tiles column-major; the weight and input
    products are plain matmuls."""

    @staticmethod
    def forward(ctx, tables, dpc: int, order: Order, activate: bool,
                x: torch.Tensor, w: torch.Tensor):
        if order == "coag":
            z = _spmm_blocked(tables, gemm(x, w), dpc)
            saved = x
        else:
            saved = _spmm_blocked(tables, x, dpc)
            z = gemm(saved, w)
        ctx.tables, ctx.order, ctx.n_src = tables, order, x.shape[0]
        mask = z > 0 if activate else None
        ctx.save_for_backward(saved, w, mask)
        return torch.relu(z) if activate else z

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        saved, w, mask = ctx.saved_tensors
        dz = torch.where(mask, ct, 0.0) if mask is not None \
            else ct.contiguous()
        if ctx.order == "coag":
            s = _spmm_t_blocked(ctx.tables, dz, ctx.n_src)
            dx, dw = s @ w.T, saved.T @ s
        else:
            dw = saved.T @ dz
            dx = _spmm_t_blocked(ctx.tables, (dz @ w.T).contiguous(),
                                 ctx.n_src)
        return None, None, None, None, dx, dw


def _layer_blocked_impl(layout, x: torch.Tensor, w: torch.Tensor, *,
                        order: Order = "coag", activate: bool = True
                        ) -> torch.Tensor:
    """GCN layer whose aggregation walks Block-Message tiles directly —
    the ``block`` format's layer.  ``layout`` is a
    :class:`repro_torch.core.blockmsg.BlockLayout` (receiver-side tiles:
    block-local rows, global columns, and their row groupings)."""
    if x.shape[0] != layout.n_src:
        raise ValueError(f"x rows {x.shape[0]} != layout.n_src "
                         f"{layout.n_src}")
    if order not in ("coag", "agco"):
        raise ValueError(order)
    return _BlockLayer.apply(layout.device_tables(x.device),
                             layout.tiles.dst_per_core, order, activate, x, w)


def _layer_ell_impl(plan, x: torch.Tensor, w: torch.Tensor, *,
                    order: Order = "coag", activate: bool = True
                    ) -> torch.Tensor:
    """GCN layer whose aggregation walks a pre-reduced ELL plan
    (:func:`repro_torch.kernels.edgeplan.build_plan` output) — the ``ell``
    format's layer."""
    from repro_torch.kernels.ops import ell_aggregate

    if x.shape[0] != plan.n_src:
        raise ValueError(f"x rows {x.shape[0]} != plan.n_src {plan.n_src}")
    tables = plan.device_tables(x.device)
    if order == "coag":
        z = ell_aggregate(tables, gemm(x, w))
        return torch.relu(z) if activate else z
    if order == "agco":
        return gemm(ell_aggregate(tables, x), w, relu=activate)
    raise ValueError(order)
