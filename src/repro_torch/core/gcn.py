"""GCN layer forward (port of the forward half of :mod:`repro.core.gcn`).

    CoAg:  Y = σ( A (X W) )          — combine first (the default)
    AgCo:  Y = σ( (A X) W )          — aggregate first

Both formats run the combination through the port's ``gemm`` kernel, whose
fixed K order makes a row's bits independent of the row count — the
serving path's incremental == cold contract needs that on the card.
Aggregation is per-row deterministic in both formats: ``coo`` sums each
row's edges one position at a time (:func:`segment_sum_rows`), ``ell``
walks the plan's buckets with the ``spmm_ell`` kernel, and its backward
(:func:`repro_torch.kernels.ops.ell_aggregate`) walks the transpose tables
with the same kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.coo import COO
from repro_torch.kernels.gemm import gemm

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
