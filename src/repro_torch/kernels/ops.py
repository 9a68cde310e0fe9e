"""The ELL walk over a whole plan and its autograd Function, and the COO
walks' padding wrappers (port of :mod:`repro.kernels.ops`' ``ell_apply``,
``ell_aggregate``, ``spmm`` and ``spmm_block``).

:func:`ell_apply` runs the ``spmm_ell`` kernel once over every non-empty
degree bucket (:func:`~repro_torch.kernels.spmm.spmm_ell_walk`), writing
the buckets' rows into one buffer whose last row stays zero, then places
rows by ``inv_perm`` (rows with no edges read that zero row).
``transpose=True`` walks the column-major tables with the same kernel
through ``spmm_ell_t_walk``.  The tables may be one plan's (``[nb, K]``
buckets, ``x`` ``[n_src, d]``) or P stacked sender plans (``[P, nb, K]``
buckets, ``x`` ``[P, n_src, d]``): either way one launch per walk.  The
walk descriptors sit beside the tables under ``walk`` / ``t_walk`` (and
``vv_walk`` / ``vvt_walk``); a table set built without them gets them on
its first walk.  Tables of a redundancy-merged plan (the ``vv_*`` /
``vvt_*`` keys) add one pre-pass walk with the same kernel in each
direction (:func:`ell_apply`).

:class:`EllAggregate` (:func:`ell_aggregate`) is the autograd Function:
forward walks the dst-major tables, backward walks the column-major tables
of the SAME edges with the SAME kernel — no ``Aᵀ``, no transposed
residual, and never autograd through ``index_select`` (whose backward would
be an atomic ``index_add`` scatter).

:func:`spmm` / :func:`spmm_block` keep the reference's padding contract:
the edge axis is padded to a multiple of ``be`` with weight-0 entries whose
column is ``n_src``, past the source range, so padding gathers nothing (a
weight of 0 alone would still read real row 0).  The kernel needs no tile
alignment; the padding is kept so callers of the reference's signature get
the same result through it.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from . import spmm as _spmm
from .spmm import EllWalk, ell_walk, spmm_ell_t_walk, spmm_ell_walk


def _pad_edges(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               n_src: int, be: int):
    """Pad the last (edge) axis to a multiple of ``be``: row 0, column
    ``n_src`` (gathers nothing), weight 0."""
    pad = (-rows.shape[-1]) % be
    if pad == 0:
        return rows, cols, vals
    shape = (*rows.shape[:-1], pad)
    return (torch.cat([rows, rows.new_zeros(shape)], -1),
            torch.cat([cols, cols.new_full(shape, n_src)], -1),
            torch.cat([vals, vals.new_zeros(shape)], -1))


def spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
         x: torch.Tensor, n_dst: int, *, be: int = 256) -> torch.Tensor:
    """Padding wrapper over :func:`repro_torch.kernels.spmm.spmm`: ``y[r]
    += v · x[c]`` over a COO edge list → ``[n_dst, d]``."""
    rows, cols, vals = _pad_edges(rows, cols, vals, x.shape[-2], be)
    return _spmm.spmm(rows, cols, vals, x, n_dst)


def spmm_block(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               x: torch.Tensor, dpc: int, *, be: int = 256) -> torch.Tensor:
    """Padding wrapper over :func:`repro_torch.kernels.spmm.spmm_block`:
    ``[n_blocks, e_blk]`` Block-Message tiles with block-local rows →
    ``[n_blocks·dpc, d]``."""
    rows, cols, vals = _pad_edges(rows, cols, vals, x.shape[-2], be)
    return _spmm.spmm_block(rows, cols, vals, x, dpc)


def _walk_of(tables: Dict, prefix: str) -> EllWalk:
    """The walk descriptor of ``tables``' ``prefix`` table set ("", "t_",
    "vv_" or "vvt_"), built and cached in ``tables`` when it is missing or was built
    for other bucket tensors."""
    cols = tables[prefix + "cols"]
    walk = tables.get(prefix + "walk")
    if walk is None or walk.cols is not cols:
        walk = tables[prefix + "walk"] = ell_walk(cols,
                                                  tables[prefix + "vals"])
    return walk


def _ell_walk(walk: EllWalk, inv: torch.Tensor, x: torch.Tensor,
              kernel: Callable) -> torch.Tensor:
    """One gather-accumulate pass over bucketed ELL tables.

    Output row *r* (of core *p*, for stacked tables) is row ``inv[r]``
    (``inv[p, r]``) of the concatenated bucket outputs plus one zero row.
    """
    d = x.shape[-1]
    lead = tuple(inv.shape[:-1])              # () or (P,)
    total = walk.total
    buf = torch.empty((*lead, total + 1, d), dtype=x.dtype, device=x.device)
    buf[..., total, :].zero_()
    kernel(walk, x, buf[..., :total, :])
    if not lead:
        return buf.index_select(0, inv)
    P = lead[0]
    offs = torch.arange(P, device=inv.device).view(P, 1) * (total + 1)
    flat = buf.view(P * (total + 1), d).index_select(0, (inv + offs).view(-1))
    return flat.view(P, -1, d)


def ell_apply(tables: Dict, x: torch.Tensor, *, transpose: bool = False
              ) -> torch.Tensor:
    """``A @ x`` (or ``Aᵀ @ x`` with ``transpose=True``) through the tables
    of :meth:`repro_torch.kernels.edgeplan.EdgePlan.device_tables` or of a
    stacked :class:`repro_torch.distributed.aggregate.EllEdgeShards`, which
    must lie on ``x``'s device.  No autograd: see :func:`ell_aggregate`.

    Redundancy-merged tables (``vv_*`` / ``vvt_*`` keys) add one pre-pass
    walk of the ``spmm_ell`` kernel: forward computes the virtual partials
    ``z = V x`` and walks the main tables over ``[x; z]`` (rows, dim −2);
    the transpose cuts the extended cotangent at the original source count
    (``vvt_inv``'s last dim) and adds the virtual slice's ``Vᵀ`` expansion,
    a walk counted in ``spmm_ell_t``: ``dx = g[:n_src] + Vᵀ g[n_src:]``.
    On stacked cores each core walks its own virtual rows (a real core
    stride)."""
    merged = "vv_cols" in tables
    if transpose:
        g = _ell_walk(_walk_of(tables, "t_"), tables["t_inv"], x,
                      spmm_ell_t_walk)
        if not merged:
            return g
        n_src = tables["vvt_inv"].shape[-1]
        dz = _ell_walk(_walk_of(tables, "vvt_"), tables["vvt_inv"],
                       g[..., n_src:, :], spmm_ell_t_walk)
        return g[..., :n_src, :] + dz
    if merged:
        z = _ell_walk(_walk_of(tables, "vv_"), tables["vv_inv"], x,
                      spmm_ell_walk)
        x = torch.cat([x, z], dim=-2)
    return _ell_walk(_walk_of(tables, ""), tables["inv"], x, spmm_ell_walk)


class EllAggregate(torch.autograd.Function):
    """``y = A @ x`` through a pre-reduced ELL plan; the backward walks the
    plan's column-major tables (``dx = Aᵀ dy``) with the same kernel.  The
    plan is the only residual: aggregation is linear in ``x``."""

    @staticmethod
    def forward(ctx, tables: Dict, x: torch.Tensor) -> torch.Tensor:
        ctx.tables = tables
        return ell_apply(tables, x)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return None, ell_apply(ctx.tables, ct.contiguous(), transpose=True)


def ell_aggregate(tables: Dict, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``y = A @ x`` (see :class:`EllAggregate`)."""
    return EllAggregate.apply(tables, x)
