"""The ELL walk over a whole plan and its autograd Function, and the COO
walks' padding wrappers (port of :mod:`repro.kernels.ops`' ``ell_apply``,
``ell_aggregate``, ``spmm`` and ``spmm_block``).

:func:`ell_apply` runs the ``spmm_ell`` kernel once per non-empty degree
bucket, writing each bucket's rows into one buffer whose last row stays
zero, then places rows by ``inv_perm`` (rows with no edges read that zero
row).  ``transpose=True`` walks the column-major tables with the same
kernel through its ``spmm_ell_t`` wrapper.  The tables may be one plan's
(``[nb, K]`` buckets, ``x`` ``[n_src, d]``) or P stacked sender plans
(``[P, nb, K]`` buckets, ``x`` ``[P, n_src, d]``): either way one launch
per non-empty bucket.

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

from typing import Callable, Dict, Sequence

import torch

from . import spmm as _spmm
from .spmm import spmm_ell, spmm_ell_t


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


def _ell_walk(cols_list: Sequence[torch.Tensor],
              vals_list: Sequence[torch.Tensor], inv: torch.Tensor,
              x: torch.Tensor, kernel: Callable) -> torch.Tensor:
    """One gather-accumulate pass over bucketed ELL tables.

    Output row *r* (of core *p*, for stacked tables) is row ``inv[r]``
    (``inv[p, r]``) of the concatenated bucket outputs plus one zero row;
    empty buckets are skipped, never launched.
    """
    d = x.shape[-1]
    lead = tuple(inv.shape[:-1])              # () or (P,)
    total = sum(int(c.shape[-2]) for c in cols_list)
    buf = torch.empty((*lead, total + 1, d), dtype=x.dtype, device=x.device)
    buf[..., total, :].zero_()
    base = 0
    for c, v in zip(cols_list, vals_list):
        nb = int(c.shape[-2])
        if nb:
            kernel(c, v, x, out=buf[..., base:base + nb, :])
        base += nb
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
    must lie on ``x``'s device.  No autograd: see :func:`ell_aggregate`."""
    if transpose:
        return _ell_walk(tables["t_cols"], tables["t_vals"], tables["t_inv"],
                         x, spmm_ell_t)
    return _ell_walk(tables["cols"], tables["vals"], tables["inv"], x,
                     spmm_ell)


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
