"""The ELL walk over a whole plan and its autograd Function (port of
:mod:`repro.kernels.ops`' ``ell_apply`` and ``ell_aggregate``).

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
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from .spmm import spmm_ell, spmm_ell_t


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
