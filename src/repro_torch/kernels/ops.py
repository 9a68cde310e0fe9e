"""The ELL walk over a whole plan (port of the forward part of
:mod:`repro.kernels.ops`).

:func:`ell_apply` runs the ``spmm_ell`` kernel once per non-empty degree
bucket, writing each bucket's rows into one buffer whose last row stays
zero, then places rows by ``inv_perm`` (rows with no edges read that zero
row).  ``transpose=True`` walks the column-major tables with the same
kernel — the training slice's backward.  The ``torch.autograd.Function``
around it comes with that slice.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from .spmm import spmm_ell


def _ell_walk(cols_list: Sequence[torch.Tensor],
              vals_list: Sequence[torch.Tensor], inv: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """One gather-accumulate pass over bucketed ELL tables.

    Output row *r* is row ``inv[r]`` of the concatenated bucket outputs
    plus one zero row; empty buckets are skipped, never launched.
    """
    d = x.shape[-1]
    total = sum(int(c.shape[0]) for c in cols_list)
    buf = torch.empty((total + 1, d), dtype=x.dtype, device=x.device)
    buf[total].zero_()
    base = 0
    for c, v in zip(cols_list, vals_list):
        nb = int(c.shape[0])
        if nb:
            spmm_ell(c, v, x, out=buf[base:base + nb])
        base += nb
    return buf.index_select(0, inv)


def ell_apply(tables: Dict, x: torch.Tensor, *, transpose: bool = False
              ) -> torch.Tensor:
    """``A @ x`` (or ``Aᵀ @ x`` with ``transpose=True``) through the tables
    of :meth:`repro_torch.kernels.edgeplan.EdgePlan.device_tables`, which
    must lie on ``x``'s device."""
    if transpose:
        return _ell_walk(tables["t_cols"], tables["t_vals"], tables["t_inv"],
                         x)
    return _ell_walk(tables["cols"], tables["vals"], tables["inv"], x)
