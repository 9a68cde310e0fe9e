"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, in the kernel's order of
accumulation, with ordinary tensor operations.  The kernel wrappers
(:mod:`.spmm`, :mod:`.gemm`) run these for CPU tensors, the CPU tests hold
them against the JAX reference, and ``chip_smoke.py`` holds the kernels
against them on the card.  Nothing on the CUDA serving path calls them.
"""
from __future__ import annotations

from typing import Optional

import torch


def spmm_ell_ref(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """``y[r] = Σ_k vals[r, k] · x[cols[r, k]]`` over one ``[nb, K]`` bucket
    (or, for ``P`` stacked cores, ``cols``/``vals`` ``[P, nb, K]`` and ``x``
    ``[P, n_src, d]``, core ``p`` reading ``x[p]``).

    The K-unrolled gather-multiply-add of the reference's XLA twin
    (``repro.kernels.ops._ell_walk``): the accumulator starts at the k = 0
    product and adds the later products in ascending k, each product and
    each sum rounded on its own.  Padding entries (column ``n_src``, or any
    column outside ``[0, n_src)``) read an appended zero row, so they add
    exact zeros and touch no real row.
    """
    n_src, d = x.shape[-2:]
    *lead, nb, K = cols.shape
    if nb == 0 or (lead and lead[0] == 0):
        return x.new_zeros((*lead, nb, d))
    idx = cols.long()
    pad = (idx < 0) | (idx >= n_src)
    if lead:                     # stacked cores: one flat source space
        P = lead[0]
        xz = torch.cat([x.reshape(P * n_src, d), x.new_zeros((1, d))])
        idx = idx + (torch.arange(P, device=idx.device) * n_src).view(P, 1, 1)
        idx = torch.where(pad, P * n_src, idx)
    else:
        xz = torch.cat([x, x.new_zeros((1, d))], dim=0)
        idx = torch.where(pad, n_src, idx)
    acc = xz[idx[..., 0]] * vals[..., 0:1]
    for k in range(1, K):
        acc = acc + xz[idx[..., k]] * vals[..., k:k + 1]
    return acc


def gemm_ref(x: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor] = None, *, relu: bool = False
             ) -> torch.Tensor:
    """``relu(x @ w + bias)`` in fp32, summed over K in ascending order.

    The kernel's contract is that an output row's bits do not depend on how
    many rows share the call; a BLAS ``x @ w`` does not promise that (its
    blocking changes with M), so the plain version sums the K rank-1 terms
    in a fixed order instead: the same order as the kernel, which differs
    only in fusing each multiply-add.
    """
    m, k = x.shape
    n = w.shape[1]
    if k == 0:
        acc = x.new_zeros((m, n))
    else:
        acc = x[:, 0:1] * w[0:1]
        for kk in range(1, k):
            acc = acc + x[:, kk:kk + 1] * w[kk:kk + 1]
    if bias is not None:
        acc = acc + bias
    if relu:
        acc = torch.relu(acc)
    return acc
