"""Naive training dataflow — the comparison baseline (Table 1 rows
CoAg/AgCo; port of :mod:`repro.core.baseline`).

This is the dataflow the paper improves on (and what a mechanical port of
an inference accelerator does for training): during the forward pass it
*precomputes and stores the transposed operands* that backward will need —
``Xᵀ`` (CoAg) or ``(AX)ᵀ`` (AgCo) — and it materializes an ``Aᵀ`` edge
table for backward aggregation.  Costs relative to "Ours" (paper Eqs.
5–8):

    time:    + O(n̄(e+d))   (CoAg)   /  + O(n̄e + nd)   (AgCo)
    storage: + O(e) + O(n̄d)         — one extra edge table + one transposed
                                       feature matrix resident in memory

It pays them on the card as the reference makes XLA pay them (its
``optimization_barrier``): ``Xᵀ`` / ``(AX)ᵀ`` are ``.T.contiguous()``
copies, ``Aᵀ`` is a second device edge table (copied ``cols``/``rows``/
``vals``) that the backward walks with the flat ``spmm`` kernel, and
``Wᵀ`` is materialized in the backward.  The walk's grouping is the Graph
Converter's column order, the cached one the transpose-free layer walks
(:func:`repro_torch.core.gcn._col_grouping`), fetched only where a walk
runs, so the two dataflows differ only in the copies.  The forward
is the ``coo`` layer's (``gemm`` and :func:`segment_sum_rows`), so its
outputs are the same bits, and the gradients match the transpose-free
layer's up to summation order.
"""
from __future__ import annotations

import torch

from repro_torch.graph.coo import COO
from repro_torch.kernels.spmm import spmm

from .gcn import _col_grouping, coo_forward


class _NaiveLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n_dst: int, n_src: int, order: str, activate: bool,
                rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                x: torch.Tensor, w: torch.Tensor):
        A = COO(rows, cols, vals, int(n_dst), int(n_src))
        y, feat, mask = coo_forward(A, order, activate, x, w,
                                    any(ctx.needs_input_grad))
        # Table 1 CoAg stores Xᵀ (O(n̄d)), AgCo (AX)ᵀ (O(nd))
        feat_t = feat.T.contiguous()
        # the second edge table Aᵀ on the device
        t_rows, t_cols, t_vals = (t.to(x.device, copy=True)
                                  for t in (cols, rows, vals))
        ctx.A, ctx.order = A, order
        ctx.save_for_backward(t_rows, t_cols, t_vals, feat_t, w, mask)
        return y

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        t_rows, t_cols, t_vals, feat_t, w, mask = ctx.saved_tensors
        dz = torch.where(mask, ct, 0.0) if mask is not None \
            else ct.contiguous()
        need_x, need_w = ctx.needs_input_grad[7:]
        wt = w.T.contiguous()                # materialized Wᵀ

        def walk_t(e):                       # Aᵀ e via the Aᵀ table
            perm, ptr = (t.to(e.device) for t in _col_grouping(ctx.A))
            return spmm(t_rows, t_cols, t_vals, e, ctx.A.n_src, perm=perm,
                        ptr=ptr)

        dx = dw = None
        if ctx.order == "coag":
            s = walk_t(dz)
            dx = s @ wt if need_x else None
            dw = feat_t @ s if need_w else None            # Xᵀ · S
        else:
            dw = feat_t @ dz if need_w else None           # (AX)ᵀ · dz
            dx = walk_t((dz @ wt).contiguous()) if need_x else None
        return None, None, None, None, None, None, None, dx, dw


#: ``gcn_layer_naive(n_dst, n_src, order, activate, rows, cols, vals, x,
#: w)`` — the reference's signature; the COO tensors may live anywhere
gcn_layer_naive = _NaiveLayer.apply


def gcn_layer_baseline(A: COO, x: torch.Tensor, w: torch.Tensor, *,
                       order: str = "coag", activate: bool = True
                       ) -> torch.Tensor:
    """Public baseline layer (naive transposed-residual dataflow)."""
    if x.shape[0] != A.n_src:
        raise ValueError(f"x rows {x.shape[0]} != A.n_src {A.n_src}")
    if order not in ("coag", "agco"):
        raise ValueError(order)
    return gcn_layer_naive(A.n_dst, A.n_src, order, activate,
                           A.rows, A.cols, A.vals, x, w)


def residual_bytes_naive(order: str, n_dst: int, n_src: int, d: int, h: int,
                         nnz: int, dtype_bytes: int = 4) -> int:
    """Residual bytes of the naive dataflow: transposed feature copy + extra
    Aᵀ edge table (2 int32 + 1 f32 per edge) + Wᵀ copy + mask."""
    feat_t = (n_src * d if order == "coag" else n_dst * d) * dtype_bytes
    edge_table = nnz * (4 + 4 + 4)
    w_t = d * h * dtype_bytes
    mask_bits = n_dst * h
    return feat_t + edge_table + w_t + mask_bits // 8
