"""Graph Converter — row-major ⇄ column-major COO re-sorting (paper §4.1;
port of :mod:`repro.graph.convert`).

The accelerator stores each adjacency block exactly once (COO, diagonal
storage) and *re-sorts* it between the forward pass (row-major: aggregate
into destination rows) and the backward pass (column-major: aggregate into
source columns, i.e. multiply by Aᵀ) instead of storing an edge table
twice.  The sort keys are the reference's (``np.lexsort``), so both
packages give the same arrays.
"""
from __future__ import annotations

import numpy as np

from .coo import COO, from_edges


def _sorted(coo: COO, order: np.ndarray) -> COO:
    rows, cols, vals = (t.cpu().numpy() for t in (coo.rows, coo.cols,
                                                  coo.vals))
    return from_edges(rows[order], cols[order], vals[order], coo.n_dst,
                      coo.n_src)


def sort_row_major(coo: COO) -> COO:
    """Sort edges by (row, col) — forward aggregation order."""
    return _sorted(coo, np.lexsort((coo.cols.cpu().numpy(),
                                    coo.rows.cpu().numpy())))


def sort_col_major(coo: COO) -> COO:
    """Sort edges by (col, row) — backward aggregation order (Aᵀ walk)."""
    return _sorted(coo, np.lexsort((coo.rows.cpu().numpy(),
                                    coo.cols.cpu().numpy())))


def to_backward(coo_row_major: COO) -> COO:
    """The backward-order view WITHOUT transposing: same edges,
    column-major sort.  No new edge table, no (n_src × n_dst) object.  The
    training backward walks this order with the flat ``spmm`` kernel
    (:func:`repro_torch.core.gcn._spmm_t`), each column in a fixed order."""
    return sort_col_major(coo_row_major)
