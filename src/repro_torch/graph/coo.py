"""COO graph containers and adjacency normalization (port of
:mod:`repro.graph.coo`).

Conventions are the reference's: ``rows`` index **destination** nodes,
``cols`` **source** nodes (``y[r] += val * x[c]``), rectangular
adjacencies are first-class, index tensors are ``int32`` and values
``float32``.  A :class:`COO` built by :func:`from_edges` holds CPU tensors:
it is host-side plan input, and the layers move what they need to the
compute device themselves.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class COO:
    """A (possibly rectangular) sparse matrix in COO format.

    Padded entries carry ``val == 0``; they are no-ops for every product.
    """

    rows: torch.Tensor  # [nnz] int32, destination ids
    cols: torch.Tensor  # [nnz] int32, source ids
    vals: torch.Tensor  # [nnz] float32, edge weights (0 == padding)
    n_dst: int
    n_src: int

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def todense(self) -> torch.Tensor:
        dense = torch.zeros((self.n_dst, self.n_src), dtype=self.vals.dtype,
                            device=self.vals.device)
        dense.index_put_((self.rows.long(), self.cols.long()), self.vals,
                         accumulate=True)
        return dense

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """Reference SpMM ``y = A @ x`` via ``index_add_`` (plain oracle;
        on CUDA its atomics add in no fixed order — the served ``coo``
        layer uses :func:`repro_torch.core.gcn.segment_sum_rows`)."""
        gathered = x[self.cols.long()] * self.vals[:, None]
        out = x.new_zeros((self.n_dst, x.shape[1]))
        return out.index_add_(0, self.rows.long(), gathered)

    def rmatmul(self, e: torch.Tensor) -> torch.Tensor:
        """``y = Aᵀ @ e`` without materializing ``Aᵀ``: swap index roles."""
        gathered = e[self.rows.long()] * self.vals[:, None]
        out = e.new_zeros((self.n_src, e.shape[1]))
        return out.index_add_(0, self.cols.long(), gathered)


def pad_coo(coo: COO, nnz_padded: int) -> COO:
    """Pad the edge list to a static size (val=0 ⇒ no-op edges)."""
    if coo.nnz > nnz_padded:
        raise ValueError(f"nnz {coo.nnz} exceeds padded size {nnz_padded}")
    pad = nnz_padded - coo.nnz
    return COO(
        rows=torch.nn.functional.pad(coo.rows, (0, pad)),
        cols=torch.nn.functional.pad(coo.cols, (0, pad)),
        vals=torch.nn.functional.pad(coo.vals, (0, pad)),
        n_dst=coo.n_dst,
        n_src=coo.n_src,
    )


def from_edges(rows, cols, vals, n_dst: int, n_src: int) -> COO:
    return COO(
        rows=torch.as_tensor(np.asarray(rows).astype(np.int32)),
        cols=torch.as_tensor(np.asarray(cols).astype(np.int32)),
        vals=torch.as_tensor(np.asarray(vals).astype(np.float32)),
        n_dst=int(n_dst),
        n_src=int(n_src),
    )


def sym_normalize(rows: np.ndarray, cols: np.ndarray, n: int,
                  add_self_loops: bool = True) -> COO:
    """GCN normalization ``Ã = D̃^{-1/2} (A + I) D̃^{-1/2}`` (square
    graphs), host-side in numpy exactly as the reference computes it."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if add_self_loops:
        loop = np.arange(n, dtype=np.int64)
        rows = np.concatenate([rows, loop])
        cols = np.concatenate([cols, loop])
    deg = np.bincount(rows, minlength=n).astype(np.float64)
    deg_c = np.bincount(cols, minlength=n).astype(np.float64)
    d_r = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    d_c = 1.0 / np.sqrt(np.maximum(deg_c, 1.0))
    vals = d_r[rows] * d_c[cols]
    return from_edges(rows, cols, vals.astype(np.float32), n, n)


def mean_normalize(rows: np.ndarray, cols: np.ndarray,
                   n_dst: int, n_src: int) -> COO:
    """Row-mean normalization ``D^{-1} A`` of a rectangular adjacency."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    deg = np.bincount(rows, minlength=n_dst).astype(np.float64)
    vals = (1.0 / np.maximum(deg, 1.0))[rows]
    return from_edges(rows, cols, vals.astype(np.float32), n_dst, n_src)
