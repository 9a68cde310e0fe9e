"""2-D torus topology — the paper's orthogonal row/column multicast (port
of :mod:`repro.topology.torus2d`) on the stacked-core layout.

Cores sit on an ``R × C`` grid (``core = r·C + c``; ``C`` takes the extra
bit when ``log₂P`` is odd) with links only along rows and columns.  The
feature dimension splits in half (``⌊d/2⌋`` / ``⌈d/2⌉``) and the halves
fold along orthogonal dimension orders —

  * half A folds the column dimensions first, then the rows;
  * half B folds the row dimensions first, then the columns —

each through :func:`repro_torch.topology.hypercube.fold_bits`, so at every
step one half rides row links while the other rides column links.  Steps
stay ``log₂P``, bytes the optimal ``n_rows·(1 − 1/P)``; the fp32 results
are the reference's (the same bit orders, the same adds).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .base import Topology
from .hypercube import fold_bits, unfold_bits


def grid_shape(n_cores: int) -> Tuple[int, int]:
    """``(R, C)`` of the torus grid; C gets the extra dimension when
    ``log₂P`` is odd (a 2-core torus is one row of 2)."""
    ndim = max(n_cores.bit_length() - 1, 0)
    nr_bits = ndim // 2
    return 1 << nr_bits, 1 << (ndim - nr_bits)


def _bit_orders(n_cores: int) -> Tuple[List[int], List[int]]:
    """(cols-first, rows-first) dimension orders — the orthogonal pair."""
    ndim = max(n_cores.bit_length() - 1, 0)
    nc_bits = ndim - ndim // 2
    col_bits = list(reversed(range(nc_bits)))          # low bits: c
    row_bits = list(reversed(range(nc_bits, ndim)))    # high bits: r
    return col_bits + row_bits, row_bits + col_bits


def _split(x: torch.Tensor):
    d = x.shape[-1]
    return (x[..., : d // 2], x[..., d // 2:]) if d >= 2 else (None, x)


class Torus2DTopology(Topology):
    """R×C torus: orthogonal row/column two-phase multicast, both link
    sets busy every step."""

    description = ("2-D torus (R x C grid): feature halves fold along "
                   "orthogonal dimension orders in parallel — row links "
                   "and column links busy simultaneously")
    link_parallelism = 2.0

    def steps(self, n_cores):
        return max(n_cores.bit_length() - 1, 0)

    def max_step_rows(self, n_rows, n_cores):
        # full-feature row equivalents: past P = 2 the halves ride disjoint
        # link classes (n/4 rows a wire); at P = 2 they share one (n/2)
        if n_cores <= 1:
            return 0
        return n_rows // 2 if n_cores == 2 else n_rows // 4

    def reduce_scatter(self, partial, n_cores):
        if n_cores == 1:
            return partial[:, 0]
        order_a, order_b = _bit_orders(n_cores)
        half_a, half_b = _split(partial)
        if half_a is None:        # a single feature column: one fold
            return fold_bits(partial, n_cores, order_a)
        return torch.cat([fold_bits(half_a, n_cores, order_a),
                          fold_bits(half_b, n_cores, order_b)], dim=-1)

    def allgather(self, x, n_cores):
        if n_cores == 1:
            return x.unsqueeze(1)
        order_a, order_b = _bit_orders(n_cores)
        half_a, half_b = _split(x)
        if half_a is None:
            return unfold_bits(x, n_cores, order_a)
        return torch.cat([unfold_bits(half_a, n_cores, order_a),
                          unfold_bits(half_b, n_cores, order_b)], dim=-1)
