"""Hypercube topology — the paper's 4-D NoC as dimension-ordered folds
(port of :mod:`repro.topology.hypercube`) on the stacked-core layout.

``log₂P`` rounds, high bit first.  A round's pairwise ``ppermute`` along
dimension ``b`` is the index permutation ``arange(P) ^ (1 << b)`` of the
core axis: core ``p`` receives what core ``p ^ (1 << b)`` sends.  Each core
keeps the half of its buffer whose owner bit ``b`` matches its own and adds
the half its partner sends, ``mine + recv``: the reference's fold order,
so the fp32 results are the reference's schedule's.
"""
from __future__ import annotations

import torch

from repro_torch.core.schedule import feature_waves
from repro_torch.distributed.overlap import double_buffered_rounds

from .base import Topology


def _round(b: int):
    """The ``(split, permute)`` pair of one fold round over dimension
    ``b``: ``split`` takes a ``[P, 2h, ...]`` buffer to each core's kept
    half and the half it sends (``[P, h, ...]`` each, by the core's bit
    ``b``); ``permute`` delivers each core's send to its partner across
    dimension ``b``."""
    def split(buf):
        P = buf.shape[0]
        cores = torch.arange(P, device=buf.device)
        bit = (cores >> b) & 1
        halves = buf.reshape(P, 2, buf.shape[1] // 2, *buf.shape[2:])
        return halves[cores, bit], halves[cores, 1 - bit]

    def permute(send):
        cores = torch.arange(send.shape[0], device=send.device)
        return send[cores ^ (1 << b)]

    return split, permute


def _ndim(n_cores: int) -> int:
    return max(n_cores.bit_length() - 1, 0)


def hypercube_reduce_scatter(partial: torch.Tensor,
                             n_cores: int) -> torch.Tensor:
    """Fold ``[P, P, t, ...]`` per-owner partials across the hypercube,
    high dimension first: after round *b* every core holds the blocks whose
    owner agrees with it on bits ≥ *b*; returns ``[P, t, ...]``."""
    bufs = double_buffered_rounds(
        [partial], [_round(b) for b in reversed(range(_ndim(n_cores)))])
    return bufs[0][:, 0]


def hypercube_allgather(x: torch.Tensor, n_cores: int) -> torch.Tensor:
    """Mirror schedule: ``log₂P`` doubling rounds, low dimension first;
    every core ends with all ``[P, t, ...]`` blocks in core order."""
    P = x.shape[0]
    cores = torch.arange(P, device=x.device)
    buf = x.unsqueeze(1)
    for b in range(_ndim(n_cores)):
        other = buf[cores ^ (1 << b)]
        first = (((cores >> b) & 1) == 0).view(P, *([1] * (buf.dim() - 1)))
        buf = torch.where(first, torch.cat([buf, other], 1),
                          torch.cat([other, buf], 1))
    return buf


def hypercube_allgather_pipelined(x: torch.Tensor,
                                  n_cores: int) -> torch.Tensor:
    """The backward's gather as one all-gather (the reference lowers each
    wave to the native ``all_gather``): every core sees the same blocks in
    core order, so on stacked cores it is a zero-stride view of ``x`` —
    no copy, bit-identical to :func:`hypercube_allgather`."""
    return x.unsqueeze(0).expand(n_cores, *x.shape)


def hypercube_fold_pipelined(n_cores: int, n_chunks: int, partials_fn,
                             x: torch.Tensor) -> torch.Tensor:
    """Fused local walk + double-buffered fold: per feature wave, the
    partials ``partials_fn(x_wave) -> [P, P, dpc, dc]`` are computed and
    the first (top-bit) round's send issued before the next wave's walk;
    the remaining rounds run double-buffered.  Returns ``[P, dpc, d]``."""
    # each wave's walk is produced lazily, so the top-bit round issues one
    # wave's send before the next wave's walk runs
    walks = (partials_fn(x[..., w.start:w.stop])
             for w in feature_waves(x.shape[-1], n_chunks))
    bufs = double_buffered_rounds(
        walks, [_round(b) for b in reversed(range(_ndim(n_cores)))])
    return torch.cat([b[:, 0] for b in bufs], dim=-1)


class HypercubeTopology(Topology):
    """log₂P dimension-ordered folds — the paper's 4-D NoC and the fp32
    oracle schedule."""

    def reduce_scatter(self, partial, n_cores):
        return hypercube_reduce_scatter(partial, n_cores)

    def allgather(self, x, n_cores):
        return hypercube_allgather(x, n_cores)

    def allgather_pipelined(self, x, n_cores, n_chunks):
        return hypercube_allgather_pipelined(x, n_cores)

    def fold_pipelined(self, n_cores, n_chunks, partials_fn, x):
        return hypercube_fold_pipelined(n_cores, n_chunks, partials_fn, x)
