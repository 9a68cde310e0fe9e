"""Topology base class and the differentiable exchange primitives (port of
:mod:`repro.topology.base`) on the stacked-core layout.

The paper's P on-chip cores are a leading core axis of one tensor on one
GPU: per-owner partial rows are ``[P, P, t, ...]`` (sender core, owner
core, rows) and an owned block is ``[P, t, ...]``.  A :class:`Topology`
owns the collectives over that axis —

  * :meth:`Topology.reduce_scatter` — fold ``[P, P, t, ...]`` partials
    down to each core's fully reduced ``[P, t, ...]`` block;
  * :meth:`Topology.allgather` — the mirror: every core gets all blocks in
    core order, ``[P, t, ...] → [P, P, t, ...]``;
  * :meth:`Topology.fold_pipelined`, the fused local walk + exchange in
    feature waves (:func:`repro_torch.core.schedule.feature_waves`), and
    its mirror :meth:`Topology.allgather_pipelined`.

Module-level :func:`reduce_scatter` / :func:`allgather` are autograd
Functions that are each other's backward (the mirror contract): gradients
ride the mirror schedule of the forward's interconnect, and no transposed
exchange schedule exists.  The ``coo`` aggregate folds through
:func:`reduce_scatter`; the fused ``ell`` aggregate writes the same mirror
into its own backward.  Only ``hypercube`` is registered in the port;
the registry names the other interconnects and raises for them.
"""
from __future__ import annotations

import torch


class Topology:
    """Base class for registered interconnects (module docstring).
    Subclasses implement the four collectives; ``name`` is set by
    ``register_topology``."""

    name: str = "?"

    def validate_cores(self, n_cores: int) -> None:
        """Raise ``ValueError`` unless ``n_cores`` is a power of two."""
        if n_cores < 1 or n_cores & (n_cores - 1):
            raise ValueError(
                f"the {self.name} topology needs a power-of-two core "
                f"count, got {n_cores}")

    # -- collectives over the core axis --------------------------------------
    def reduce_scatter(self, partial: torch.Tensor,
                       n_cores: int) -> torch.Tensor:
        """``[P, P, t, ...]`` partials → ``[P, t, ...]`` owned blocks."""
        raise NotImplementedError

    def allgather(self, x: torch.Tensor, n_cores: int) -> torch.Tensor:
        """``[P, t, ...]`` → ``[P, P, t, ...]``, blocks in core order."""
        raise NotImplementedError

    def allgather_pipelined(self, x: torch.Tensor, n_cores: int,
                            n_chunks: int) -> torch.Tensor:
        """:meth:`allgather` in ``n_chunks`` feature waves (the mirror of
        :meth:`fold_pipelined`; the backward's gather)."""
        raise NotImplementedError

    def fold_pipelined(self, n_cores: int, n_chunks: int, partials_fn,
                       x: torch.Tensor) -> torch.Tensor:
        """Fused local walk + reduce-scatter, one feature wave at a time:
        ``partials_fn(x_wave) -> [P, P, t, dc]``; returns ``[P, t, d]``."""
        raise NotImplementedError


def _topo(name: str) -> Topology:
    from repro_torch.engine.registry import get_topology
    return get_topology(name)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, topology: str, n_cores: int, partial: torch.Tensor):
        ctx.topology, ctx.n_cores = topology, n_cores
        return _topo(topology).reduce_scatter(partial, n_cores)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return None, None, _topo(ctx.topology).allgather(ct, ctx.n_cores)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, topology: str, n_cores: int, x: torch.Tensor):
        ctx.topology, ctx.n_cores = topology, n_cores
        return _topo(topology).allgather(x, n_cores)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return None, None, _topo(ctx.topology).reduce_scatter(ct,
                                                              ctx.n_cores)


def reduce_scatter(topology: str, n_cores: int,
                   partial: torch.Tensor) -> torch.Tensor:
    """Differentiable ``[P, P, t, ...] → [P, t, ...]`` fold over
    ``topology``; its backward is the same topology's :func:`allgather`."""
    return _ReduceScatter.apply(topology, n_cores, partial)


def allgather(topology: str, n_cores: int, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``[P, t, ...] → [P, P, t, ...]`` gather over
    ``topology``; its backward is the same topology's
    :func:`reduce_scatter`."""
    return _AllGather.apply(topology, n_cores, x)
