"""Topology base class, the exchange plan and the differentiable exchange
primitives (port of :mod:`repro.topology.base`) on the stacked-core layout.

The paper's P on-chip cores are a leading core axis of one tensor on one
GPU: per-owner partial rows are ``[P, P, t, ...]`` (sender core, owner
core, rows) and an owned block is ``[P, t, ...]``.  A :class:`Topology`
owns the collectives over that axis —

  * :meth:`Topology.reduce_scatter` — fold ``[P, P, t, ...]`` partials
    down to each core's fully reduced ``[P, t, ...]`` block;
  * :meth:`Topology.allgather` — the mirror: every core gets all blocks in
    core order, ``[P, t, ...] → [P, P, t, ...]``;
  * the feature-wave variants (:func:`repro_torch.core.schedule.
    feature_waves`): :meth:`Topology.reduce_scatter_pipelined`,
    :meth:`Topology.allgather_pipelined` and
    :meth:`Topology.fold_pipelined`, the fused local walk + exchange.  The
    defaults run one serial collective per wave; the hypercube overrides
    them with its double-buffered fold and a zero-stride gather.

A round's ``ppermute`` is an index permutation of the core axis: core
``p`` receives what core ``src[p]`` sends.  :meth:`Topology.plan` is the
host-side accounting of one reduce-scatter (:class:`ExchangePlan`).

Module-level :func:`reduce_scatter` / :func:`allgather` are autograd
Functions that are each other's backward (the mirror contract), and
:func:`exchange` is the plan-driven spelling of both.  Topologies register
through :func:`repro_torch.engine.registry.register_topology`; the four
built-ins are registered by :mod:`repro_torch.topology`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.schedule import feature_waves


def _waves(x: torch.Tensor, n_chunks: int):
    return [x[..., w.start:w.stop]
            for w in feature_waves(x.shape[-1], n_chunks)]


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """One topology's per-step exchange plan for a fixed core count.

    ``steps`` is the number of serialized rounds of one reduce-scatter (=
    one all-gather); ``bytes_per_core`` the wire bytes each core ships per
    reduce-scatter of ``n_rows`` rows × ``d`` features; ``max_step_rows``
    the largest single message (rows) any step puts on a wire;
    ``link_parallelism`` how many disjoint link sets the schedule keeps
    busy at once (torus2d's orthogonal halves: 2.0);
    ``predicted_seconds`` the planner cost model's estimate when a
    :class:`repro_torch.engine.planner.CostModel` was handed to
    :meth:`Topology.plan`.  Host-side accounting only; on one card the
    "wire" is a copy on the device.
    """

    topology: str
    n_cores: int
    steps: int
    bytes_per_core: int
    max_step_rows: int
    link_parallelism: float = 1.0
    predicted_seconds: Optional[float] = None


class Topology:
    """Base class for registered interconnects (module docstring).
    Subclasses implement :meth:`steps`, :meth:`reduce_scatter` and
    :meth:`allgather`; ``name`` is set by ``register_topology``."""

    name: str = "?"
    description: str = ""
    #: disjoint link sets the schedule keeps busy at once (torus2d: 2.0)
    link_parallelism: float = 1.0

    # -- plan (host side) ----------------------------------------------------
    def validate_cores(self, n_cores: int) -> None:
        """Raise ``ValueError`` unless ``n_cores`` is a power of two."""
        if n_cores < 1 or n_cores & (n_cores - 1):
            raise ValueError(
                f"the {self.name} topology needs a power-of-two core "
                f"count, got {n_cores}")

    def steps(self, n_cores: int) -> int:
        """Serialized exchange rounds per reduce-scatter."""
        raise NotImplementedError

    def bytes_per_core(self, n_rows: int, d: int, n_cores: int,
                       dtype_bytes: int = 4) -> int:
        """Wire bytes each core ships per reduce-scatter of ``n_rows``
        pre-reduced rows: the bandwidth-optimal ``n_rows·(1 − 1/P)``."""
        if n_cores <= 1:
            return 0
        return int(n_rows * (n_cores - 1) // n_cores) * d * dtype_bytes

    def max_step_rows(self, n_rows: int, n_cores: int) -> int:
        """Largest single-step message, in rows (default: one core block)."""
        return n_rows // n_cores if n_cores > 1 else 0

    def plan(self, n_rows: int, d: int, n_cores: int, dtype_bytes: int = 4,
             cost_model=None, wire_rows: Optional[int] = None
             ) -> ExchangePlan:
        """The exchange plan of one reduce-scatter over ``n_cores``.

        ``cost_model`` (duck-typed on ``.predict(plan)``) fills
        ``predicted_seconds``; without one it stays ``None``.
        ``wire_rows`` is the measured post-merge wire content, in partial
        rows across all cores (:func:`repro_torch.graph.partition.
        exchange_rows`); it rescales ``bytes_per_core`` by its ratio to the
        worst case where every row crosses from every non-owner core.
        """
        self.validate_cores(n_cores)
        bpc = self.bytes_per_core(n_rows, d, n_cores, dtype_bytes)
        if wire_rows is not None and n_cores > 1:
            dense_rows = n_rows * (n_cores - 1)
            bpc = int(round(bpc * min(wire_rows / max(dense_rows, 1), 1.0)))
        plan = ExchangePlan(
            topology=self.name, n_cores=n_cores, steps=self.steps(n_cores),
            bytes_per_core=bpc,
            max_step_rows=self.max_step_rows(n_rows, n_cores),
            link_parallelism=self.link_parallelism)
        if cost_model is not None:
            plan = dataclasses.replace(
                plan, predicted_seconds=float(cost_model.predict(plan)))
        return plan

    # -- collectives over the core axis --------------------------------------
    def reduce_scatter(self, partial: torch.Tensor,
                       n_cores: int) -> torch.Tensor:
        """``[P, P, t, ...]`` partials → ``[P, t, ...]`` owned blocks."""
        raise NotImplementedError

    def allgather(self, x: torch.Tensor, n_cores: int) -> torch.Tensor:
        """``[P, t, ...]`` → ``[P, P, t, ...]``, blocks in core order."""
        raise NotImplementedError

    def reduce_scatter_pipelined(self, partial: torch.Tensor, n_cores: int,
                                 n_chunks: int) -> torch.Tensor:
        """:meth:`reduce_scatter` in ``n_chunks`` feature waves, one serial
        fold per wave (the same per-element add order)."""
        chunks = _waves(partial, n_chunks)
        if len(chunks) == 1:
            return self.reduce_scatter(partial, n_cores)
        return torch.cat([self.reduce_scatter(c, n_cores) for c in chunks],
                         dim=-1)

    def allgather_pipelined(self, x: torch.Tensor, n_cores: int,
                            n_chunks: int) -> torch.Tensor:
        """:meth:`allgather` in ``n_chunks`` feature waves (the mirror of
        :meth:`fold_pipelined`; the backward's gather)."""
        chunks = _waves(x, n_chunks)
        if len(chunks) == 1:
            return self.allgather(x, n_cores)
        return torch.cat([self.allgather(c, n_cores) for c in chunks],
                         dim=-1)

    def fold_pipelined(self, n_cores: int, n_chunks: int, partials_fn,
                       x: torch.Tensor) -> torch.Tensor:
        """Fused local walk + reduce-scatter, one feature wave at a time:
        ``partials_fn(x_wave) -> [P, P, t, dc]`` (called once per wave);
        returns ``[P, t, d]``."""
        waves = _waves(x, n_chunks)
        if len(waves) == 1:
            return self.reduce_scatter(partials_fn(x), n_cores)
        return torch.cat([self.reduce_scatter(partials_fn(xc), n_cores)
                          for xc in waves], dim=-1)


def gather_in_core_order(blocks) -> torch.Tensor:
    """The all-gather's final reorder: ``blocks[k]`` is ``[P, t, ...]``
    holding, on core ``p``, the block of core ``(p - k) mod P`` (the ring
    and the rotations deliver blocks so); returns ``[P, P, t, ...]`` with
    every core's blocks in core order."""
    stacked = torch.stack(blocks, dim=1)          # [P, k, t, ...]
    P = stacked.shape[0]
    cores = torch.arange(P, device=stacked.device)
    order = (cores.view(P, 1) - cores.view(1, P)) % P
    return stacked[cores.view(P, 1), order]


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


def exchange(x: torch.Tensor, plan: ExchangePlan,
             op: str = "reduce_scatter") -> torch.Tensor:
    """One differentiable exchange under ``plan`` (:meth:`Topology.plan`):
    ``"reduce_scatter"`` folds partials to the owned blocks,
    ``"allgather"`` replicates the owned blocks."""
    if op == "reduce_scatter":
        return reduce_scatter(plan.topology, plan.n_cores, x)
    if op == "allgather":
        return allgather(plan.topology, plan.n_cores, x)
    raise ValueError(f"unknown exchange op {op!r}; "
                     "expected 'reduce_scatter' or 'allgather'")
