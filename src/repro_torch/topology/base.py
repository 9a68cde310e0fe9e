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

Across processes (a ``torch.distributed`` mesh, :mod:`repro_torch.
distributed.sharding`) each rank stacks a contiguous range of the cores:
a :class:`CoreLayout` says which, and the collectives take it as
``layout=``.  ``None`` (or a layout of one rank) is the stacked layout
above, every core here.  Across ranks every built-in runs its own
schedule: a round whose partner core lives on another rank is a
point-to-point transfer (:func:`post_p2p`) of exactly what the stacked
round moves, added in the stacked order, so each rank's rows are the
stacked call's bits; an all-gather moves bytes only and is one
all-gather of the ranks' blocks (:func:`gather_every_core`).  A topology
registered without rank rounds keeps ``crosses_ranks = False`` and
refuses a layout of more than one rank (:meth:`Topology.check_layout`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

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


@dataclasses.dataclass(frozen=True)
class CoreLayout:
    """Where this process's cores sit among the ``n_cores``: cores
    ``[first, first + count)``, stacked on a leading axis here, one equal
    contiguous range per rank of ``group`` in rank order (rank ``r`` holds
    ``[r · count, (r + 1) · count)``)."""

    n_cores: int
    first: int
    count: int
    group: Any = None

    @property
    def world(self) -> int:
        return self.n_cores // self.count

    @property
    def rank(self) -> int:
        return self.first // self.count

    def block(self, n: int) -> slice:
        """This rank's contiguous share of a leading axis of ``n`` split
        into ``n_cores`` equal blocks: blocks ``[first, first + count)``."""
        if n % self.n_cores:
            raise ValueError(f"leading axis of {n} does not split over "
                             f"{self.n_cores} cores")
        per = n // self.n_cores
        return slice(self.first * per, (self.first + self.count) * per)

    def peer(self, rank: int) -> int:
        """The global rank of ``group``'s rank ``rank``."""
        import torch.distributed as dist
        return dist.get_global_rank(self.group, rank)


def gather_ranks(x: torch.Tensor, layout: CoreLayout) -> torch.Tensor:
    """Every rank's ``[count, ...]`` blocks in core order, ``[n_cores,
    ...]``: one all-gather over the layout's group (``all_gather_single``,
    or ``all_gather_into_tensor`` where torch lacks it)."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty((layout.n_cores, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x, group=layout.group)
    return out


def gather_every_core(x: torch.Tensor, layout: CoreLayout) -> torch.Tensor:
    """The all-gather across ranks: every rank's ``[count, ...]`` blocks in
    core order, seen by each local core — ``[count, n_cores, ...]``, a
    zero-stride view of one :func:`gather_ranks` (the stacked gathers'
    bits: a gather only copies)."""
    full = gather_ranks(x, layout)
    return full.unsqueeze(0).expand(x.shape[0], *full.shape)


def post_p2p(layout: CoreLayout, sends, recvs):
    """Post one batch of point-to-point transfers over the layout's group:
    ``sends`` and ``recvs`` are ``[(tensor, rank)]`` with ranks of the
    group, every receive buffer allocated by the caller.  Returns the
    requests (``batch_isend_irecv``); two messages between one pair of
    ranks match in the order both post them."""
    import torch.distributed as dist

    ops = [dist.P2POp(dist.isend, t.contiguous(), layout.peer(r),
                      layout.group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, layout.peer(r), layout.group)
            for t, r in recvs]
    return dist.batch_isend_irecv(ops) if ops else []


def spans_ranks(layout: Optional[CoreLayout]) -> Optional[CoreLayout]:
    """``layout`` when it spreads the cores over more than one rank, else
    ``None`` (all cores stacked here: the single-process path)."""
    return layout if layout is not None and layout.world > 1 else None


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

    #: whether the collectives take a ``layout`` across ranks (every
    #: built-in does; a registered topology opts in by setting it and
    #: taking ``layout=None`` in :meth:`reduce_scatter` and
    #: :meth:`allgather`)
    crosses_ranks: bool = False

    def check_layout(self, layout: Optional[CoreLayout]) -> None:
        """Raise ``NotImplementedError`` for a layout over several ranks
        unless this topology runs its rounds across ranks."""
        if spans_ranks(layout) is not None and not self.crosses_ranks:
            raise NotImplementedError(
                f"the {self.name} topology has no rounds across ranks "
                f"(crosses_ranks is False), so it cannot spread "
                f"{layout.n_cores} cores over {layout.world} ranks; set "
                "crosses_ranks and take layout= in its collectives")

    # -- collectives over the core axis --------------------------------------
    def reduce_scatter(self, partial: torch.Tensor,
                       n_cores: int) -> torch.Tensor:
        """``[P, P, t, ...]`` partials → ``[P, t, ...]`` owned blocks."""
        raise NotImplementedError

    def allgather(self, x: torch.Tensor, n_cores: int) -> torch.Tensor:
        """``[P, t, ...]`` → ``[P, P, t, ...]``, blocks in core order."""
        raise NotImplementedError

    def reduce_scatter_pipelined(self, partial: torch.Tensor, n_cores: int,
                                 n_chunks: int,
                                 layout: Optional[CoreLayout] = None
                                 ) -> torch.Tensor:
        """:meth:`reduce_scatter` in ``n_chunks`` feature waves, one serial
        fold per wave (the same per-element add order); ``layout`` is
        passed on."""
        kw = _layout_kw(layout)
        chunks = _waves(partial, n_chunks)
        if len(chunks) == 1:
            return self.reduce_scatter(partial, n_cores, **kw)
        return torch.cat([self.reduce_scatter(c, n_cores, **kw)
                          for c in chunks], dim=-1)

    def allgather_pipelined(self, x: torch.Tensor, n_cores: int,
                            n_chunks: int,
                            layout: Optional[CoreLayout] = None
                            ) -> torch.Tensor:
        """:meth:`allgather` in ``n_chunks`` feature waves (the mirror of
        :meth:`fold_pipelined`; the backward's gather)."""
        kw = _layout_kw(layout)
        chunks = _waves(x, n_chunks)
        if len(chunks) == 1:
            return self.allgather(x, n_cores, **kw)
        return torch.cat([self.allgather(c, n_cores, **kw) for c in chunks],
                         dim=-1)

    def fold_pipelined(self, n_cores: int, n_chunks: int, partials_fn,
                       x: torch.Tensor,
                       layout: Optional[CoreLayout] = None) -> torch.Tensor:
        """Fused local walk + reduce-scatter, one feature wave at a time:
        ``partials_fn(x_wave) -> [P, P, t, dc]`` (called once per wave);
        returns ``[P, t, d]`` (across ranks, this rank's ``count`` cores)."""
        kw = _layout_kw(layout)
        waves = _waves(x, n_chunks)
        if len(waves) == 1:
            return self.reduce_scatter(partials_fn(x), n_cores, **kw)
        return torch.cat([self.reduce_scatter(partials_fn(xc), n_cores, **kw)
                          for xc in waves], dim=-1)


def _layout_kw(layout: Optional[CoreLayout]) -> dict:
    """``layout=`` only when there is one, so a registered topology whose
    collectives take no layout keeps its stacked path."""
    return {} if layout is None else {"layout": layout}


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


def layout_kwargs(topology: str, layout: Optional[CoreLayout]) -> dict:
    """The keyword a topology's collective takes for ``layout``: none on
    stacked cores (the single-process path, unchanged), ``layout=`` across
    ranks, after the topology checked that it crosses them."""
    spread = spans_ranks(layout)
    if spread is None:
        return {}
    _topo(topology).check_layout(spread)
    return {"layout": spread}


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, topology: str, n_cores: int, partial: torch.Tensor,
                layout: Optional[CoreLayout]):
        ctx.topology, ctx.n_cores, ctx.layout = topology, n_cores, layout
        return _topo(topology).reduce_scatter(
            partial, n_cores, **layout_kwargs(topology, layout))

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return None, None, _topo(ctx.topology).allgather(
            ct, ctx.n_cores, **layout_kwargs(ctx.topology, ctx.layout)), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, topology: str, n_cores: int, x: torch.Tensor,
                layout: Optional[CoreLayout]):
        ctx.topology, ctx.n_cores, ctx.layout = topology, n_cores, layout
        return _topo(topology).allgather(x, n_cores,
                                         **layout_kwargs(topology, layout))

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return None, None, _topo(ctx.topology).reduce_scatter(
            ct, ctx.n_cores, **layout_kwargs(ctx.topology, ctx.layout)), None


def reduce_scatter(topology: str, n_cores: int, partial: torch.Tensor,
                   layout: Optional[CoreLayout] = None) -> torch.Tensor:
    """Differentiable ``[P, P, t, ...] → [P, t, ...]`` fold over
    ``topology`` (across ranks: this rank's ``[count, P, t, ...]`` →
    ``[count, t, ...]``); its backward is the same topology's
    :func:`allgather`."""
    return _ReduceScatter.apply(topology, n_cores, partial, layout)


def allgather(topology: str, n_cores: int, x: torch.Tensor,
              layout: Optional[CoreLayout] = None) -> torch.Tensor:
    """Differentiable ``[P, t, ...] → [P, P, t, ...]`` gather over
    ``topology`` (across ranks: this rank's ``[count, t, ...]`` →
    ``[count, P, t, ...]``); its backward is the same topology's
    :func:`reduce_scatter`."""
    return _AllGather.apply(topology, n_cores, x, layout)


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
