"""The Engine — one declarative entry point for the aggregation paths (port
of :mod:`repro.engine.engine`).

``Engine("ell+pipelined")`` (or ``"block+pipelined"``, ``"coo+serial"``)
resolves the registered format and schedule once.  Single-device use:
``engine.layer(coo, x, w)`` builds the format's layout (cached per COO
identity in the shared edge-plan LRU, which pins the COO's tensors) and
runs the format's GCN layer.  Distributed use:
``engine.build(n_cores=P)`` returns an :class:`EngineBundle` over P stacked
cores — the paper's on-chip cores as a leading tensor axis on one GPU:

    bundle = Engine("ell+pipelined").build(n_cores=16)
    batch = bundle.shard_batch(mb, feats, labels)   # host prep + placement
    params, loss = bundle.train_step(params, batch)
    y = bundle.aggregate(x, coo)                    # y = A @ x, distributed

Across processes, ``engine.build(n_cores=P, mesh=mesh)`` takes a
``torch.distributed`` ``DeviceMesh`` whose ``model`` dimension spreads the
P cores over its W ranks (:func:`repro_torch.launch.mesh.
make_topology_mesh`): rank r stacks cores ``[r·P/W, (r+1)·P/W)``, places
only their leaves (:func:`repro_torch.distributed.sharding.put_block`
over the rank's :class:`~repro_torch.topology.base.CoreLayout`), folds
across ranks over the engine's topology (each built-in runs its rounds
across ranks; a registered topology without them refuses the mesh),
takes the loss
over the global batch and all-reduces the weight gradients once a step
(the Weight-Bank sync), so every rank applies the same update.  Without a
mesh nothing of this runs.

Every registered topology and both partitions build: ``"mincom"``
relabels each batch's node spaces before the format builds its tables
(:meth:`EngineBundle._apply_partition`), and every prepared batch carries
a host-side ``report`` of its exchange wire bytes and merge tier
(:meth:`EngineBundle._plan_report`).  Everything runs on the card unless
``device="cpu"`` is passed.

``Engine("auto")`` defers the triple to :mod:`repro_torch.engine.planner`:
:meth:`Engine.resolve` turns it into a concrete engine for a core count on
a device (persisted autotune winner → fitted cost model → static fallback
— pure reads, no implicit sweep), :meth:`Engine.layout` /
:meth:`Engine.layer` resolve at one core and :meth:`Engine.build` at its
``n_cores``, so a bundle never carries ``"auto"``.  Resolution is cached
per (core count, stats bucket, backend).
"""
from __future__ import annotations

import types
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device

from . import formats as _formats  # noqa: F401  (registers built-ins)
from .config import EngineConfig
from .registry import (Format, Schedule, get_format, get_schedule,
                       get_topology)

Params = List[Dict[str, torch.Tensor]]


class Engine:
    """Resolved (format, schedule, topology) triple + the single-device
    layer (all ``None`` on an ``"auto"`` engine until it resolves)."""

    def __init__(self, config: Union[EngineConfig, str]):
        if isinstance(config, str):
            config = EngineConfig.from_spec(config)
        self.config: EngineConfig = config
        if config.is_auto:
            self.format = self.schedule = self.topology = None
            self._resolved: Dict[tuple, "Engine"] = {}
        else:
            self.format: Format = get_format(config.format)
            self.schedule: Schedule = get_schedule(config.schedule)
            self.topology = get_topology(config.topology)

    @property
    def spec(self) -> str:
        return self.config.spec

    @property
    def is_auto(self) -> bool:
        return self.config.is_auto

    def resolve(self, n_cores: int, graph_stats=None,
                device: DeviceLike = None) -> "Engine":
        """This engine with ``"auto"`` made concrete for ``n_cores`` on
        ``device`` (``None`` → the card; raises without one).

        Concrete engines return themselves; an auto engine asks
        :func:`repro_torch.engine.planner.resolve_spec` and caches the
        result per (core count, stats bucket, backend), carrying every knob
        of this config onto the resolved spec."""
        if not self.is_auto:
            return self
        from repro_torch.kernels.tune import backend_key

        from . import planner
        backend = backend_key(device)
        key = (int(n_cores),
               graph_stats.bucket() if graph_stats is not None else None,
               backend)
        eng = self._resolved.get(key)
        if eng is None:
            spec = planner.resolve_spec(n_cores=int(n_cores),
                                        graph_stats=graph_stats,
                                        backend=backend)
            eng = Engine(self.config.with_spec(spec))
            self._resolved[key] = eng
        return eng

    def layout(self, graph, *, device: DeviceLike = None):
        """This format's single-device layout for ``graph`` (a host-side
        :class:`~repro_torch.graph.COO`), cached per COO identity; an auto
        engine resolves at one core on ``device`` first."""
        if self.is_auto:
            return self.resolve(1, device=device).layout(graph)
        if not self.format.cache_layouts:
            return self.format.build_local(graph, self.config)
        from repro_torch.kernels import edgeplan
        key = edgeplan.coo_key(graph, "engine", self.config.format,
                               self.config.caps, self.config.merge,
                               self.config.block_tiles)
        return edgeplan.cached(
            key, (graph.rows, graph.cols, graph.vals),
            lambda: self.format.build_local(graph, self.config))

    def layer(self, graph, x: torch.Tensor, w: torch.Tensor, *,
              order: str = "coag", activate: bool = True,
              device: DeviceLike = None) -> torch.Tensor:
        """Single-device GCN layer forward through this engine's format on
        ``device`` (``None`` → the card; raises without one).  ``x`` and
        ``w`` move there if they are elsewhere.  An auto engine resolves
        at one core on ``device`` first."""
        if self.is_auto:
            return self.resolve(1, device=device).layer(
                graph, x, w, order=order, activate=activate, device=device)
        dev = resolve_device(device)
        return self.format.layer(self.layout(graph), x.to(dev), w.to(dev),
                                 order=order, activate=activate)

    def build(self, n_cores: int = 1, *, mesh=None,
              device: DeviceLike = None) -> "EngineBundle":
        """The distributed bundle over ``n_cores`` stacked cores on
        ``device`` (``None`` → the card; raises without one).  The topology
        validates the core count; an auto engine resolves at ``n_cores``
        first, before any mesh state is touched.

        ``mesh``: a ``DeviceMesh`` whose ``model`` dimension spreads the
        cores over its ranks (module docstring); the device is then the
        mesh's unless ``device`` names one.  A mesh with another dimension of
        size > 1 raises ``ValueError``: the reference replicates the step
        over it, which is no data parallelism.  A topology without rounds
        across ranks (``Topology.crosses_ranks`` false) refuses a mesh of
        more than one rank (``NotImplementedError``)."""
        if mesh is not None and device is None:
            from repro_torch.distributed.sharding import mesh_device
            device = mesh_device(mesh)
        dev = resolve_device(device)
        if self.is_auto:
            return self.resolve(n_cores, device=dev).build(
                n_cores, mesh=mesh, device=dev)
        self.topology.validate_cores(int(n_cores))
        layout = None
        if mesh is not None:
            layout = core_layout(mesh, int(n_cores))
            self.topology.check_layout(layout)
        return EngineBundle(self, int(n_cores), dev, self.topology,
                            mesh=mesh, layout=layout)


def core_layout(mesh, n_cores: int):
    """This rank's :class:`~repro_torch.topology.base.CoreLayout` of
    ``n_cores`` over ``mesh``'s ``model`` dimension."""
    from repro_torch.distributed.sharding import MODEL, axis_layout, axis_size

    names = tuple(mesh.mesh_dim_names or ())
    if MODEL not in names:
        raise ValueError(f"the mesh's dimensions {names} have no "
                         f"{MODEL!r} axis to spread the cores over")
    other = {n: axis_size(mesh, n) for n in names
             if n != MODEL and axis_size(mesh, n) > 1}
    if other:
        raise ValueError(
            f"mesh dimensions {other} besides {MODEL!r}: the engine spreads "
            "cores over the model axis only (the reference would replicate "
            "the step over the others, which is no data parallelism)")
    world = axis_size(mesh, MODEL)
    if n_cores % world or (world & (world - 1)):
        raise ValueError(f"{n_cores} cores do not split over {world} ranks "
                         "(the rank count must be a power of two dividing "
                         "the core count)")
    return axis_layout(mesh, n_cores)


class EngineBundle:
    """Everything a training loop calls, for one (engine, core count,
    device): :meth:`prepare_batch` / :meth:`commit_batch` /
    :meth:`shard_batch`, :meth:`train_step`, :meth:`forward`,
    :meth:`aggregate`.

    A batch is a dict: ``edges`` (one format leaf dict per hop, deepest
    last), ``dims`` (``(n_dst, n_src)`` per hop), ``x`` (frontier features
    ``[n_src, d]``, row-sharded over the cores by contiguous ranges),
    ``labels`` and ``report`` (host floats, :meth:`_plan_report`).
    """

    def __init__(self, engine: Engine, n_cores: int, device: torch.device,
                 topology, mesh=None, layout=None):
        self.engine = engine
        self.config = engine.config
        self.format = engine.format
        self.schedule = engine.schedule
        self.topology = topology
        self.n_cores = n_cores
        self.device = device
        self.n_chunks = self.schedule.resolve_n_chunks(self.config.n_chunks)
        self.mesh = mesh
        #: this rank's cores (None: every core stacked here, no mesh)
        self.layout = layout
        self.local_cores = n_cores if layout is None else layout.count

    @property
    def spec(self) -> str:
        return self.config.spec

    # -- host-side batch prep ------------------------------------------------
    def prepare_batch(self, mb, features, labels) -> Dict[str, Any]:
        """Sampled mini-batch → host-side batch (numpy leaves): the
        partition's relabeling (:meth:`_apply_partition`), the format's
        per-hop sharding and table build, and the batch's
        :meth:`_plan_report`.  Pure host work, safe on a prefetch thread;
        :meth:`commit_batch` places it.  Multilabel rows become their
        dominant class, as in the reference.

        ``features`` is either the gathered frontier rows (``[n_frontier,
        d]``) or an out-of-core source — a
        :class:`~repro_torch.featurestore.FeatureStore` or
        :class:`~repro_torch.featurestore.HotVertexCache` — whose frontier
        rows (``mb.input_nodes``, clamp-indexed like
        :func:`repro_torch.data.gather_features`) are gathered HERE, so any
        :meth:`shard_batch` caller trains out of core with no other
        change."""
        if hasattr(features, "gather"):   # FeatureStore / HotVertexCache
            ids = np.minimum(np.asarray(mb.input_nodes, np.int64),
                             features.shape[0] - 1)
            features = features.gather(ids)
        mb, features = self._apply_partition(
            mb, np.asarray(features, np.float32))
        edges, dims = self.format.prepare_batch(mb, self.n_cores,
                                                self.config)
        labels = np.asarray(labels)
        if labels.ndim == 2:
            labels = labels.argmax(-1)
        return {"edges": edges, "dims": [tuple(map(int, d)) for d in dims],
                "x": features, "labels": labels.astype(np.int64),
                "report": self._plan_report(mb, features.shape[-1])}

    def _apply_partition(self, mb, features: np.ndarray):
        """``partition="mincom"``: relabel every node space but the batch's
        with :func:`repro_torch.graph.partition.mincom_layer_perms` (space
        0 stays identity, so labels and logits never move) and permute the
        frontier rows to match (new row ``perm[v]`` = old row ``v``).  The
        permutations are cached on the layer chain's identity in the shared
        edge-plan LRU.  ``naive`` (and one core) returns the batch as it
        is."""
        if self.config.partition != "mincom" or self.n_cores <= 1:
            return mb, features
        from repro_torch.graph.coo import from_edges
        from repro_torch.graph.partition import mincom_layer_perms
        from repro_torch.kernels import edgeplan

        layers = list(mb.layers)
        key = tuple(k for coo in layers for k in
                    edgeplan.coo_key(coo, "mincom-perms", self.n_cores))
        pins = tuple(a for coo in layers
                     for a in (coo.rows, coo.cols, coo.vals))
        perms = edgeplan.cached(
            key, pins, lambda: mincom_layer_perms(layers, self.n_cores))
        relabeled = tuple(
            from_edges(perms[i][np.asarray(coo.rows, np.int64)],
                       perms[i + 1][np.asarray(coo.cols, np.int64)],
                       np.asarray(coo.vals, np.float32),
                       coo.n_dst, coo.n_src)
            for i, coo in enumerate(layers))
        # the formats and the report read .layers only
        return (types.SimpleNamespace(layers=relabeled),
                features[np.argsort(perms[-1], kind="stable")])

    def _plan_report(self, mb, d: int) -> Dict[str, float]:
        """Host-side partition and merge accounting of one prepared batch:
        the exchange's ``wire_bytes`` per core, summed over the hops (each
        hop's :func:`repro_torch.graph.partition.exchange_rows` through
        ``Topology.plan(wire_rows=...)``), and for ``ell`` under
        ``merge="redundancy"`` the shards' ``virtual_vertices``, mean
        ``pair_coverage`` and ``flop_reduction`` (the shard build is cached,
        so reading its stats is a cache hit)."""
        from repro_torch.graph.partition import exchange_rows

        wire_bytes = 0
        for coo in mb.layers:
            wr = exchange_rows(np.asarray(coo.rows), np.asarray(coo.cols),
                               np.asarray(coo.vals), coo.n_dst, coo.n_src,
                               self.n_cores)
            wire_bytes += self.topology.plan(
                coo.n_dst, d, self.n_cores, wire_rows=wr).bytes_per_core
        report = {"wire_bytes": float(wire_bytes), "virtual_vertices": 0.0,
                  "pair_coverage": 0.0, "flop_reduction": 1.0}
        if self.config.format == "ell" and self.config.merge == "redundancy":
            from repro_torch.distributed import aggregate as _agg
            nv = pu = eb = ea = 0.0
            for coo in mb.layers:
                ee = _agg.shard_edges_ell(coo, self.n_cores,
                                          caps=self.config.caps,
                                          merge=self.config.merge)
                nv += ee.n_virtual
                pu += ee.pair_coverage
                eb += ee.merge_stats.get("edges_before", 0)
                ea += ee.merge_stats.get("edges_after", 0)
            report["virtual_vertices"] = float(nv)
            report["pair_coverage"] = float(pu / max(len(mb.layers), 1))
            # every surviving edge is one MAC, every virtual vertex two
            report["flop_reduction"] = float(eb / max(ea + 2.0 * nv, 1.0))
        return report

    def commit_batch(self, host_batch: Dict[str, Any]) -> Dict[str, Any]:
        """Host batch → tensors on the bundle's device, once per batch; the
        host ``report`` rides along as it is and ``n_rows`` keeps the global
        batch's row count.  On a mesh only this rank's block of every
        per-core leaf is placed (``put_block`` over the bundle's layout):
        its senders' edge tables, its cores' feature rows and label rows."""
        from repro_torch.distributed.sharding import put_block

        def put(a):
            return put_block(self.layout, a, self.device)

        out = {"edges": [self.format.to_device(e, self.device, self.layout)
                         for e in host_batch["edges"]],
               "dims": host_batch["dims"], "x": put(host_batch["x"]),
               "labels": put(host_batch["labels"]),
               "n_rows": int(len(host_batch["labels"]))}
        if "report" in host_batch:
            out["report"] = host_batch["report"]
        return out

    def shard_batch(self, mb, features, labels) -> Dict[str, Any]:
        """:meth:`prepare_batch` then :meth:`commit_batch`."""
        return self.commit_batch(self.prepare_batch(mb, features, labels))

    # -- the model -----------------------------------------------------------
    def _aggregate(self, n_dst: int, leaves, h: torch.Tensor) -> torch.Tensor:
        kw = {} if self.layout is None else {"layout": self.layout}
        return self.format.device_aggregate(
            self.n_cores, n_dst, leaves, h, self.n_chunks,
            topology=self.config.topology, **kw)

    def _forward(self, params: Params, edges, dims: Sequence[Tuple[int, int]],
                 x: torch.Tensor) -> torch.Tensor:
        """L-layer GCN forward, deepest layer first (CoAg order): each
        core's combination ``h @ w``, this format's aggregation under this
        schedule, ReLU except after the last layer.  Returns the logits
        ``[n_dst_0, classes]`` in global row order (on a mesh, this rank's
        cores' rows)."""
        h = x.reshape(self.local_cores, -1, x.shape[-1])
        n_layers = len(params)
        for l in range(n_layers - 1, -1, -1):
            h = torch.matmul(h, params[n_layers - 1 - l]["w"])
            h = self._aggregate(dims[l][0], edges[l], h)
            if l != 0:
                h = torch.relu(h)
        return h.reshape(-1, h.shape[-1])

    def loss(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """Mean NLL over the global batch (every core's rows), as the
        reference's ``pmean`` of per-core means.  On a mesh, this rank's
        share of it: the NLL summed over its rows, over the global row
        count (the ranks' shares add up to the mean)."""
        logits = self._forward(params, batch["edges"], batch["dims"],
                               batch["x"])
        if self.mesh is None:
            return F.cross_entropy(logits, batch["labels"])
        # divided by a tensor: a true division, as the mean's (on the card a
        # division by a Python number is a multiply by its reciprocal)
        rows = torch.full((), batch["n_rows"], dtype=logits.dtype,
                          device=logits.device)
        return F.cross_entropy(logits, batch["labels"],
                               reduction="sum") / rows

    def train_step(self, params: Params, batch: Dict[str, Any]
                   ) -> Tuple[Params, torch.Tensor]:
        """One SGD step at ``config.lr``; returns ``(new params, loss)``.

        The weights are one tensor shared by the stacked cores, so autograd
        sums every core's contribution to the gradient of the global-batch
        mean loss — the gradient the reference takes by averaging the
        per-core gradients over the hypercube (the Weight Bank sync).  On a
        mesh each rank's gradient covers its cores, and the Weight-Bank
        sync is one ``all_reduce(SUM)`` over the ``model`` group of every
        layer's gradient flattened into one buffer; the reported loss is
        all-reduced too.  The update is out of place: the given params are
        left untouched."""
        ws = [p["w"].detach().requires_grad_(True) for p in params]
        loss = self.loss([{"w": w} for w in ws], batch)
        grads = torch.autograd.grad(loss, ws)
        loss = loss.detach()
        if self.mesh is not None:
            import torch.distributed as dist

            flat = torch.cat([g.reshape(-1) for g in grads] + [
                loss.reshape(1)])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                            group=self.layout.group)
            parts = flat.split([g.numel() for g in grads] + [1])
            grads = [p.view_as(g) for p, g in zip(parts, grads)]
            loss = parts[-1].reshape(())
        lr = self.config.lr
        with torch.no_grad():
            new = [{"w": w.detach() - lr * g} for w, g in zip(ws, grads)]
        return new, loss

    @torch.no_grad()
    def forward(self, params: Params, batch: Dict[str, Any], *,
                gather: bool = True) -> torch.Tensor:
        """Logits ``[n_dst_0, classes]`` (no gradient); on a mesh every
        rank's rows gathered in core order (``gather=False``: this rank's
        rows, :meth:`local_rows`)."""
        logits = self._forward(params, batch["edges"], batch["dims"],
                               batch["x"])
        if self.mesh is None or not gather:
            return logits
        return self._gather_rows(logits)

    def _gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's row block of a row-sharded tensor, in core order
        (one all-gather over the ``model`` group)."""
        from repro_torch.topology.base import gather_ranks

        blocks = local.reshape(self.local_cores, -1, *local.shape[1:])
        return gather_ranks(blocks, self.layout).reshape(
            -1, *local.shape[1:])

    def local_rows(self, n_rows: int) -> slice:
        """This rank's rows of a row-sharded tensor of ``n_rows`` rows
        (all of them without a mesh)."""
        return slice(0, n_rows) if self.layout is None \
            else self.layout.block(n_rows)

    # -- raw distributed aggregation -----------------------------------------
    def _shards(self, coo):
        """Placed shards of ``coo`` and the row permutation ``mincom``
        applied (``None`` otherwise), built once per COO identity.  A
        ``mincom`` bundle relabels a square one-space graph with one
        permutation on both sides (:func:`~repro_torch.graph.partition.
        mincom_assignment`); a rectangular graph keeps its numbering."""
        from repro_torch.kernels import edgeplan

        def build():
            graph, perm = coo, None
            if self.config.partition == "mincom" and self.n_cores > 1 \
                    and coo.n_dst == coo.n_src:
                from repro_torch.graph.coo import from_edges
                from repro_torch.graph.partition import (
                    mincom_assignment, partition_permutation)
                rows = np.asarray(coo.rows, np.int64)
                cols = np.asarray(coo.cols, np.int64)
                perm = partition_permutation(
                    mincom_assignment(rows, cols, coo.n_dst, self.n_cores),
                    self.n_cores)
                graph = from_edges(perm[rows], perm[cols],
                                   np.asarray(coo.vals, np.float32),
                                   coo.n_dst, coo.n_src)
                perm = torch.from_numpy(perm).to(self.device)
            leaves, n_dst, _ = self.format.shard(graph, self.n_cores,
                                                 self.config)
            return (self.format.to_device(leaves, self.device, self.layout),
                    n_dst, perm)

        key = edgeplan.coo_key(coo, "agg", self.config.spec, self.n_cores,
                               self.config.caps, self.config.merge,
                               str(self.device), self.layout and (
                                   self.layout.first, self.layout.count))
        return edgeplan.cached(key, (coo.rows, coo.cols, coo.vals), build)

    def aggregate(self, x: torch.Tensor, graph) -> torch.Tensor:
        """``y = A @ x`` for a global ``x`` ``[n_src, d]`` and a COO
        ``graph`` through this engine's format, schedule, topology and
        partition on the stacked cores (differentiable, with the format's
        mirror backward; rows in ``graph``'s own order).  Each graph's
        shards are built and placed once (cached per COO identity).  On a
        mesh every rank passes the same ``x`` and gets the whole ``y``:
        each aggregates its cores' rows, and ``y`` and ``x``'s gradient
        are gathered over the ranks (the stacked path's bits)."""
        leaves, n_dst, perm = self._shards(graph)
        if perm is not None:           # new row perm[v] = old row v
            x = x.index_select(0, torch.argsort(perm, stable=True))
        if self.mesh is not None:
            x = _RankRows.apply(x, self)
        h = x.reshape(self.local_cores, -1, x.shape[-1])
        y = self._aggregate(n_dst, leaves, h)
        if self.mesh is not None:
            y = _GatherRows.apply(y, self)
        y = y.reshape(n_dst, -1)
        return y if perm is None else y.index_select(0, perm)


class _RankRows(torch.autograd.Function):
    """A replicated ``[n, d]`` tensor → this rank's cores' rows; the
    backward gathers every rank's row gradient (disjoint blocks, so the
    gather is their sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, bundle: "EngineBundle"):
        ctx.bundle = bundle
        return x[bundle.local_rows(x.shape[0])].contiguous()

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return ctx.bundle._gather_rows(ct.contiguous()), None


class _GatherRows(torch.autograd.Function):
    """This rank's cores' ``[count, t, d]`` blocks → every rank's, in core
    order; the backward keeps this rank's rows of the (replicated)
    gradient."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, bundle: "EngineBundle"):
        from repro_torch.topology.base import gather_ranks
        ctx.bundle = bundle
        return gather_ranks(y, bundle.layout)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        lay = ctx.bundle.layout
        return ct[lay.first:lay.first + lay.count].contiguous(), None
