"""The Engine — one declarative entry point for the aggregation paths (port
of :mod:`repro.engine.engine`).

``Engine("ell+pipelined")`` resolves the registered format and schedule
once.  Single-device use: ``engine.layer(coo, x, w)`` builds the format's
layout (cached per COO identity in the shared edge-plan LRU, which pins the
COO's tensors) and runs the format's GCN layer.  Distributed use:
``engine.build(n_cores=P)`` returns an :class:`EngineBundle` over P stacked
cores — the paper's on-chip cores as a leading tensor axis on one GPU:

    bundle = Engine("ell+pipelined").build(n_cores=16)
    batch = bundle.shard_batch(mb, feats, labels)   # host prep + placement
    params, loss = bundle.train_step(params, batch)
    y = bundle.aggregate(x, coo)                    # y = A @ x, distributed

Everything runs on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

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
    """Resolved (format, schedule) pair + the single-device layer."""

    def __init__(self, config: Union[EngineConfig, str]):
        if isinstance(config, str):
            config = EngineConfig.from_spec(config)
        self.config: EngineConfig = config
        self.format: Format = get_format(config.format)
        self.schedule: Schedule = get_schedule(config.schedule)

    @property
    def spec(self) -> str:
        return self.config.spec

    def layout(self, graph):
        """This format's single-device layout for ``graph`` (a host-side
        :class:`~repro_torch.graph.COO`), cached per COO identity."""
        if not self.format.cache_layouts:
            return self.format.build_local(graph, self.config)
        from repro_torch.kernels import edgeplan
        key = edgeplan.coo_key(graph, "engine", self.config.format,
                               self.config.caps, self.config.merge)
        return edgeplan.cached(
            key, (graph.rows, graph.cols, graph.vals),
            lambda: self.format.build_local(graph, self.config))

    def layer(self, graph, x: torch.Tensor, w: torch.Tensor, *,
              order: str = "coag", activate: bool = True,
              device: DeviceLike = None) -> torch.Tensor:
        """Single-device GCN layer forward through this engine's format on
        ``device`` (``None`` → the card; raises without one).  ``x`` and
        ``w`` move there if they are elsewhere."""
        dev = resolve_device(device)
        return self.format.layer(self.layout(graph), x.to(dev), w.to(dev),
                                 order=order, activate=activate)

    def build(self, n_cores: int = 1, *,
              device: DeviceLike = None) -> "EngineBundle":
        """The distributed bundle over ``n_cores`` stacked cores on
        ``device`` (``None`` → the card; raises without one).  Unported
        topologies and the ``mincom`` partition raise
        ``NotImplementedError``."""
        if self.config.partition != "naive":
            raise NotImplementedError(
                f"partition {self.config.partition!r} is not ported yet "
                "(ROADMAP, port Queue 1); use the naive partition")
        topology = get_topology(self.config.topology)
        topology.validate_cores(int(n_cores))
        return EngineBundle(self, int(n_cores), resolve_device(device),
                            topology)


class EngineBundle:
    """Everything a training loop calls, for one (engine, core count,
    device): :meth:`prepare_batch` / :meth:`commit_batch` /
    :meth:`shard_batch`, :meth:`train_step`, :meth:`forward`,
    :meth:`aggregate`.

    A batch is a dict: ``edges`` (one format leaf dict per hop, deepest
    last), ``dims`` (``(n_dst, n_src)`` per hop), ``x`` (frontier features
    ``[n_src, d]``, row-sharded over the cores by contiguous ranges) and
    ``labels``.
    """

    def __init__(self, engine: Engine, n_cores: int, device: torch.device,
                 topology):
        self.engine = engine
        self.config = engine.config
        self.format = engine.format
        self.schedule = engine.schedule
        self.topology = topology
        self.n_cores = n_cores
        self.device = device
        self.n_chunks = self.schedule.resolve_n_chunks(self.config.n_chunks)

    @property
    def spec(self) -> str:
        return self.config.spec

    # -- host-side batch prep ------------------------------------------------
    def prepare_batch(self, mb, features, labels) -> Dict[str, Any]:
        """Sampled mini-batch → host-side batch (numpy leaves): the
        format's per-hop sharding and table build.  Pure host work, safe on
        a prefetch thread; :meth:`commit_batch` places it.  Multilabel rows
        become their dominant class, as in the reference."""
        edges, dims = self.format.prepare_batch(mb, self.n_cores,
                                                self.config)
        labels = np.asarray(labels)
        if labels.ndim == 2:
            labels = labels.argmax(-1)
        return {"edges": edges, "dims": [tuple(map(int, d)) for d in dims],
                "x": np.asarray(features, np.float32),
                "labels": labels.astype(np.int64)}

    def commit_batch(self, host_batch: Dict[str, Any]) -> Dict[str, Any]:
        """Host batch → tensors on the bundle's device, once per batch."""
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return {"edges": [self.format.to_device(e, self.device)
                          for e in host_batch["edges"]],
                "dims": host_batch["dims"], "x": put(host_batch["x"]),
                "labels": put(host_batch["labels"])}

    def shard_batch(self, mb, features, labels) -> Dict[str, Any]:
        """:meth:`prepare_batch` then :meth:`commit_batch`."""
        return self.commit_batch(self.prepare_batch(mb, features, labels))

    # -- the model -----------------------------------------------------------
    def _aggregate(self, n_dst: int, leaves, h: torch.Tensor) -> torch.Tensor:
        return self.format.device_aggregate(
            self.n_cores, n_dst, leaves, h, self.n_chunks,
            topology=self.config.topology)

    def _forward(self, params: Params, edges, dims: Sequence[Tuple[int, int]],
                 x: torch.Tensor) -> torch.Tensor:
        """L-layer GCN forward, deepest layer first (CoAg order): each
        core's combination ``h @ w``, this format's aggregation under this
        schedule, ReLU except after the last layer.  Returns the logits
        ``[n_dst_0, classes]`` in global row order."""
        h = x.reshape(self.n_cores, -1, x.shape[-1])
        n_layers = len(params)
        for l in range(n_layers - 1, -1, -1):
            h = torch.matmul(h, params[n_layers - 1 - l]["w"])
            h = self._aggregate(dims[l][0], edges[l], h)
            if l != 0:
                h = torch.relu(h)
        return h.reshape(-1, h.shape[-1])

    def loss(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """Mean NLL over the global batch (every core's rows), as the
        reference's ``pmean`` of per-core means."""
        logits = self._forward(params, batch["edges"], batch["dims"],
                               batch["x"])
        return F.cross_entropy(logits, batch["labels"])

    def train_step(self, params: Params, batch: Dict[str, Any]
                   ) -> Tuple[Params, torch.Tensor]:
        """One SGD step at ``config.lr``; returns ``(new params, loss)``.

        The weights are one tensor shared by the stacked cores, so autograd
        sums every core's contribution to the gradient of the global-batch
        mean loss — the gradient the reference takes by averaging the
        per-core gradients over the hypercube (the Weight Bank sync).  The
        update is out of place: the given params are left untouched."""
        ws = [p["w"].detach().requires_grad_(True) for p in params]
        loss = self.loss([{"w": w} for w in ws], batch)
        grads = torch.autograd.grad(loss, ws)
        lr = self.config.lr
        with torch.no_grad():
            new = [{"w": w.detach() - lr * g} for w, g in zip(ws, grads)]
        return new, loss.detach()

    @torch.no_grad()
    def forward(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """Logits ``[n_dst_0, classes]`` (no gradient)."""
        return self._forward(params, batch["edges"], batch["dims"],
                             batch["x"])

    # -- raw distributed aggregation -----------------------------------------
    def _shards(self, coo):
        from repro_torch.kernels import edgeplan

        def build():
            leaves, n_dst, _ = self.format.shard(coo, self.n_cores,
                                                 self.config)
            return self.format.to_device(leaves, self.device), n_dst

        key = edgeplan.coo_key(coo, "agg", self.config.spec, self.n_cores,
                               self.config.caps, self.config.merge,
                               str(self.device))
        return edgeplan.cached(key, (coo.rows, coo.cols, coo.vals), build)

    def aggregate(self, x: torch.Tensor, graph) -> torch.Tensor:
        """``y = A @ x`` for a global ``x`` ``[n_src, d]`` and a COO
        ``graph`` through this engine's format, schedule and topology on
        the stacked cores (differentiable, with the format's mirror
        backward).  Each graph's shards are built and placed once (cached
        per COO identity)."""
        leaves, n_dst = self._shards(graph)
        h = x.reshape(self.n_cores, -1, x.shape[-1])
        return self._aggregate(n_dst, leaves, h).reshape(n_dst, -1)
