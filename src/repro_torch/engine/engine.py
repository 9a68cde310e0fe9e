"""The Engine — one declarative entry point for the aggregation paths (port
of the single-device part of :mod:`repro.engine.engine`).

``Engine("ell+pipelined")`` resolves the registered format and schedule
once; ``engine.layer(coo, x, w)`` builds the format's layout (cached per
COO identity in the shared edge-plan LRU, which pins the COO's tensors)
and runs the format's GCN layer on the card, or on the CPU with
``device="cpu"``.  The distributed bundle (``Engine.build``) is ported with
the distributed slice.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.device import DeviceLike, resolve_device

from . import formats as _formats  # noqa: F401  (registers built-ins)
from .config import EngineConfig
from .registry import Format, Schedule, get_format, get_schedule


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

    def build(self, *args, **kwargs):
        raise NotImplementedError(
            "Engine.build (the distributed bundle: sharded batches, the "
            "hypercube/topology exchange, train_step) is ported with the "
            "distributed training slice (ROADMAP, port Queue 1); use "
            "Engine.layer for single-device layers")
