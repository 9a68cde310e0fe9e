"""Format/schedule/topology registry (port of :mod:`repro.engine.registry`).

A **format** owns one edge layout: how a COO becomes that layout
(``build_local``), the single-device GCN layer that walks it, how a sampled
hop is sharded over the stacked sender cores (``shard``) and the
distributed aggregate over those shards (``device_aggregate``).  A
**schedule** names an issue order for the exchange fold; a **topology**
(:class:`repro_torch.topology.Topology`) owns the exchange itself.  The
registry keeps the reference's contract: registering a class makes it
reachable from every spec string, and unknown names raise ``ValueError``
listing the registered options.

Ported: the ``coo``, ``block`` and ``ell`` formats, both schedules and
the ``hypercube``, ``allpairs``, ``ring`` and ``torus2d`` topologies.  A
topology name is valid exactly when it is registered, so a
``@register_topology`` subclass is reachable from every spec string.
``"auto"`` names no format: :mod:`repro_torch.engine.planner` resolves it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple


class Format:
    """Base class for registered edge formats.

    ``schedules`` lists the supported schedule names (first = default).
    """

    name: str = "?"
    schedules: Tuple[str, ...] = ()
    #: topology names this format supports; ``None`` = every registered
    #: topology (the fold is layout-agnostic)
    topologies: Optional[Tuple[str, ...]] = None
    #: True when the layer runs straight on a sampled COO (no host-built
    #: layout): the formats the reference's single-device GCN loop takes
    traceable: bool = False
    #: False when ``build_local`` is (near-)identity — caching it would only
    #: churn the shared layout LRU
    cache_layouts: bool = True

    @property
    def default_schedule(self) -> str:
        return self.schedules[0]

    def build_local(self, coo, cfg):
        """COO → this format's single-device layout (cached by the Engine)."""
        raise NotImplementedError

    def layer(self, layout, x, w, *, order: str = "coag",
              activate: bool = True):
        """Single-device GCN layer forward over a ``build_local`` layout."""
        raise NotImplementedError

    def shard(self, coo, n_cores: int, cfg):
        """COO → ``(leaves, n_dst, n_src)``: a dict of host (numpy) arrays
        whose leading axis is the sender core."""
        raise NotImplementedError

    def prepare_batch(self, mb, n_cores: int, cfg):
        """Sampled mini-batch → ``(edges, dims)``: one ``shard`` dict and one
        ``(n_dst, n_src)`` pair per hop layer (deepest last).  Host work
        only, safe on a prefetch thread."""
        edges, dims = [], []
        for coo in mb.layers:
            leaves, n_dst, n_src = self.shard(coo, n_cores, cfg)
            edges.append(leaves)
            dims.append((n_dst, n_src))
        return edges, dims

    #: leaves that index with ``index_select``/``index_add_`` and so move
    #: to the device as int64
    int64_leaves: Tuple[str, ...] = ()

    def to_device(self, leaves: Dict[str, Any], device) -> Dict[str, Any]:
        """One hop's host leaves → tensors on ``device`` (tuples of buckets
        stay tuples)."""
        import numpy as np
        import torch

        def put(a, wide=False):
            if isinstance(a, tuple):
                return tuple(put(b) for b in a)
            return torch.from_numpy(np.ascontiguousarray(
                a.astype(np.int64) if wide else a)).to(device)

        return {k: put(v, k in self.int64_leaves) for k, v in leaves.items()}

    def device_aggregate(self, n_cores: int, n_dst: int, leaves, x,
                         n_chunks: int, topology: str = "hypercube"):
        """``y = A @ x`` on the stacked cores: ``x`` ``[P, n_src/P, d]`` →
        ``[P, n_dst/P, d]``, exchanging partial rows over ``topology``;
        differentiable with the format's mirror backward."""
        raise NotImplementedError


class Schedule:
    """A registered issue order for the exchange fold."""

    name: str = "?"
    description: str = ""

    def resolve_n_chunks(self, n_chunks: Optional[int]) -> int:
        """Feature-wave count this schedule runs (serial: 1)."""
        return 1


_FORMATS: Dict[str, Format] = {}
_SCHEDULES: Dict[str, Schedule] = {}
_TOPOLOGIES: Dict[str, Any] = {}   # name -> repro_torch.topology.Topology

DEFAULT_TOPOLOGY = "hypercube"

AUTO_SPEC = "auto"


def _options(plural: str, table) -> str:
    return f"registered {plural}: {sorted(table)}"


def _ensure_topologies() -> None:
    """Import the built-in topologies on first lookup (registration lives
    in ``repro_torch/topology/__init__.py``)."""
    if not _TOPOLOGIES:
        import repro_torch.topology  # noqa: F401  (registers built-ins)


def register_format(name: str) -> Callable:
    """Class decorator: instantiate and register a :class:`Format`."""
    def deco(cls):
        inst = cls()
        inst.name = name
        if not inst.schedules:
            raise ValueError(f"format {name!r} declares no schedules")
        _FORMATS[name] = inst
        return cls
    return deco


def register_schedule(name: str) -> Callable:
    """Class decorator: instantiate and register a :class:`Schedule`."""
    def deco(cls):
        inst = cls()
        inst.name = name
        _SCHEDULES[name] = inst
        return cls
    return deco


def register_topology(name: str) -> Callable:
    """Class decorator: instantiate and register a
    :class:`repro_torch.topology.Topology`."""
    def deco(cls):
        inst = cls()
        inst.name = name
        _TOPOLOGIES[name] = inst
        return cls
    return deco


def get_format(name: str) -> Format:
    try:
        return _FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown format {name!r}; "
                         + _options("formats", _FORMATS)) from None


def get_schedule(name: str) -> Schedule:
    try:
        return _SCHEDULES[name]
    except KeyError:
        raise ValueError(f"unknown schedule {name!r}; "
                         + _options("schedules", _SCHEDULES)) from None


def get_topology(name: str):
    """The registered topology ``name``; an unregistered name raises
    ``ValueError`` listing the registered ones."""
    _ensure_topologies()
    try:
        return _TOPOLOGIES[name]
    except KeyError:
        raise ValueError(f"unknown topology {name!r}; "
                         + _options("topologies", _TOPOLOGIES)) from None


def available_formats() -> List[str]:
    return sorted(_FORMATS)


def available_schedules() -> List[str]:
    return sorted(_SCHEDULES)


def available_topologies() -> List[str]:
    _ensure_topologies()
    return sorted(_TOPOLOGIES)


def available_partitions() -> List[str]:
    """Partition-quality names (spec part 4), from
    :data:`repro_torch.graph.partition.PARTITIONS`."""
    from repro_torch.graph.partition import PARTITIONS
    return sorted(PARTITIONS)


def format_topologies(fmt: str) -> List[str]:
    """Topology names ``fmt`` supports (its restriction, or all)."""
    f = get_format(fmt)
    if f.topologies is None:
        return available_topologies()
    return sorted(f.topologies)


def supported_specs(*, three_part: bool = False) -> List[str]:
    """Every valid spec spelling, sorted: the two-part
    ``"format+schedule"`` spellings (topology ``hypercube``) plus
    ``"auto"``, or with ``three_part=True`` the concrete
    ``"format+schedule+topology"`` product, respecting each format's
    ``topologies`` (the planner's candidates; no ``"auto"``)."""
    if three_part:
        return sorted(f"{f}+{s}+{t}" for f, fmt in _FORMATS.items()
                      for s in fmt.schedules for t in format_topologies(f))
    return sorted([f"{f}+{s}" for f, fmt in _FORMATS.items()
                   for s in fmt.schedules] + [AUTO_SPEC])


def supported_topology_specs() -> List[str]:
    """Every valid ``"format+schedule+topology"`` combination, sorted
    (``supported_specs(three_part=True)``)."""
    return supported_specs(three_part=True)


def validate_combo(fmt: str, schedule: str,
                   topology: Optional[str] = None) -> None:
    """Raise ``ValueError`` (listing the options) on any invalid combo."""
    f = get_format(fmt)
    get_schedule(schedule)
    if schedule not in f.schedules:
        raise ValueError(
            f"format {fmt!r} does not support schedule {schedule!r} "
            f"(it supports {list(f.schedules)}); valid combinations: "
            f"{supported_specs()}")
    if topology is not None:
        get_topology(topology)      # an unregistered name raises here
        if f.topologies is not None and topology not in f.topologies:
            raise ValueError(
                f"format {fmt!r} does not support topology {topology!r} "
                f"(it supports {sorted(f.topologies)}); valid "
                f"combinations: {supported_topology_specs()}")
