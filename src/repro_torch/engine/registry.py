"""Format/schedule registry (port of :mod:`repro.engine.registry`).

A **format** owns one edge layout: how a COO becomes that layout
(``build_local``) and the single-device GCN layer that walks it.  A
**schedule** names an issue order for the distributed exchange fold.  The
registry keeps the reference's contract: registering a class makes it
reachable from every spec string, and unknown names raise ``ValueError``
listing the registered options.

Ported so far: the ``coo`` and ``ell`` formats and both schedules.  The
``block`` format, the ``"auto"`` spec and the topologies' exchange code
come with later slices; their names stay known so the spec grammar parses
the same strings as the reference and says which slice brings them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple


class Format:
    """Base class for registered edge formats.

    ``schedules`` lists the supported schedule names (first = default).
    """

    name: str = "?"
    schedules: Tuple[str, ...] = ()
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


class Schedule:
    """A registered issue order for the exchange fold."""

    name: str = "?"
    description: str = ""


_FORMATS: Dict[str, Format] = {}
_SCHEDULES: Dict[str, Schedule] = {}

#: the interconnects of the reference; their exchange code is ported with
#: the distributed slice, and a single-device layer never reaches it
TOPOLOGIES: Tuple[str, ...] = ("allpairs", "hypercube", "ring", "torus2d")
DEFAULT_TOPOLOGY = "hypercube"

#: partition-quality names (spec part 4), kept for the grammar
PARTITIONS: Tuple[str, ...] = ("naive", "mincom")

#: names the reference registers whose port is later work, with the slice
#: that brings each (ROADMAP, port Queue 1)
LATER_FORMATS: Dict[str, str] = {
    "block": "the Block-Message slice (spmm_block kernel)",
}
AUTO_SPEC = "auto"
AUTO_SLICE = "the planner slice"


def _options(plural: str, table) -> str:
    return f"registered {plural}: {sorted(table)}"


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


def get_format(name: str) -> Format:
    if name in LATER_FORMATS:
        raise NotImplementedError(
            f"format {name!r} is not ported yet; it comes with "
            f"{LATER_FORMATS[name]}")
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


def validate_topology(name: str) -> str:
    if name not in TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; "
                         + _options("topologies", TOPOLOGIES))
    return name


def validate_partition(name: str) -> str:
    if name not in PARTITIONS:
        raise ValueError(f"unknown partition {name!r}; "
                         f"registered partitions: {PARTITIONS}")
    return name


def supported_specs() -> List[str]:
    """Every ported two-part ``"format+schedule"`` spelling, sorted."""
    return sorted(f"{f}+{s}" for f, fmt in _FORMATS.items()
                  for s in fmt.schedules)


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
        validate_topology(topology)
