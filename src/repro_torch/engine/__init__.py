# The declarative Engine API (port): the format x schedule x topology
# registry, the 4-part spec grammar, the single-device layer and the
# distributed bundle.
from .config import EngineConfig
from .engine import Engine, EngineBundle
from .plans import RecordStore
from .registry import (AUTO_SPEC, Format, Schedule, available_formats,
                       available_partitions, available_schedules,
                       available_topologies, format_topologies, get_format,
                       get_schedule, get_topology, register_format,
                       register_schedule, register_topology, supported_specs,
                       supported_topology_specs)

__all__ = [
    "Engine", "EngineBundle", "EngineConfig", "RecordStore", "AUTO_SPEC",
    "Format", "Schedule", "register_format", "register_schedule",
    "register_topology", "get_format", "get_schedule", "get_topology",
    "available_formats", "available_schedules", "available_topologies",
    "available_partitions", "format_topologies", "supported_specs",
    "supported_topology_specs",
]
