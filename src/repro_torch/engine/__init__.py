# The declarative Engine API (port): the format x schedule x topology
# registry, the 4-part spec grammar, the single-device layer and the
# distributed bundle.
from .config import EngineConfig
from .engine import Engine
from .registry import (Format, Schedule, available_partitions,
                       available_topologies, format_topologies, get_format,
                       get_schedule, get_topology, register_format,
                       register_schedule, register_topology, supported_specs,
                       supported_topology_specs)

__all__ = [
    "Engine", "EngineConfig", "Format", "Schedule", "register_format",
    "register_schedule", "register_topology", "get_format", "get_schedule",
    "get_topology", "available_topologies", "available_partitions",
    "format_topologies", "supported_specs", "supported_topology_specs",
]
