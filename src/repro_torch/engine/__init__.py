# The declarative Engine API (port): format x schedule registry with the
# coo and ell formats, the 4-part spec grammar, and the single-device layer.
from .config import EngineConfig
from .engine import Engine
from .registry import (Format, Schedule, get_format, get_schedule,
                       register_format, register_schedule, supported_specs)

__all__ = [
    "Engine", "EngineConfig", "Format", "Schedule", "register_format",
    "register_schedule", "get_format", "get_schedule", "supported_specs",
]
