from .manager import CheckpointManager
from .elastic import (ScalePlan, gather_global, make_mesh_from_plan, reshard,
                      scale_plan, shardings_like)
from .health import Action, HealthMonitor

__all__ = ["CheckpointManager", "ScalePlan", "gather_global",
           "make_mesh_from_plan", "reshard", "scale_plan", "shardings_like",
           "Action", "HealthMonitor"]
