from .manager import CheckpointManager
from .elastic import ScalePlan, gather_global, scale_plan
from .health import Action, HealthMonitor

__all__ = ["CheckpointManager", "ScalePlan", "gather_global", "scale_plan",
           "Action", "HealthMonitor"]
