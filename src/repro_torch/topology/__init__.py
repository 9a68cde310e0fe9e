# The interconnect axis of the Engine (port of repro.topology) on the
# stacked-core layout, or across the ranks of a torch.distributed mesh
# (CoreLayout): the Topology base class, the exchange plan, the
# differentiable exchange primitives and the four built-in topologies.
# Registration happens here, so the topology modules stay cycle-free.
from repro_torch.engine.registry import register_topology

from .allpairs import AllPairsTopology
from .base import (CoreLayout, ExchangePlan, Topology, allgather, exchange,
                   reduce_scatter)
from .hypercube import HypercubeTopology
from .ring import RingTopology
from .torus2d import Torus2DTopology

register_topology("hypercube")(HypercubeTopology)
register_topology("allpairs")(AllPairsTopology)
register_topology("ring")(RingTopology)
register_topology("torus2d")(Torus2DTopology)

__all__ = [
    "CoreLayout", "ExchangePlan", "Topology", "exchange", "reduce_scatter",
    "allgather",
    "HypercubeTopology", "AllPairsTopology", "RingTopology",
    "Torus2DTopology",
]
