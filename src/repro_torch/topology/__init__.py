# The interconnect axis of the Engine (port of repro.topology) on the
# stacked-core layout.  Only the hypercube is ported; the registry names the
# reference's other topologies and raises NotImplementedError for them.
from repro_torch.engine.registry import register_topology

from .base import Topology, allgather, reduce_scatter
from .hypercube import HypercubeTopology

register_topology("hypercube")(HypercubeTopology)

__all__ = ["Topology", "HypercubeTopology", "allgather", "reduce_scatter"]
