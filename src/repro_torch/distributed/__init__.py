# The stacked-core distributed aggregation (port of repro.distributed):
#   aggregate.py — edge shards per sender core + the coo and ell aggregates
#                  (autograd Functions with the mirror backward)
#   overlap.py   — double-buffered exchange rounds of the pipelined fold
from .aggregate import (EdgeShards, EllEdgeShards, hypercube_aggregate,
                        hypercube_aggregate_ell, shard_edges, shard_edges_ell)
from .overlap import double_buffered_exchange, double_buffered_rounds

__all__ = ["EdgeShards", "EllEdgeShards", "hypercube_aggregate",
           "hypercube_aggregate_ell", "shard_edges", "shard_edges_ell",
           "double_buffered_exchange", "double_buffered_rounds"]
