# The stacked-core distributed aggregation (port of repro.distributed):
#   aggregate.py — edge shards per sender core + the coo and ell aggregates
#                  (autograd Functions with the mirror backward), and the
#                  UMA baseline over receiver-side shards
#   overlap.py   — double-buffered exchange rounds of the pipelined fold,
#                  microbatched gradient accumulation
from .aggregate import (EdgeShards, EllEdgeShards, hypercube_aggregate,
                        hypercube_aggregate_ell, shard_edges,
                        shard_edges_by_dst, shard_edges_ell, uma_aggregate)
from .overlap import (double_buffered_exchange, double_buffered_rounds,
                      grad_accum)

__all__ = ["EdgeShards", "EllEdgeShards", "hypercube_aggregate",
           "hypercube_aggregate_ell", "shard_edges", "shard_edges_by_dst",
           "shard_edges_ell", "uma_aggregate", "double_buffered_exchange",
           "double_buffered_rounds", "grad_accum"]
