# The stacked-core distributed aggregation (port of repro.distributed):
#   aggregate.py — edge shards per sender core + the coo and ell aggregates
#                  (autograd Functions with the mirror backward), and the
#                  UMA baseline over receiver-side shards
#   overlap.py   — double-buffered exchange rounds of the pipelined fold,
#                  microbatched gradient accumulation
# hypercube_allgather / hypercube_reduce_scatter are the hypercube's
# collectives, which the port keeps with its topology (topology/hypercube.py).
from .aggregate import (EdgeShards, EllEdgeShards, hypercube_aggregate,
                        hypercube_aggregate_ell, shard_edges,
                        shard_edges_by_dst, shard_edges_ell, uma_aggregate)
from .overlap import (double_buffered_exchange, double_buffered_rounds,
                      grad_accum)
from repro_torch.topology.hypercube import (hypercube_allgather,
                                            hypercube_reduce_scatter)

__all__ = ["EdgeShards", "EllEdgeShards", "hypercube_aggregate",
           "hypercube_aggregate_ell", "hypercube_allgather",
           "hypercube_reduce_scatter", "shard_edges", "shard_edges_by_dst",
           "shard_edges_ell", "uma_aggregate", "double_buffered_exchange",
           "double_buffered_rounds", "grad_accum"]
