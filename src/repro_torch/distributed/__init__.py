# The stacked-core distributed aggregation (port of repro.distributed):
#   aggregate.py — edge shards per sender core + the coo and ell aggregates
#                  (autograd Functions with the mirror backward), the UMA
#                  baseline over receiver-side shards, and the analytic
#                  wire bytes of both (schedule_bytes)
#   compress.py  — the int8 error-feedback hypercube all-reduce of the
#                  Weight-Bank gradient sync
#   overlap.py   — double-buffered exchange rounds of the pipelined fold,
#                  microbatched gradient accumulation (all-reduced over the
#                  current mesh's named axes)
#   sharding.py  — placement rules over a torch.distributed DeviceMesh: the
#                  reference's PartitionSpec rules as tuples, DTensor
#                  placements, each rank's block of a per-core leaf, and
#                  NamedSharding with the moves between placed trees
# hypercube_allgather / hypercube_reduce_scatter are the hypercube's
# collectives, which the port keeps with its topology (topology/hypercube.py).
from .aggregate import (EdgeShards, EllEdgeShards, hypercube_aggregate,
                        hypercube_aggregate_ell, schedule_bytes, shard_edges,
                        shard_edges_by_dst, shard_edges_ell, uma_aggregate)
from .overlap import (double_buffered_exchange, double_buffered_rounds,
                      grad_accum)
from repro_torch.topology.hypercube import (hypercube_allgather,
                                            hypercube_reduce_scatter)
from .compress import (compressed_psum, compression_ratio, ef_compress_grads,
                       init_error_state)
from . import sharding

__all__ = ["EdgeShards", "EllEdgeShards", "hypercube_aggregate",
           "hypercube_aggregate_ell", "hypercube_allgather",
           "hypercube_reduce_scatter", "schedule_bytes", "shard_edges",
           "shard_edges_by_dst", "shard_edges_ell", "uma_aggregate",
           "compressed_psum", "compression_ratio", "ef_compress_grads",
           "init_error_state", "double_buffered_exchange",
           "double_buffered_rounds", "grad_accum", "sharding"]
