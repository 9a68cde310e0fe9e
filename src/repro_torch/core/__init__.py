# The paper's primary contribution: the transpose-free GCN training
# dataflow (gcn.py vs baseline.py, chosen by estimator.py) and the 4-D
# hypercube parallel-multicast message-passing layer (routing.py,
# blockmsg.py, schedule.py).
from .blockmsg import (BlockMessage, Wave, build_waves, compress_block,
                       message_rowlists, sender_merge_flat, wave_statistics)
from .gcn import gcn_layer, residual_bytes, segment_sum_rows
from .baseline import gcn_layer_baseline, residual_bytes_naive
from .estimator import (CostEstimate, LayerShape, choose_order,
                        layer_shapes_for_batch, storage_naive, storage_ours,
                        time_naive, time_ours)
from .routing import (RoutingResult, aggregate_bandwidth_model,
                      fuse_experiment, make_fuse_wave, route_messages,
                      validate_routing, xor_path_set)
from .schedule import (AggregationPlan, FeatureWave, Round, allgather_rounds,
                       compare_schedules, dimension_ordered_table,
                       feature_waves, make_plan, reduce_scatter_rounds,
                       round_bytes)

__all__ = ["BlockMessage", "Wave", "build_waves", "compress_block",
           "message_rowlists", "sender_merge_flat", "wave_statistics",
           "gcn_layer", "residual_bytes", "segment_sum_rows",
           "gcn_layer_baseline", "residual_bytes_naive",
           "CostEstimate", "LayerShape", "choose_order",
           "layer_shapes_for_batch", "storage_naive", "storage_ours",
           "time_naive", "time_ours",
           "RoutingResult", "aggregate_bandwidth_model", "fuse_experiment",
           "make_fuse_wave", "route_messages", "validate_routing",
           "xor_path_set",
           "AggregationPlan", "FeatureWave", "Round", "allgather_rounds",
           "compare_schedules", "dimension_ordered_table", "feature_waves",
           "make_plan", "reduce_scatter_rounds", "round_bytes"]
