# The paper's primary contribution: the transpose-free GCN training
# dataflow (gcn.py vs baseline.py, chosen by estimator.py) and the
# Block-Message layout (blockmsg.py, schedule.py's feature waves).
from .blockmsg import BlockMessage, compress_block, sender_merge_flat
from .gcn import gcn_layer, residual_bytes, segment_sum_rows
from .baseline import gcn_layer_baseline, residual_bytes_naive
from .estimator import (CostEstimate, LayerShape, choose_order,
                        layer_shapes_for_batch, storage_naive, storage_ours,
                        time_naive, time_ours)
from .schedule import FeatureWave, feature_waves

__all__ = ["BlockMessage", "compress_block", "sender_merge_flat",
           "gcn_layer", "residual_bytes", "segment_sum_rows",
           "gcn_layer_baseline", "residual_bytes_naive",
           "CostEstimate", "LayerShape", "choose_order",
           "layer_shapes_for_batch", "storage_naive", "storage_ours",
           "time_naive", "time_ours", "FeatureWave", "feature_waves"]
