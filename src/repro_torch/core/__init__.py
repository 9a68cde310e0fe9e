from .blockmsg import BlockMessage, compress_block, sender_merge_flat
from .gcn import gcn_layer, segment_sum_rows
from .schedule import FeatureWave, feature_waves

__all__ = ["BlockMessage", "compress_block", "sender_merge_flat",
           "gcn_layer", "segment_sum_rows", "FeatureWave", "feature_waves"]
