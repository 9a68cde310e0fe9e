from .blockmsg import BlockMessage, compress_block
from .gcn import gcn_layer, segment_sum_rows

__all__ = ["BlockMessage", "compress_block", "gcn_layer", "segment_sum_rows"]
