from .coo import COO, from_edges, mean_normalize, pad_coo, sym_normalize
from .convert import sort_col_major, sort_row_major, to_backward
from .partition import (BlockedCOO, anti_diagonal_stages, block_partition,
                        core_of, diagonal_storage_mask, local_addr,
                        pad_to_multiple, partition_features,
                        sender_blocks)
from .sampler import (CSRGraph, MiniBatch, NeighborSampler, csr_from_edges,
                      epoch_batches)
from .datasets import DATASET_STATS, DatasetStats, GraphDataset, make_dataset

__all__ = [
    "COO", "from_edges", "mean_normalize", "pad_coo", "sym_normalize",
    "sort_col_major", "sort_row_major", "to_backward",
    "BlockedCOO", "anti_diagonal_stages", "block_partition", "core_of",
    "diagonal_storage_mask", "local_addr", "pad_to_multiple",
    "partition_features", "sender_blocks",
    "CSRGraph", "MiniBatch", "NeighborSampler", "csr_from_edges",
    "epoch_batches",
    "DATASET_STATS", "DatasetStats", "GraphDataset", "make_dataset",
]
