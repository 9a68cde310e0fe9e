from .coo import COO, from_edges, mean_normalize, pad_coo, sym_normalize
from .convert import sort_col_major, sort_row_major, to_backward
from .sampler import (CSRGraph, MiniBatch, NeighborSampler, csr_from_edges,
                      epoch_batches)
from .datasets import DATASET_STATS, DatasetStats, GraphDataset, make_dataset

__all__ = [
    "COO", "from_edges", "mean_normalize", "pad_coo", "sym_normalize",
    "sort_col_major", "sort_row_major", "to_backward",
    "CSRGraph", "MiniBatch", "NeighborSampler", "csr_from_edges",
    "epoch_batches",
    "DATASET_STATS", "DatasetStats", "GraphDataset", "make_dataset",
]
