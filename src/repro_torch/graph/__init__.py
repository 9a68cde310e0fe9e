from .coo import COO, from_edges, mean_normalize, sym_normalize
from .sampler import CSRGraph, csr_from_edges
from .datasets import DATASET_STATS, DatasetStats, GraphDataset, make_dataset

__all__ = [
    "COO", "from_edges", "mean_normalize", "sym_normalize",
    "CSRGraph", "csr_from_edges",
    "DATASET_STATS", "DatasetStats", "GraphDataset", "make_dataset",
]
