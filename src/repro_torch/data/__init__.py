from .graph_pipeline import (GraphBatchPipeline, Prefetcher,
                             StagedPrefetcher, assemble_batch,
                             gather_features, sample_batch)

__all__ = ["GraphBatchPipeline", "Prefetcher", "StagedPrefetcher",
           "assemble_batch", "gather_features", "sample_batch"]
