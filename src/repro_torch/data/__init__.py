from .graph_pipeline import (GraphBatchPipeline, Prefetcher, assemble_batch,
                             gather_features, sample_batch)

__all__ = ["GraphBatchPipeline", "Prefetcher", "assemble_batch",
           "gather_features", "sample_batch"]
