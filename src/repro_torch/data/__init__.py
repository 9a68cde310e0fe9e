from .graph_pipeline import (GraphBatchPipeline, Prefetcher,
                             StagedPrefetcher, assemble_batch,
                             gather_features, sample_batch)
from .tokens import TokenPipeline, make_lm_batch, synthetic_frames

__all__ = ["GraphBatchPipeline", "Prefetcher", "StagedPrefetcher",
           "assemble_batch", "gather_features", "sample_batch",
           "TokenPipeline", "make_lm_batch", "synthetic_frames"]
