from .graph_pipeline import (GraphBatchPipeline, Prefetcher,
                             StagedPrefetcher, assemble_batch,
                             gather_features, sample_batch)
from .tokens import (TokenPipeline, lm_batch_specs, make_lm_batch,
                     synthetic_frames)

__all__ = ["GraphBatchPipeline", "Prefetcher", "StagedPrefetcher",
           "assemble_batch", "gather_features", "sample_batch",
           "TokenPipeline", "lm_batch_specs", "make_lm_batch",
           "synthetic_frames"]
