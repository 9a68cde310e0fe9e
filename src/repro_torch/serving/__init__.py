"""Online GCN inference service (port of :mod:`repro.serving`).

The request queue + coalescer, the versioned embedding cache, the mutable
serving graph, the :class:`InferenceEngine` that runs layered queries on
the card through the ported Engine, the single-worker
:class:`InferenceService` loop and the open-loop load generator.
"""
from .cache import EmbeddingCache
from .engine import (InferenceEngine, load_checkpoint_params,
                     params_from_reference)
from .graph import DynamicGraph
from .loadgen import Arrival, percentile, poisson_trace, summarize
from .queue import InferenceRequest, MicroBatch, RequestQueue
from .service import InferenceService

__all__ = [
    "EmbeddingCache", "InferenceEngine", "load_checkpoint_params",
    "params_from_reference", "DynamicGraph", "Arrival", "percentile",
    "poisson_trace", "summarize", "InferenceRequest", "MicroBatch",
    "RequestQueue", "InferenceService",
]
