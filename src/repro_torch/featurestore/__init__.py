# Out-of-core feature stores (port of repro.featurestore): node features
# behind a pluggable backend registry (host RAM / mmap'd disk), gathered one
# frontier at a time by the staged input pipeline
# (repro_torch.data.StagedPrefetcher), with a degree-keyed hot-vertex cache
# in front of the store.
from .cache import HotVertexCache
from .store import (FeatureStore, HostStore, MmapStore, available_stores,
                    get_store, register_store)

__all__ = [
    "FeatureStore", "HostStore", "MmapStore", "HotVertexCache",
    "register_store", "get_store", "available_stores",
]
