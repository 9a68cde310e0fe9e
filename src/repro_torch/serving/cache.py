"""Versioned historical-embedding cache — the incremental-aggregation core
(port of :mod:`repro.serving.cache`; host-side numpy, unchanged).

Entries are keyed ``(layer, vertex)`` and hold the vertex's HIDDEN
activation after that GCN layer (layers ``1..L-1``; final-layer logits are
never cached — they are cheap once the hop-(L-1) embeddings exist, and
keeping them out makes every served logit a fresh last-layer compute).

**Validity is explicit, not versioned-out:** an entry stays servable until
an :meth:`invalidate` call removes it — the InferenceEngine's
``update_edges`` / ``update_features`` frontier walk names exactly the
``(layer, vertex)`` pairs whose inputs changed, and only those are dropped.
The ``version`` counter (bumped once per update batch) is stamped on every
entry at insert time purely for *staleness accounting*: a hit on an entry
whose stamp predates the current version is a vertex legitimately served
from history (its neighborhood did not change), and
``max_staleness_served`` records how far back the cache has reached.

Eviction is LRU over all entries with a row-count ``capacity``; pinned
regions are a feature-store concern (the reference's
``HotVertexCache``), not an embedding-cache one — embeddings go stale,
features do not.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

Key = Tuple[int, int]


class EmbeddingCache:
    """LRU of ``(layer, vertex) → (embedding row, version stamp)``."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._entries: "OrderedDict[Key, Tuple[np.ndarray, int]]" = \
            OrderedDict()
        self.version = 0            # bumped once per update_* batch
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.invalidations = 0
        self.stale_hits = 0         # hits on entries stamped < version
        self.max_staleness_served = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Key) -> bool:
        return (int(key[0]), int(key[1])) in self._entries

    # -- read/write -----------------------------------------------------------
    def get(self, layer: int, vertex: int) -> Optional[np.ndarray]:
        ent = self._entries.get((int(layer), int(vertex)))
        if ent is None:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end((int(layer), int(vertex)))
        row, stamp = ent
        if stamp < self.version:
            self.stale_hits += 1
            self.max_staleness_served = max(self.max_staleness_served,
                                            self.version - stamp)
        return row

    def put(self, layer: int, vertex: int, row: np.ndarray) -> None:
        key = (int(layer), int(vertex))
        if key in self._entries:
            self._entries.move_to_end(key)
        elif len(self._entries) >= self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        self._entries[key] = (np.asarray(row), self.version)
        self.insertions += 1

    # -- invalidation ---------------------------------------------------------
    def invalidate(self, layer: int, vertices: Iterable[int]) -> int:
        """Drop the entries for ``vertices`` at ``layer``; returns how many
        actually existed (the invalidation counter counts real drops, so a
        frontier walk over mostly-uncached vertices reads as cheap)."""
        dropped = 0
        for v in vertices:
            if self._entries.pop((int(layer), int(v)), None) is not None:
                dropped += 1
        self.invalidations += dropped
        return dropped

    def bump_version(self) -> int:
        self.version += 1
        return self.version

    def clear(self) -> None:
        self.invalidations += len(self._entries)
        self._entries.clear()

    # -- metrics --------------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {"capacity": self.capacity, "entries": len(self._entries),
                "version": self.version, "hits": self.hits,
                "misses": self.misses, "hit_rate": self.hit_rate,
                "insertions": self.insertions, "evictions": self.evictions,
                "invalidations": self.invalidations,
                "stale_hits": self.stale_hits,
                "max_staleness_served": self.max_staleness_served}
