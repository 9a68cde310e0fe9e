"""Degree-keyed hot-vertex cache in front of a FeatureStore (port of
:mod:`repro.featurestore.cache`).

Power-law graphs concentrate frontier traffic on a few hub vertices, so a
small cache of the highest-degree vertices absorbs much of the gather
volume: a frontier row that hits the cache never touches the backing store
(no RAM read for ``host``, no disk page for ``mmap``).

Two regions share the cache's ``capacity`` rows:

* **pinned** — the ``pinned`` highest-degree vertices, gathered once at
  construction and never evicted.  "Pinned" names these rows, not
  page-locked host memory;
* **dynamic** — the other slots, an LRU of recently missed vertices.

``gather(ids)`` is bit-exact with ``store.gather(ids)`` (cached rows are
verbatim copies), so the cache changes traffic, never values, and the
batch-exact ``(seed, epoch, batch_idx)`` resume contract holds.  As in the
reference, each requested id is looked up in a Python dict and the LRU
inserts row by row.  :attr:`HotVertexCache.device_rows` is the pinned block
as a tensor on the cache's device, built once.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class HotVertexCache:
    """``capacity`` feature rows pinned or LRU-cached in front of ``store``.

    Parameters
    ----------
    store: the backing :class:`~repro_torch.featurestore.FeatureStore`
        (anything with ``gather`` / ``shape`` / ``dtype``).
    degrees: ``[n_nodes]`` vertex degrees, the pin key (equal degrees pin
        the lower vertex id).
    capacity: total cached rows.
    pinned: rows reserved for the top-degree vertices (default: half the
        capacity; the rest is the LRU region).
    device: where :attr:`device_rows` lives (``None`` → the card; raises
        without one).
    """

    def __init__(self, store, degrees: np.ndarray, capacity: int,
                 pinned: Optional[int] = None,
                 device: DeviceLike = None) -> None:
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.device = resolve_device(device)
        n = store.shape[0]
        capacity = min(int(capacity), n)
        if pinned is None:
            pinned = capacity // 2 if capacity > 1 else capacity
        pinned = min(int(pinned), capacity)
        self.store = store
        self.capacity = capacity
        self.n_pinned = pinned
        d = store.shape[1]
        degrees = np.asarray(degrees)
        if degrees.shape[0] != n:
            raise ValueError(f"degrees has {degrees.shape[0]} entries for "
                             f"a {n}-row store")
        # stable sort on -degree: equal degrees pin the lower vertex id
        hot = np.argsort(-degrees.astype(np.int64),
                         kind="stable")[:pinned].astype(np.int64)
        self._rows = np.empty((capacity, d), store.dtype)
        if pinned:
            self._rows[:pinned] = store.gather(hot)
        self.pinned_ids = frozenset(int(v) for v in hot)
        self._slot: Dict[int, int] = {int(v): i for i, v in enumerate(hot)}
        # LRU over the dynamic region: vertex id -> slot, oldest first
        self._lru: "OrderedDict[int, int]" = OrderedDict()
        self._free = list(range(capacity - 1, pinned - 1, -1))
        self._device_rows: Optional[torch.Tensor] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.insertions = 0
        self.bytes_served = 0       # bytes returned to callers
        self.bytes_from_store = 0   # bytes that reached the store
        self.warm_bytes = pinned * d * store.dtype.itemsize

    # -- the gather front door ----------------------------------------------
    def gather(self, indices) -> np.ndarray:
        """``store.gather(indices)``, bit-exact, fetching only the rows the
        cache does not hold.  The counters count REQUESTED rows, duplicates
        included (a padded frontier repeats its pad vertex)."""
        idx = np.asarray(indices, dtype=np.int64)
        out = np.empty((len(idx),) + self.store.shape[1:], self.store.dtype)
        slots = np.fromiter((self._slot.get(int(v), -1) for v in idx),
                            np.int64, len(idx))
        hit = slots >= 0
        n_hit = int(hit.sum())
        self.hits += n_hit
        self.misses += len(idx) - n_hit
        if n_hit:
            out[hit] = self._rows[slots[hit]]
            for v in idx[hit]:
                v = int(v)
                if v in self._lru:          # refresh recency on LRU hits
                    self._lru.move_to_end(v)
        miss_pos = np.flatnonzero(~hit)
        if len(miss_pos):
            uniq, inv = np.unique(idx[miss_pos], return_inverse=True)
            fetched = self.store.gather(uniq)
            self.bytes_from_store += fetched.nbytes
            out[miss_pos] = fetched[inv]
            self._insert(uniq, fetched)
        self.bytes_served += out.nbytes
        return out

    # the ndarray facade, so the cache stands wherever a store does
    def __getitem__(self, idx) -> np.ndarray:
        return self.gather(idx)

    def __len__(self) -> int:
        return self.store.shape[0]

    @property
    def shape(self) -> tuple:
        return self.store.shape

    @property
    def dtype(self):
        return self.store.dtype

    # -- LRU region ------------------------------------------------------------
    def _insert(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Install fetched rows in the dynamic region, evicting the least
        recently used; pinned slots are never recycled."""
        room = self.capacity - self.n_pinned
        if room <= 0:
            return
        if len(ids) > room:         # only the tail fits
            ids, rows = ids[-room:], rows[-room:]
        for v, row in zip(ids, rows):
            v = int(v)
            if self._free:
                slot = self._free.pop()
            else:
                old, slot = self._lru.popitem(last=False)  # oldest out
                del self._slot[old]
                self.evictions += 1
            self._rows[slot] = row
            self._slot[v] = slot
            self._lru[v] = slot
            self.insertions += 1

    # -- metrics ---------------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {"capacity": self.capacity, "pinned": self.n_pinned,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate, "evictions": self.evictions,
                "insertions": self.insertions,
                "bytes_served": self.bytes_served,
                "bytes_from_store": self.bytes_from_store}

    def reset_stats(self) -> None:
        self.hits = self.misses = 0
        self.evictions = self.insertions = 0
        self.bytes_served = self.bytes_from_store = 0

    # -- device residency ------------------------------------------------------
    @property
    def device_rows(self) -> torch.Tensor:
        """The pinned block as a ``[pinned, d]`` tensor on the cache's
        device, copied once from the host mirror the gathers read."""
        if self._device_rows is None:
            self._device_rows = torch.from_numpy(
                self._rows[:self.n_pinned].copy()).to(self.device)
        return self._device_rows
