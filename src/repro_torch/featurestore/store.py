"""Out-of-core feature stores: node features behind a pluggable backend
(port of :mod:`repro.featurestore.store`).

The full ``[n, d]`` feature matrix stays in host memory (or on disk) and
only each mini-batch's frontier rows travel to the card.  A
:class:`FeatureStore` is that backing matrix: it looks like a read-only 2-D
ndarray (``shape``, ``dtype``, fancy row indexing), so every
``dataset.features`` consumer — :func:`repro_torch.data.assemble_batch`,
the Trainer's validation path, ``EngineBundle.prepare_batch`` — works
unchanged, while every row read is an explicit, counted ``gather``.

Backends live in a registry, like the Engine's formats::

    from repro_torch.featurestore import FeatureStore, register_store

    @register_store("redis")
    class RedisStore(FeatureStore):
        ...

after which ``Trainer(feature_store="redis")`` and
``make_dataset(features="redis")`` reach it with no other change.
Built-ins: ``host`` (one ndarray in RAM) and ``mmap`` (a memory-mapped
``.npy`` file with a chunked writer, so features far beyond RAM are
generated and served without ever being dense in memory).  A store is numpy
on the host, never a device tensor.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np


class FeatureStore:
    """Base class of the registered backends.

    Subclasses implement :meth:`_rows` (the raw row copy-out) and the
    writer half (:meth:`create` + :meth:`write_chunk`); ``name`` is set by
    :func:`register_store`.  The base class owns the ndarray facade and the
    gather accounting: ``gather_calls`` / ``bytes_gathered`` count the
    traffic that reached the backing store (a hit in a
    :class:`~repro_torch.featurestore.HotVertexCache` never shows here).
    """

    name: str = "?"

    def __init__(self, n_nodes: int, feat_dim: int,
                 dtype=np.float32) -> None:
        self.n_nodes = int(n_nodes)
        self.feat_dim = int(feat_dim)
        self.dtype = np.dtype(dtype)
        self.gather_calls = 0
        self.bytes_gathered = 0
        self._sealed = False

    # -- ndarray facade ------------------------------------------------------
    @property
    def shape(self) -> tuple:
        return (self.n_nodes, self.feat_dim)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def nbytes(self) -> int:
        return self.n_nodes * self.feat_dim * self.dtype.itemsize

    def __len__(self) -> int:
        return self.n_nodes

    def __getitem__(self, idx) -> np.ndarray:
        """Fancy row indexing is a counted :meth:`gather`."""
        return self.gather(idx)

    # -- reads ---------------------------------------------------------------
    def gather(self, indices) -> np.ndarray:
        """Copy the given rows out of the store: ``[len(indices), d]``.
        Every call is counted (``gather_calls`` / ``bytes_gathered``)."""
        idx = np.asarray(indices, dtype=np.int64)
        out = self._rows(idx)
        self.gather_calls += 1
        self.bytes_gathered += out.nbytes
        return out

    def as_array(self) -> np.ndarray:
        """The whole matrix, dense and uncounted (tests and small stores)."""
        return self._rows(np.arange(self.n_nodes, dtype=np.int64))

    def _rows(self, idx: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- writes (chunked, for out-of-core generation) ------------------------
    @classmethod
    def create(cls, n_nodes: int, feat_dim: int, dtype=np.float32,
               **kwargs) -> "FeatureStore":
        """An empty writable store; fill it with :meth:`write_chunk`, then
        :meth:`seal` it."""
        raise NotImplementedError

    def write_chunk(self, start: int, rows: np.ndarray) -> None:
        """Write ``rows`` at row offset ``start``."""
        raise NotImplementedError

    def seal(self) -> "FeatureStore":
        """Finish writing; the store becomes read-only.  Returns self."""
        self._sealed = True
        return self

    def _check_write(self, start: int, rows: np.ndarray) -> None:
        if self._sealed:
            raise ValueError(f"{self.name} store is sealed (read-only); "
                             "write_chunk is only valid before seal()")
        if rows.shape[1:] != (self.feat_dim,):
            raise ValueError(f"chunk width {rows.shape[1:]} != feat_dim "
                             f"({self.feat_dim},)")
        if start < 0 or start + len(rows) > self.n_nodes:
            raise ValueError(f"chunk [{start}, {start + len(rows)}) out of "
                             f"range for {self.n_nodes} rows")

    @classmethod
    def from_array(cls, features: np.ndarray, *, chunk_rows: int = 65536,
                   **kwargs) -> "FeatureStore":
        """A sealed store holding a dense matrix, written through the
        chunked writer (the mmap backend streams it to disk)."""
        features = np.asarray(features)
        store = cls.create(features.shape[0], features.shape[1],
                           dtype=features.dtype, **kwargs)
        for s in range(0, features.shape[0], chunk_rows):
            store.write_chunk(s, features[s:s + chunk_rows])
        return store.seal()

    def close(self) -> None:
        """Release backing resources (files for mmap).  Idempotent."""

    def __enter__(self) -> "FeatureStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_STORES: Dict[str, type] = {}


def register_store(name: str) -> Callable:
    """Class decorator: register a :class:`FeatureStore` backend under
    ``name`` (classes, because each instance binds one matrix)."""
    def deco(cls):
        cls.name = name
        _STORES[name] = cls
        return cls
    return deco


def get_store(name: str) -> type:
    try:
        return _STORES[name]
    except KeyError:
        raise ValueError(f"unknown feature store {name!r}; registered "
                         f"stores: {sorted(_STORES)}") from None


def available_stores() -> List[str]:
    return sorted(_STORES)


@register_store("host")
class HostStore(FeatureStore):
    """Host-RAM backend: one contiguous ndarray.  Only gathered frontier
    rows ever become device tensors."""

    def __init__(self, n_nodes: int, feat_dim: int, dtype=np.float32,
                 data: Optional[np.ndarray] = None) -> None:
        super().__init__(n_nodes, feat_dim, dtype)
        self._data = data if data is not None \
            else np.empty((self.n_nodes, self.feat_dim), self.dtype)

    @classmethod
    def create(cls, n_nodes: int, feat_dim: int, dtype=np.float32,
               **kwargs) -> "HostStore":
        return cls(n_nodes, feat_dim, dtype)

    def write_chunk(self, start: int, rows: np.ndarray) -> None:
        self._check_write(start, rows)
        self._data[start:start + len(rows)] = rows

    def _rows(self, idx: np.ndarray) -> np.ndarray:
        return self._data[idx]


@register_store("mmap")
class MmapStore(FeatureStore):
    """Memory-mapped ``.npy`` backend: the features live on disk and the
    page cache is the only RAM they take.  The ``.npy`` header carries the
    shape and dtype, so ``MmapStore.open(path)`` reattaches to a file.

    Created without a path, the store owns a tempfile and unlinks it on
    :meth:`close`.
    """

    def __init__(self, mmap: np.memmap, path: str,
                 owns_path: bool = False) -> None:
        super().__init__(mmap.shape[0], mmap.shape[1], mmap.dtype)
        self._mmap: Optional[np.memmap] = mmap
        self.path = path
        self._owns_path = owns_path

    @classmethod
    def create(cls, n_nodes: int, feat_dim: int, dtype=np.float32,
               path: Optional[str] = None, **kwargs) -> "MmapStore":
        owns = path is None
        if owns:
            fd, path = tempfile.mkstemp(suffix=".npy",
                                        prefix="featurestore-")
            os.close(fd)
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.dtype(dtype),
                                       shape=(int(n_nodes), int(feat_dim)))
        return cls(mm, path, owns_path=owns)

    @classmethod
    def open(cls, path: str) -> "MmapStore":
        store = cls(np.lib.format.open_memmap(path, mode="r"), path)
        store._sealed = True
        return store

    def write_chunk(self, start: int, rows: np.ndarray) -> None:
        self._check_write(start, rows)
        self._mmap[start:start + len(rows)] = rows

    def seal(self) -> "MmapStore":
        """Flush and reopen read-only; a sealed store can be shared across
        processes through its path."""
        self._mmap.flush()
        self._mmap = np.lib.format.open_memmap(self.path, mode="r")
        return super().seal()

    def _rows(self, idx: np.ndarray) -> np.ndarray:
        # fancy indexing reads only the touched pages and returns an
        # ndarray in RAM: the traffic follows the frontier, not n_nodes
        return np.asarray(self._mmap[idx])

    def close(self) -> None:
        if self._mmap is not None:
            if not self._sealed:
                self._mmap.flush()
            self._mmap = None
        if self._owns_path and self.path and os.path.exists(self.path):
            os.unlink(self.path)
            self._owns_path = False

    def __del__(self):  # best-effort tempfile cleanup
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
