"""InferenceEngine — online GCN queries on a ported Engine spec (port of
:mod:`repro.serving.engine`).

One engine owns a trained weight stack (passed in, or restored from a
checkpoint directory in the reference's on-disk layout), a mutable
:class:`~repro_torch.serving.graph.DynamicGraph`, an ``[n, d]`` feature
array, and a versioned
:class:`~repro_torch.serving.cache.EmbeddingCache` of hop-``l`` embeddings.

``query(nodes)`` runs the L-layer GCN top-down: at each layer the needed
vertices split into cache-valid rows (reused verbatim) and uncached rows
(recursed); the uncached rows' rectangular COO is built in **canonical
form** — rows sorted, each row's columns sorted, row-mean weights, every
dimension padded to a power-of-two bucket — and run through
``Engine.layer`` on the engine's device.  A row's output is a row-local
reduction over its own edges in every format, and the
combination runs through the fixed-K-order ``gemm`` kernel, so the
incremental path is bit-equal to a cold recompute on the card as on the
CPU.  Embeddings come back to the host once per layer (the cache holds
host rows) and each layer's input goes to the device in one copy.

``update_edges`` / ``update_features`` mutate the graph or features and run
the invalidation frontier walk, exactly as the reference does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import Engine, EngineConfig
from repro_torch.graph import COO, CSRGraph, from_edges

from .cache import EmbeddingCache
from .graph import DynamicGraph


def load_checkpoint_params(ckpt_dir: str) -> List[Dict[str, np.ndarray]]:
    """Restore the newest checkpoint's GCN weight stack as
    ``[{"w": ndarray}, ...]`` through
    :class:`~repro_torch.checkpoint.CheckpointManager` (the reference's
    layout): its leaves are keyed ``"<layer>/<name>"`` (``"0/w"``, …)."""
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for key, arr in mgr.read(step)[0].items():
        idx, _, name = key.partition("/")
        layers.setdefault(int(idx), {})[name] = arr
    return [layers[i] for i in sorted(layers)]


def params_from_reference(params: Sequence[Dict], device: DeviceLike = None
                          ) -> List[Dict[str, torch.Tensor]]:
    """The reference's weight stack ``[{"w": ndarray}, ...]`` as the port's
    ``[{"w": float32 tensor on device}, ...]`` (``None`` → the card).
    Leaves may already be tensors; they are copied, never aliased."""
    dev = resolve_device(device)

    def put(v) -> torch.Tensor:
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v, np.float32))
        return v.to(device=dev, dtype=torch.float32, copy=True)

    return [{k: put(v) for k, v in p.items()} for p in params]


def _bucket(n: int, multiple: int) -> int:
    """Pad ``n`` up to a power-of-two bucket (≥ ``multiple``)."""
    n = max(int(n), 1)
    b = 1 << (n - 1).bit_length()
    return max(b, multiple)


class InferenceEngine:
    """Online GCN inference over a trained weight stack + mutable graph.

    Parameters
    ----------
    engine: spec string (``"ell+pipelined"``, ``"block+pipelined"``,
        ``"coo+serial"``),
        :class:`EngineConfig` or :class:`Engine`.
    graph: :class:`~repro_torch.graph.CSRGraph` or
        :class:`~repro_torch.serving.graph.DynamicGraph`.
    features: ``[n, d]`` float32 array (the feature stores come later).
    params: the weight stack (``[{"w": ...}, ...]``, arrays or tensors), or
        ``None`` with ``ckpt_dir`` to restore the newest checkpoint.
    device: where the layers run (``None`` → the card; raises without one).
    cache_capacity: embedding-cache rows (0 disables incremental reuse).
    pad_multiple: minimum shape bucket for the per-query COO padding.
    """

    def __init__(self, engine: Union[str, EngineConfig, Engine],
                 graph: Union[CSRGraph, DynamicGraph], features, *,
                 params: Optional[List[Dict]] = None,
                 ckpt_dir: Optional[str] = None,
                 device: DeviceLike = None,
                 cache_capacity: int = 4096, pad_multiple: int = 8):
        self.device = resolve_device(device)
        if not isinstance(engine, Engine):
            engine = Engine(engine)
        self.engine = engine
        self.spec = engine.spec
        self.graph = graph if isinstance(graph, DynamicGraph) \
            else DynamicGraph(graph)
        if params is None:
            if ckpt_dir is None:
                raise ValueError("pass params or ckpt_dir")
            params = load_checkpoint_params(ckpt_dir)
        self.params = params_from_reference(params, self.device)
        self.weights = [p["w"] for p in self.params]
        self.n_layers = len(self.weights)
        self.feat_dim = int(self.weights[0].shape[0])
        self.n_classes = int(self.weights[-1].shape[1])
        self.features = np.asarray(features, np.float32)
        self._overlay: Dict[int, np.ndarray] = {}
        # as in the reference, the block format serves cold recomputes
        # only: its incremental reuse is switched off, never almost-right
        self.incremental_supported = (engine.config.format != "block"
                                      and cache_capacity > 0
                                      and self.n_layers > 1)
        self.cache = EmbeddingCache(max(cache_capacity, 1))
        self.pad_multiple = int(pad_multiple)
        self.queries = 0
        self.rows_computed = 0
        self.rows_from_cache = 0
        self.feature_updates = 0
        self.edge_updates = 0

    # -- feature plane --------------------------------------------------------
    def _gather_features(self, nodes: np.ndarray) -> np.ndarray:
        """Layer-0 rows: overlay (serving-time updates) over the features."""
        rows = self.features[nodes]
        if self._overlay:
            for i, v in enumerate(nodes):
                ov = self._overlay.get(int(v))
                if ov is not None:
                    rows[i] = ov
        return rows

    # -- the layered recursion ------------------------------------------------
    def _embed(self, layer: int, nodes: np.ndarray,
               use_cache: bool) -> np.ndarray:
        """Embeddings of sorted-unique ``nodes`` after ``layer`` GCN
        layers (``layer=0`` → raw features)."""
        if layer == 0:
            return self._gather_features(nodes)
        d_out = int(self.weights[layer - 1].shape[1])
        out = np.empty((len(nodes), d_out), np.float32)
        todo: List[int] = []
        cacheable = use_cache and layer < self.n_layers
        if cacheable:
            for i, v in enumerate(nodes):
                row = self.cache.get(layer, int(v))
                if row is None:
                    todo.append(i)
                else:
                    out[i] = row
            self.rows_from_cache += len(nodes) - len(todo)
        else:
            todo = list(range(len(nodes)))
        if todo:
            tnodes = nodes[todo]          # sorted: todo is ascending
            fresh = self._compute_rows(layer, tnodes, use_cache)
            out[todo] = fresh
            self.rows_computed += len(todo)
            if cacheable:
                for v, row in zip(tnodes, fresh):
                    self.cache.put(layer, int(v), row)
        return out

    def canonical_layer(self, tnodes: np.ndarray) -> Tuple[COO, np.ndarray]:
        """The canonical rectangular COO of one layer over rows ``tnodes``
        (sorted) and its column space ``frontier`` (their joint in-neighbour
        sets, sorted).  Rows, columns and the edge count are padded to
        power-of-two buckets sized on ``len + 1``, so the last row and
        column are never real; pad edges carry weight 0 and live there."""
        agg = [self.graph.agg_set(int(v)) for v in tnodes]
        frontier = np.unique(np.concatenate(agg)) if agg \
            else np.empty(0, np.int64)
        n_dst = _bucket(len(tnodes) + 1, self.pad_multiple)
        n_src = _bucket(len(frontier) + 1, self.pad_multiple)
        nnz = sum(len(a) for a in agg)
        nnz_pad = _bucket(nnz, self.pad_multiple)
        rows = np.full(nnz_pad, n_dst - 1, np.int64)
        cols = np.full(nnz_pad, n_src - 1, np.int64)
        vals = np.zeros(nnz_pad, np.float32)
        k = 0
        for r, a in enumerate(agg):
            m = len(a)
            rows[k:k + m] = r
            cols[k:k + m] = np.searchsorted(frontier, a)
            vals[k:k + m] = 1.0 / m
            k += m
        return from_edges(rows, cols, vals, n_dst, n_src), frontier

    def _compute_rows(self, layer: int, tnodes: np.ndarray,
                      use_cache: bool) -> np.ndarray:
        """One canonical layer over ``tnodes``: recurse for the frontier's
        inputs, run the layer on the device, bring the real rows back."""
        coo, frontier = self.canonical_layer(tnodes)
        h_in = self._embed(layer - 1, frontier, use_cache)
        x = np.zeros((coo.n_src, h_in.shape[1]), np.float32)
        x[:len(frontier)] = h_in
        y = self.engine.layer(coo, torch.from_numpy(x).to(self.device),
                              self.weights[layer - 1],
                              activate=layer < self.n_layers,
                              device=self.device)
        return y[:len(tnodes)].cpu().numpy()

    # -- queries --------------------------------------------------------------
    def query(self, nodes: Sequence[int], *, use_cache: bool = True
              ) -> np.ndarray:
        """Logits ``[len(nodes), n_classes]`` in the given order
        (duplicates share one computed row).  ``use_cache=False`` is the
        cold full recompute, bit-equal to the incremental path."""
        nodes = np.asarray(nodes, np.int64)
        self.queries += 1
        uniq, inv = np.unique(nodes, return_inverse=True)
        logits = self._embed(self.n_layers, uniq,
                             use_cache and self.incremental_supported)
        return logits[inv]

    # -- updates + the invalidation frontier walk -----------------------------
    def _invalidate_from(self, level1: Set[int]) -> None:
        """Drop ``(l, v)`` for every ``v`` in frontier level ``l`` (level 1
        = the directly dirtied rows, each deeper level one out-ring)."""
        frontier = level1
        for layer in range(1, self.n_layers):
            self.cache.invalidate(layer, frontier)
            if layer + 1 < self.n_layers:
                frontier = self.graph.expand_out(frontier)
        self.cache.bump_version()

    def update_edges(self, add: Sequence = (), remove: Sequence = ()
                     ) -> Dict[str, int]:
        """Apply edge additions/removals; invalidate the affected frontier
        (level 1 is exactly the dirty dst set)."""
        dirty = self.graph.update_edges(add=add, remove=remove)
        self.edge_updates += 1
        if dirty:
            self._invalidate_from(dirty)
        return {"dirty_rows": len(dirty),
                "cache_version": self.cache.version}

    def update_features(self, nodes: Sequence[int], rows) -> Dict[str, int]:
        """Overwrite feature rows; level 1 is ``{u} ∪ out(u)``."""
        nodes = np.asarray(nodes, np.int64)
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None]
        if rows.shape != (len(nodes), self.feat_dim):
            raise ValueError(f"rows shape {rows.shape} != "
                             f"({len(nodes)}, {self.feat_dim})")
        for v, row in zip(nodes, rows):
            self._overlay[int(v)] = row.copy()
        self.feature_updates += 1
        self._invalidate_from(self.graph.expand_out(nodes))
        return {"dirty_rows": len(nodes),
                "cache_version": self.cache.version}

    # -- observability --------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return {"spec": self.spec, "n_layers": self.n_layers,
                "device": str(self.device),
                "queries": self.queries,
                "rows_computed": self.rows_computed,
                "rows_from_cache": self.rows_from_cache,
                "feature_updates": self.feature_updates,
                "edge_updates": self.edge_updates,
                "overlay_rows": len(self._overlay),
                "incremental_supported": self.incremental_supported,
                "cache": self.cache.stats()}
