"""Synthetic graph datasets with the paper's benchmark statistics (port of
:mod:`repro.graph.datasets`).

The generator consumes its numpy stream in exactly the reference's order
(Pareto weights, both endpoint draws, features, labels), so the same seed
gives a byte-identical graph, feature matrix and label vector, whether the
features are dense or written chunk by chunk into a feature store.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .sampler import CSRGraph, csr_from_edges


@dataclasses.dataclass(frozen=True)
class DatasetStats:
    name: str
    n_nodes: int
    n_edges: int      # undirected edge count as usually reported
    feat_dim: int
    n_classes: int
    multilabel: bool = False
    alpha: float = 1.8    # Pareto tail (lower = heavier hubs = more skew)


# Standard statistics (GraphSAINT table 1 / SAGE)
DATASET_STATS: Dict[str, DatasetStats] = {
    "flickr": DatasetStats("flickr", 89_250, 899_756, 500, 7, alpha=1.8),
    "reddit": DatasetStats("reddit", 232_965, 11_606_919, 602, 41,
                           alpha=2.4),
    "yelp": DatasetStats("yelp", 716_847, 6_977_410, 300, 100,
                         multilabel=True, alpha=1.5),
    "amazonproducts": DatasetStats("amazonproducts", 1_598_960, 132_169_734,
                                   200, 107, multilabel=True, alpha=1.35),
}


@dataclasses.dataclass(frozen=True)
class GraphDataset:
    stats: DatasetStats
    graph: CSRGraph               # symmetrized CSR (both directions present)
    #: [n, d] float32: a dense ndarray, or a
    #: repro_torch.featurestore.FeatureStore (the out-of-core path); both
    #: share the shape/dtype/fancy-row-indexing surface consumers rely on
    features: object
    labels: np.ndarray            # [n] int32 or [n, c] float32 (multilabel)
    scale: float


def _chung_lu_edges(n: int, target_edges: int, alpha: float,
                    rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Power-law degree sequence via weighted endpoint sampling."""
    w = rng.pareto(alpha, n) + 1.0
    p = w / w.sum()
    m = target_edges
    src = rng.choice(n, size=m, p=p).astype(np.int64)
    dst = rng.choice(n, size=m, p=p).astype(np.int64)
    keep = src != dst
    return src[keep], dst[keep]


def make_dataset(name: str, scale: float = 1.0, seed: int = 0,
                 feat_dim: Optional[int] = None, features: str = "dense",
                 store_path: Optional[str] = None,
                 chunk_rows: int = 65536) -> GraphDataset:
    """Instantiate a synthetic stand-in for one of the paper's datasets.

    ``scale`` multiplies node and edge counts (density preserved);
    ``feat_dim`` overrides the feature width.

    ``features`` picks where the feature matrix lives: ``"dense"`` (an
    ndarray, the default) or a registered :mod:`repro_torch.featurestore`
    backend — ``"store"`` (alias of ``"host"``), ``"mmap"`` (a
    memory-mapped file at ``store_path``, or a tempfile the store unlinks
    on ``close``), or any name registered since.  A store is written in
    ``chunk_rows``-row chunks through its writer; the generator is consumed
    element by element either way, so its rows, and the labels drawn after
    them, are bit-identical to the dense path at the same seed.
    """
    stats = DATASET_STATS[name]
    rng = np.random.default_rng(seed)
    n = max(int(stats.n_nodes * scale), 64)
    e = max(int(stats.n_edges * scale), 4 * n)
    d = feat_dim if feat_dim is not None else stats.feat_dim
    src, dst = _chung_lu_edges(n, e, alpha=stats.alpha, rng=rng)
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    graph = csr_from_edges(s2, d2, n)
    if features == "dense":
        feats = rng.standard_normal((n, d), dtype=np.float32) * 0.1
    else:
        from repro_torch.featurestore import get_store

        backend = "host" if features == "store" else features
        kwargs = {"path": store_path} if backend == "mmap" else {}
        store = get_store(backend).create(n, d, dtype=np.float32, **kwargs)
        for s in range(0, n, chunk_rows):
            c = min(chunk_rows, n - s)
            store.write_chunk(
                s, rng.standard_normal((c, d), dtype=np.float32) * 0.1)
        feats = store.seal()
    if stats.multilabel:
        labels = (rng.random((n, stats.n_classes)) < 0.05).astype(np.float32)
    else:
        labels = rng.integers(0, stats.n_classes, size=n).astype(np.int32)
    return GraphDataset(stats=stats, graph=graph, features=feats,
                        labels=labels, scale=scale)
