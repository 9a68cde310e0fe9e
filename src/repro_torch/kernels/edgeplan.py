"""Pre-reduced ELLPACK edge plans (port of :mod:`repro.kernels.edgeplan`,
``merge="dedup"``).

The host-side numpy construction is the reference's, array for array:

  * per aggregate slot *r*, a row of up to ``K`` ``(source, weight)`` pairs —
    ``y[r] = Σ_k vals[r, k] · x[cols[r, k]]`` is a gather plus a reduction
    over the degree axis, never a scatter;
  * rows are **degree-bucketed** by the smallest capacity in ``caps`` that
    fits their duplicate-merged degree;
  * padding entries point at column ``n_cols`` (the reference's dedicated
    zero row; the CUDA kernel skips such entries instead of reading a row);
  * rows with no edges are not stored — ``inv_perm`` routes them to a zero
    output row;
  * the **transpose plan** is the same construction on the column-major
    walk of the same edges (the backward of the training slice walks it
    with the same kernel).

Plans are built once per graph and cached in an LRU keyed on the identity
of the COO's tensors, which the cache pins alive.  ``merge="redundancy"``
(the GraphACT virtual-vertex tier) is ported with the training slice.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Caps = Union[str, Sequence[int]]   # "pow2" | "single" | explicit capacities

_FLAT = Tuple[np.ndarray, np.ndarray, np.ndarray]   # (rows, cols, vals)

MERGE_LEVELS = ("dedup", "redundancy")


def validate_merge(merge: str) -> str:
    if merge not in MERGE_LEVELS:
        raise ValueError(f"unknown merge level {merge!r}; "
                         f"supported: {list(MERGE_LEVELS)}")
    return merge


def flat_from_compressed(bm, row_offset: int = 0, col_offset: int = 0
                         ) -> _FLAT:
    """One Block Message → flat (rows, cols, vals) in pre-reduction order;
    the offsets lift block-local ids into a larger row/column space (the
    distributed builder's global partial-row space)."""
    rows = bm.agg_slots[bm.seg_ids].astype(np.int64) + row_offset
    cols = bm.nbr_slots.astype(np.int64) + col_offset
    return rows, cols, bm.weights.astype(np.float32)


def resolve_caps(caps: Caps, max_deg: int) -> Tuple[int, ...]:
    """Bucket capacities (ascending), last one ≥ ``max_deg``.

    ``"pow2"``: 1, 2, 4, … up to the next power of two ≥ max_deg.
    ``"single"``: one bucket of exactly max_deg (classic ELLPACK).
    """
    max_deg = max(int(max_deg), 1)
    if caps == "single":
        return (max_deg,)
    if caps == "pow2":
        out = [1]
        while out[-1] < max_deg:
            out.append(out[-1] * 2)
        return tuple(out)
    caps = tuple(sorted(int(c) for c in caps))
    if not caps or any(c < 1 for c in caps):
        raise ValueError(f"invalid bucket capacities {caps!r}")
    if caps[-1] < max_deg:
        caps = caps + (max_deg,)
    return caps


def merged_degrees(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   n_rows: int, n_cols: int) -> np.ndarray:
    """Per-row entry counts AFTER duplicate-(row, col) merging."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    keep = np.asarray(vals, np.float32) != 0
    key = rows[keep] * (n_cols + 1) + cols[keep]
    uniq = np.unique(key)
    return np.bincount(uniq // (n_cols + 1), minlength=n_rows)


@dataclasses.dataclass(eq=False)
class EllTables:
    """One direction (forward or transpose) of a plan, bucketed.

    ``cols[b]``: [nb_b, caps[b]] int32 — source ids, padding = ``n_cols``.
    ``vals[b]``: [nb_b, caps[b]] float32 — merged weights, padding = 0.
    ``inv_perm``: [n_rows] int32 — output row *r* is row ``inv_perm[r]`` of
    ``concat(bucket outputs) + [zero row]``.
    """

    caps: Tuple[int, ...]
    cols: Tuple[np.ndarray, ...]
    vals: Tuple[np.ndarray, ...]
    inv_perm: np.ndarray
    n_rows: int
    n_cols: int

    @property
    def n_entries(self) -> int:
        """Real (merged) entries stored across buckets."""
        return int(sum(int((v != 0).sum()) for v in self.vals))

    @property
    def padded_entries(self) -> int:
        return int(sum(int(c.size) for c in self.cols))


def build_tables(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n_rows: int, n_cols: int, caps: Caps = "pow2",
                 nb_pad: Optional[Sequence[int]] = None) -> EllTables:
    """Flat edges → degree-bucketed ELL tables (one direction).

    Duplicate ``(row, col)`` pairs are merged by summing weights (the
    sender-side pre-reduction).  ``nb_pad`` forces per-bucket row counts
    (the distributed builder gives every sender identical shapes with it;
    pad rows hold only padding entries); ``caps`` may be a scheme name or
    the explicit capacities.
    """
    rows = np.asarray(rows, np.int64)
    cols64 = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    keep = vals != 0                      # drop padding edges outright
    rows, cols64, vals = rows[keep], cols64[keep], vals[keep]
    if len(rows):
        key = rows * (n_cols + 1) + cols64
        uniq, inv = np.unique(key, return_inverse=True)
        vals = np.bincount(inv, weights=vals).astype(np.float32)
        rows = uniq // (n_cols + 1)
        cols64 = uniq % (n_cols + 1)
    deg = np.bincount(rows, minlength=n_rows).astype(np.int64)
    caps_t = resolve_caps(caps, int(deg.max()) if len(rows) else 0)
    caps_arr = np.asarray(caps_t, np.int64)
    listed = np.flatnonzero(deg > 0)
    bucket_of = np.searchsorted(caps_arr, deg[listed], side="left")
    n_buckets = len(caps_t)
    if nb_pad is not None and len(nb_pad) != n_buckets:
        raise ValueError(f"nb_pad has {len(nb_pad)} buckets, caps {n_buckets}")
    starts = np.zeros(n_rows + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(len(rows), dtype=np.int64) - starts[rows]

    out_cols: List[np.ndarray] = []
    out_vals: List[np.ndarray] = []
    inv_perm = np.empty(n_rows, np.int64)
    base = 0
    rank_of = np.zeros(n_rows, np.int64)
    bucket_base = np.zeros(n_rows, np.int64)
    for b in range(n_buckets):
        rb = listed[bucket_of == b]
        nb = len(rb)
        nb_out = nb
        if nb_pad is not None:
            if nb > int(nb_pad[b]):
                raise ValueError(f"bucket {b} has {nb} rows > "
                                 f"nb_pad={nb_pad[b]}")
            nb_out = int(nb_pad[b])
        K = int(caps_t[b])
        c = np.full((nb_out, K), n_cols, np.int32)   # pad → zero row
        v = np.zeros((nb_out, K), np.float32)
        rank_of[rb] = np.arange(nb)
        bucket_base[rb] = base
        out_cols.append(c)
        out_vals.append(v)
        base += nb_out
    if len(rows):
        row_bucket = np.zeros(n_rows, np.int64)
        row_bucket[listed] = bucket_of
        ebucket = row_bucket[rows]
        for b in range(n_buckets):
            sel = ebucket == b
            if not sel.any():
                continue
            out_cols[b][rank_of[rows[sel]], slot[sel]] = cols64[sel]
            out_vals[b][rank_of[rows[sel]], slot[sel]] = vals[sel]
    inv_perm[:] = base                        # default: the zero output row
    inv_perm[listed] = bucket_base[listed] + rank_of[listed]
    return EllTables(caps=caps_t, cols=tuple(out_cols), vals=tuple(out_vals),
                     inv_perm=inv_perm.astype(np.int32), n_rows=n_rows,
                     n_cols=n_cols)


@dataclasses.dataclass(eq=False)
class EdgePlan:
    """Both walks of one graph, pre-reduced and bucketed.

    ``fwd``: dst-major tables (``y[r] = Σ v·x[c]``, r ∈ [0, n_dst)).
    ``bwd``: the transpose walk's tables over the SAME edges, column-major
    (``dx[c] = Σ v·e[r]``).
    """

    n_dst: int
    n_src: int
    nnz: int
    fwd: EllTables
    bwd: EllTables
    _device: Dict[str, Dict] = dataclasses.field(default_factory=dict,
                                                 repr=False)

    @property
    def compression(self) -> float:
        """Raw edges per stored (merged) forward entry."""
        return self.nnz / max(self.fwd.n_entries, 1)

    @property
    def padding_overhead(self) -> float:
        """Padded ELL slots per stored entry."""
        return self.fwd.padded_entries / max(self.fwd.n_entries, 1)

    def device_tables(self, device) -> Dict:
        """Tensor copies of both directions on ``device``, converted once per
        device and cached on the plan: keys ``cols``/``vals``/``inv``
        (forward) and ``t_cols``/``t_vals``/``t_inv`` (transpose), and each
        direction's one-launch walk descriptor, ``walk`` / ``t_walk``
        (:func:`repro_torch.kernels.spmm.ell_walk`)."""
        from .spmm import ell_walk

        device = torch.device(device)
        key = str(device)
        tables = self._device.get(key)
        if tables is None:
            def put(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(a).to(device)

            tables = {
                "cols": tuple(put(c) for c in self.fwd.cols),
                "vals": tuple(put(v) for v in self.fwd.vals),
                "inv": put(self.fwd.inv_perm.astype(np.int64)),
                "t_cols": tuple(put(c) for c in self.bwd.cols),
                "t_vals": tuple(put(v) for v in self.bwd.vals),
                "t_inv": put(self.bwd.inv_perm.astype(np.int64)),
            }
            tables["walk"] = ell_walk(tables["cols"], tables["vals"])
            tables["t_walk"] = ell_walk(tables["t_cols"], tables["t_vals"])
            self._device[key] = tables
        return tables


# Bounded plan cache.  Keys hold the id() of the source tensors; the cached
# entry keeps a strong reference to those tensors so an id can never be
# recycled while its key is alive.  Re-entrant lock: builders may nest
# cached() calls.
_CACHE_CAP = 32
_cache: "OrderedDict[tuple, Tuple[tuple, object]]" = OrderedDict()
_stats = {"hits": 0, "misses": 0}
_cache_lock = threading.RLock()


def cached(key: tuple, pins: tuple, builder: Callable[[], object]):
    """Memoize ``builder()`` under ``key``; ``pins`` are objects whose ids
    appear in the key (kept alive alongside the value)."""
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            _stats["hits"] += 1
            _cache.move_to_end(key)
            return hit[1]
        _stats["misses"] += 1
        value = builder()
        _cache[key] = (pins, value)
        if len(_cache) > _CACHE_CAP:
            _cache.popitem(last=False)
        return value


def cache_stats() -> Dict[str, int]:
    """Hit/miss counters since process start."""
    return dict(_stats)


def coo_key(coo, *extra) -> tuple:
    """Identity key of a COO's tensors (plus builder parameters)."""
    return (id(coo.rows), id(coo.cols), id(coo.vals),
            int(coo.n_dst), int(coo.n_src)) + tuple(extra)


def build_plan(coo, caps: Optional[Caps] = None,
               merge: str = "dedup") -> EdgePlan:
    """COO → cached :class:`EdgePlan` (dst-major fwd + column-major bwd).

    The merge order comes from
    :func:`repro_torch.core.blockmsg.compress_block` over the whole matrix
    as one block.  ``caps=None`` takes the default bucket scheme
    (:func:`repro_torch.kernels.tune.get_config`).
    """
    validate_merge(merge)
    if merge == "redundancy":
        raise NotImplementedError(
            "merge='redundancy' (the virtual-vertex pre-pass) is ported with "
            "the training slice (ROADMAP, port Queue 1); use merge='dedup'")
    if caps is None:
        from .tune import get_config
        caps = get_config()["caps"]
    caps_key = caps if isinstance(caps, str) else tuple(caps)

    def _build() -> EdgePlan:
        from repro_torch.core.blockmsg import compress_block
        rows = np.asarray(coo.rows)
        cols = np.asarray(coo.cols)
        vals = np.asarray(coo.vals, np.float32)
        keep = vals != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        nnz = int(keep.sum())
        bm_f = compress_block(rows, cols, vals, 0, 0)
        bm_b = compress_block(cols, rows, vals, 0, 0)
        fwd = build_tables(*flat_from_compressed(bm_f), coo.n_dst, coo.n_src,
                           caps=caps)
        bwd = build_tables(*flat_from_compressed(bm_b), coo.n_src, coo.n_dst,
                           caps=caps)
        return EdgePlan(n_dst=int(coo.n_dst), n_src=int(coo.n_src),
                        nnz=nnz, fwd=fwd, bwd=bwd)

    return cached(coo_key(coo, "plan", caps_key, merge),
                  (coo.rows, coo.cols, coo.vals), _build)
