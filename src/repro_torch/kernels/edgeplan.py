"""Pre-reduced ELLPACK edge plans (port of :mod:`repro.kernels.edgeplan`).

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
of the COO's tensors, which the cache pins alive.

Merge levels: ``merge="dedup"`` merges duplicate ``(row, col)`` pairs
within each destination row.  ``merge="redundancy"`` adds the GraphACT
pass (arXiv:2001.02498 §3): :func:`mine_pair_redundancy` mines neighbour
pairs shared across destination rows, matches them greedily into virtual
vertices ``z = α·x[u] + β·x[v]`` and rewrites the tables over the extended
``original ∪ virtual`` source space.  The same kernel walks the rewritten
tables; the only addition is one pre-pass walk over the ``vv`` tables
(degree-2 rows) that computes ``z``, and in the backward one walk over
their mirror ``vv_t`` that expands the virtual cotangents back onto the
original sources (:func:`repro_torch.kernels.ops.ell_apply`).
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

#: the table sets of a plan, by key prefix: forward, transpose, and the
#: redundancy tier's pre-pass and its mirror
WALK_PREFIXES = ("", "t_", "vv_", "vvt_")


def validate_merge(merge: str) -> str:
    if merge not in MERGE_LEVELS:
        raise ValueError(f"unknown merge level {merge!r}; "
                         f"supported: {list(MERGE_LEVELS)}")
    return merge


@dataclasses.dataclass(eq=False)
class PairMerge:
    """Rewritten flat edges + the virtual-vertex tier of one mining pass.

    ``rows``/``cols``/``vals`` are the rewritten edges; ``cols`` index the
    extended source space ``[0, n_cols) ∪ [n_cols, n_cols + n_virtual)``.
    Virtual vertex *z* is ``α·x[vv_src[z, 0]] + β·x[vv_src[z, 1]]`` with
    ``(α, β) = vv_coef[z]``; ``stats`` is the mining's accounting.
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    vv_src: np.ndarray     # [n_virtual, 2] int64, original source ids
    vv_coef: np.ndarray    # [n_virtual, 2] float32
    n_rows: int
    n_cols: int
    stats: Dict

    @property
    def n_virtual(self) -> int:
        return int(self.vv_src.shape[0])

    def vv_flat(self) -> _FLAT:
        """The virtual tier as flat edges (z, src, coef): the degree-2 rows
        of the ``V`` matrix the pre-pass walks (``z = V @ x``)."""
        z = np.repeat(np.arange(self.n_virtual, dtype=np.int64), 2)
        return z, self.vv_src.reshape(-1), self.vv_coef.reshape(-1)


def _dedup_flat(rows, cols, vals, n_cols: int) -> _FLAT:
    """Drop zero-weight padding and merge duplicate (row, col) entries,
    (row, col)-sorted (the within-row merge :func:`build_tables` does)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if len(rows):
        key = rows * (n_cols + 1) + cols
        uniq, inv = np.unique(key, return_inverse=True)
        vals = np.bincount(inv, weights=vals).astype(np.float32)
        rows = uniq // (n_cols + 1)
        cols = uniq % (n_cols + 1)
    return rows, cols, vals


def mine_pair_redundancy(rows, cols, vals, n_rows: int, n_cols: int, *,
                         max_row_degree: int = 128, min_uses: int = 2,
                         ratio_tol: float = 1e-6) -> PairMerge:
    """GraphACT §3: greedy matching over the shared-neighbour pair table.

    A pair ``(u, v)`` appearing in rows ``r1, r2, …`` factors into one
    virtual vertex only where each row's weight pair is proportional to the
    defining (first available) row's within ``ratio_tol`` relative.  Pairs
    are taken in descending frequency, ties by the pair ``(u, v)``; each
    (row, neighbour) entry joins at most one virtual vertex, and a vertex
    needs ``min_uses`` rows.  Rows above ``max_row_degree`` enumerate no
    pairs.  Row *r*'s rewritten weight is ``a_ru / α``, so ``w_r·α`` is
    ``a_ru`` exactly and ``w_r·β`` is ``a_rv`` within ``ratio_tol``.
    """
    rows, cols, vals = _dedup_flat(rows, cols, vals, n_cols)
    edges_before = len(rows)
    stats = {"edges_before": edges_before, "edges_after": edges_before,
             "n_virtual": 0, "pair_uses": 0, "pair_coverage": 0.0,
             "flop_reduction": 1.0}
    empty = PairMerge(rows=rows, cols=cols, vals=vals,
                      vv_src=np.zeros((0, 2), np.int64),
                      vv_coef=np.zeros((0, 2), np.float32),
                      n_rows=n_rows, n_cols=n_cols, stats=stats)
    if edges_before == 0:
        return empty
    deg = np.bincount(rows, minlength=n_rows)
    starts = np.zeros(n_rows + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    # pair-frequency table: (u, v) -> [(edge_idx_u, edge_idx_v), ...]
    occ: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for r in np.flatnonzero((deg >= 2) & (deg <= max_row_degree)):
        lo, hi = int(starts[r]), int(starts[r + 1])
        for i in range(lo, hi):
            for j in range(i + 1, hi):
                occ.setdefault((int(cols[i]), int(cols[j])), []) \
                   .append((i, j))
    order = sorted(occ, key=lambda p: (-len(occ[p]), p))
    used = np.zeros(edges_before, bool)
    vals64 = vals.astype(np.float64)
    vv_src: List[Tuple[int, int]] = []
    vv_coef: List[Tuple[float, float]] = []
    new_rows: List[int] = []
    new_cols: List[int] = []
    new_vals: List[float] = []
    pair_uses = 0
    for pair in order:
        hits = occ[pair]
        if len(hits) < min_uses:
            break                      # sorted by count: nothing below pays
        avail = [(i, j) for i, j in hits if not (used[i] or used[j])]
        while len(avail) >= min_uses:
            i0, j0 = avail[0]
            alpha, beta = vals64[i0], vals64[j0]
            cluster = [(i, j) for i, j in avail
                       if abs(vals64[i] * beta - vals64[j] * alpha)
                       <= ratio_tol * abs(vals64[j] * alpha)]
            if len(cluster) < min_uses:
                avail = avail[1:]      # lone ratio class: try the next
                continue
            z = len(vv_src)
            vv_src.append(pair)
            vv_coef.append((float(alpha), float(beta)))
            for i, j in cluster:
                used[i] = used[j] = True
                new_rows.append(int(rows[i]))
                new_cols.append(n_cols + z)
                new_vals.append(float(vals64[i] / alpha))
            pair_uses += len(cluster)
            avail = [(i, j) for i, j in avail
                     if not (used[i] or used[j])]
    if not vv_src:
        return empty
    keep = ~used
    out_rows = np.concatenate([rows[keep], np.asarray(new_rows, np.int64)])
    out_cols = np.concatenate([cols[keep], np.asarray(new_cols, np.int64)])
    out_vals = np.concatenate([vals[keep],
                               np.asarray(new_vals, np.float32)])
    n_virtual = len(vv_src)
    edges_after = len(out_rows)
    stats = {
        "edges_before": edges_before,
        "edges_after": edges_after,
        "n_virtual": n_virtual,
        "pair_uses": pair_uses,
        # fraction of (deduped) edges absorbed into virtual gathers
        "pair_coverage": 2.0 * pair_uses / edges_before,
        # aggregation MACs before vs after, pre-pass included (2 per vv)
        "flop_reduction": edges_before / max(edges_after + 2 * n_virtual,
                                             1),
    }
    return PairMerge(rows=out_rows, cols=out_cols, vals=out_vals,
                     vv_src=np.asarray(vv_src, np.int64).reshape(-1, 2),
                     vv_coef=np.asarray(vv_coef,
                                        np.float32).reshape(-1, 2),
                     n_rows=n_rows, n_cols=n_cols, stats=stats)


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

    Under ``merge="redundancy"`` both cover the extended source space
    (original ∪ virtual): ``vv`` holds the pre-pass tables (``z = V @ x``),
    ``vv_t`` their column-major mirror (``dx += Vᵀ g``), ``merge_stats``
    the mining's accounting.
    """

    n_dst: int
    n_src: int
    nnz: int
    fwd: EllTables
    bwd: EllTables
    vv: Optional[EllTables] = None
    vv_t: Optional[EllTables] = None
    merge_stats: Dict = dataclasses.field(default_factory=dict)
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

    @property
    def n_virtual(self) -> int:
        return int(self.vv.n_rows) if self.vv is not None else 0

    @property
    def pair_coverage(self) -> float:
        return float(self.merge_stats.get("pair_coverage", 0.0))

    @property
    def flop_reduction(self) -> float:
        return float(self.merge_stats.get("flop_reduction", 1.0))

    def device_tables(self, device) -> Dict:
        """Tensor copies of both directions on ``device``, converted once per
        device and cached on the plan: keys ``cols``/``vals``/``inv``
        (forward) and ``t_cols``/``t_vals``/``t_inv`` (transpose), and each
        direction's one-launch walk descriptor, ``walk`` / ``t_walk``
        (:func:`repro_torch.kernels.spmm.ell_walk`); a redundancy-merged
        plan adds the ``vv_*`` and ``vvt_*`` pre-pass tables and their
        ``vv_walk`` / ``vvt_walk``."""
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
            if self.vv is not None:
                for prefix, tab in (("vv_", self.vv), ("vvt_", self.vv_t)):
                    tables[prefix + "cols"] = tuple(put(c) for c in tab.cols)
                    tables[prefix + "vals"] = tuple(put(v) for v in tab.vals)
                    tables[prefix + "inv"] = put(
                        tab.inv_perm.astype(np.int64))
            for prefix in WALK_PREFIXES:
                if prefix + "cols" in tables:
                    tables[prefix + "walk"] = ell_walk(
                        tables[prefix + "cols"], tables[prefix + "vals"])
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


def cache_clear() -> None:
    """Drop every cached plan (the counters keep counting)."""
    with _cache_lock:
        _cache.clear()


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
    (:func:`repro_torch.kernels.tune.get_config`).  ``merge="redundancy"``
    mines virtual vertices first and builds both directions over the
    extended source space plus the ``vv`` / ``vv_t`` pre-pass tables; with
    no minable pair the plan is the ``dedup`` plan.
    """
    validate_merge(merge)
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
        if merge == "redundancy":
            mine = mine_pair_redundancy(rows, cols, vals, coo.n_dst,
                                        coo.n_src)
            if mine.n_virtual:
                ext = coo.n_src + mine.n_virtual
                zr, zc, zv = mine.vv_flat()
                return EdgePlan(
                    n_dst=int(coo.n_dst), n_src=int(coo.n_src), nnz=nnz,
                    fwd=build_tables(mine.rows, mine.cols, mine.vals,
                                     coo.n_dst, ext, caps=caps),
                    bwd=build_tables(mine.cols, mine.rows, mine.vals,
                                     ext, coo.n_dst, caps=caps),
                    vv=build_tables(zr, zc, zv, mine.n_virtual, coo.n_src,
                                    caps=caps),
                    vv_t=build_tables(zc, zr, zv, coo.n_src, mine.n_virtual,
                                      caps=caps),
                    merge_stats=dict(mine.stats))
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
