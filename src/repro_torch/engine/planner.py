"""Profile-guided spec planner — what ``Engine("auto")`` resolves through
(port of :mod:`repro.engine.planner`).

An ``"auto"`` spec resolves to a concrete ``format+schedule+topology``
before anything is built, through three tiers:

1. **Persisted autotune winner** — :func:`autotune` times every candidate
   spec's training step on the device (all arms back to back in every
   trial, the median per arm) and persists the winner per
   ``(backend, n_cores, graph-stats bucket)`` to
   ``BENCH_planner_torch.json``.  A matching entry wins outright.  The
   stacked cores are a tensor axis on one device, so the sweep needs no
   child process and no forced devices.
2. **Analytic cost model** — :func:`fit_cost_model` fits nonnegative
   ``t = const + α·steps + β·effective_bytes`` coefficients against the
   per-topology step times of a topology record
   (``BENCH_topology_torch.json``; ``effective_bytes = bytes_per_core /
   link_parallelism``).  :func:`rank_specs` scores every candidate's
   :class:`~repro_torch.topology.base.ExchangePlan` with it, scaling the
   compute-side ``const`` by each format's roofline seconds
   (:func:`_format_roofline_seconds`, counted by
   :func:`repro_torch.launch.roofline.count_work`) when graph stats are
   given.  On one card the "wire" is a copy on the device, so a fit there
   says what exchange rounds and copies cost, not a network.
3. **Static fallback** — :data:`DEFAULT_SPEC` (``ell+pipelined+hypercube``).
   No file, no fit → still a valid spec, with no implicit sweep.

Both stores ride :class:`repro_torch.engine.plans.RecordStore` (explicit
path → ``$REPRO_TORCH_PLANNER_PATH`` / ``$REPRO_TORCH_TOPOLOGY_PATH`` →
default filename in the CWD); corrupt or stale records warn and fall
through to the next tier, never to another device.  The backend key is
``"cpu"`` on the CPU and ``"cuda:" +`` the card's name on the card
(:func:`repro_torch.kernels.tune.backend_key`), so a record measured on
another part never applies.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.tune import backend_key

from .plans import RecordStore
from .registry import supported_specs

#: the static fallback (tier 3) — the paper's format and NoC
DEFAULT_SPEC = "ell+pipelined+hypercube"

#: autotune winners, keyed ``"{backend}|P{n_cores}|{bucket}"``
PLANNER_STORE = RecordStore("BENCH_planner_torch.json",
                            "REPRO_TORCH_PLANNER_PATH")
#: the topology sweep record the cost model fits against
TOPOLOGY_STORE = RecordStore("BENCH_topology_torch.json",
                             "REPRO_TORCH_TOPOLOGY_PATH")


def _pow2(v: float) -> int:
    """Round up to the next power of two (bucket resolution)."""
    n = max(int(-(-v // 1)), 1)              # ceil without math import
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """The workload coordinates a plan is keyed on.

    ``n_dst``/``n_src`` are the deepest sampled layer's destination/source
    row counts (the rows the exchange actually ships), ``avg_deg`` its
    average in-degree, ``feat_dim`` the feature width.  :meth:`bucket`
    rounds each up to a power of two so nearby workloads share one
    autotune record instead of sweeping per batch.
    """

    n_dst: int
    n_src: int
    avg_deg: float
    feat_dim: int

    @classmethod
    def from_layers(cls, layers, feat_dim: int) -> "GraphStats":
        """Stats of the deepest (widest-frontier) COO layer in ``layers``."""
        deepest = max(layers, key=lambda c: c.n_src)
        return cls(n_dst=int(deepest.n_dst), n_src=int(deepest.n_src),
                   avg_deg=float(deepest.nnz) / max(int(deepest.n_dst), 1),
                   feat_dim=int(feat_dim))

    def bucket(self) -> str:
        return (f"n{_pow2(self.n_dst)}_s{_pow2(self.n_src)}"
                f"_d{_pow2(self.avg_deg)}_f{_pow2(self.feat_dim)}")


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Fitted ``t = const + α·steps + β·effective_bytes`` (all ≥ 0).

    Nonnegative coefficients make the prediction monotone by construction:
    more steps or more wire bytes can never predict a faster exchange.
    ``n_rows``/``d``/``base_spec`` record the workload the fit came from so
    :func:`rank_specs` can re-plan candidates at the same coordinates.
    """

    alpha: float                  # seconds per exchange step (latency)
    beta: float                   # seconds per effective wire byte
    const: float                  # exchange-independent step time
    n_cores: int
    backend: Optional[str] = None
    base_spec: str = "ell+pipelined"
    n_rows: int = 512
    d: int = 128
    source: str = "fit"

    def predict(self, plan) -> float:
        """Predicted seconds per train step under ``plan``."""
        eff = plan.bytes_per_core / max(
            getattr(plan, "link_parallelism", 1.0), 1.0)
        return self.const + self.alpha * plan.steps + self.beta * eff


def _nnls(rows: Sequence[Sequence[float]], y: Sequence[float]):
    """Nonnegative least squares via active-set clamping.

    Solve the normalized LS problem, drop the most-negative column, repeat;
    dropped coefficients are exactly zero.  Small (3-column) systems only —
    the clamp is what guarantees the cost model's monotonicity.
    """
    import numpy as np

    A = np.asarray(rows, dtype=float)
    y = np.asarray(y, dtype=float)
    norms = np.linalg.norm(A, axis=0)
    norms[norms == 0] = 1.0
    An = A / norms
    active = list(range(A.shape[1]))
    coef = np.zeros(A.shape[1])
    while active:
        sol, *_ = np.linalg.lstsq(An[:, active], y, rcond=None)
        if (sol >= -1e-12).all():
            for i, c in zip(active, sol):
                coef[i] = max(float(c), 0.0)
            break
        active.pop(int(np.argmin(sol)))
    return coef / norms


def _record_link_parallelism(record: Dict, topo: str) -> float:
    """link_parallelism for ``topo``: the record's own column when present,
    else the registered topology, else 1.0."""
    v = record.get(f"link_parallelism_{topo}")
    if v is not None:
        return float(v)
    from .registry import get_topology
    try:
        return float(get_topology(topo).link_parallelism)
    except ValueError:
        return 1.0


def fit_cost_model(record: Optional[Dict] = None, *,
                   n_cores: Optional[int] = None,
                   backend: Optional[str] = None,
                   path: Optional[str] = None) -> Optional[CostModel]:
    """Fit α/β/const against a topology sweep record.

    ``record=None`` loads the topology store (file →
    ``$REPRO_TORCH_TOPOLOGY_PATH`` → CWD default).  Returns ``None`` —
    never raises — when there is no usable record: missing/corrupt file,
    an ``n_cores`` or ``backend`` mismatch (coefficients are
    per-(backend, core count)), or fewer than 3 measured arms (the fit has
    3 unknowns).
    """
    if record is None:
        record = TOPOLOGY_STORE.load(path, warn_corrupt=True)
    if not isinstance(record, dict):
        return None
    if n_cores is not None and record.get("n_cores") != n_cores:
        return None
    rec_backend = record.get("backend")
    if backend is not None and rec_backend is not None \
            and rec_backend != backend:
        return None
    rows, y = [], []
    for topo in record.get("topologies") or []:
        steps = record.get(f"exchange_steps_{topo}")
        nbytes = record.get(f"exchange_bytes_per_core_{topo}")
        t = record.get(f"s_per_step_{topo}")
        if steps is None or nbytes is None or t is None:
            continue
        eff = float(nbytes) / max(_record_link_parallelism(record, topo),
                                  1.0)
        rows.append([1.0, float(steps), eff])
        y.append(float(t))
    if len(rows) < 3:
        return None
    const, alpha, beta = _nnls(rows, y)
    return CostModel(alpha=float(alpha), beta=float(beta),
                     const=float(const),
                     n_cores=int(record.get("n_cores", n_cores or 0)),
                     backend=rec_backend,
                     base_spec=record.get("base_spec", "ell+pipelined"),
                     n_rows=int(record.get("mid", 512)),
                     d=int(record.get("feat", 128)))


# ---------------------------------------------------------------------------
# Format-side compute estimate: roofline seconds of one single-device layer,
# per (backend, format+schedule, size bucket).
# ---------------------------------------------------------------------------
def roofline_layer_inputs(fmt_spec: str, dims: Tuple[int, int, int, int]):
    """``(fmt, layout, x, w)`` of the roofline estimate: the reference's
    synthetic COO (same draws, in its order) at ``dims`` = ``(n_dst,
    n_src, deg, d)``, its layout in ``fmt_spec``'s format, and zero CPU
    ``x`` ``[n_src, d]`` and ``w`` ``[d, d]``."""
    import numpy as np
    import torch

    from repro_torch.graph.coo import from_edges

    from .config import EngineConfig
    from .registry import get_format

    n_dst, n_src, deg, d = dims
    cfg = EngineConfig.from_spec(fmt_spec)
    fmt = get_format(cfg.format)
    rng = np.random.default_rng(0)
    e = n_dst * deg
    coo = from_edges(rng.integers(0, n_dst, e), rng.integers(0, n_src, e),
                     np.abs(rng.standard_normal(e)).astype(np.float32) + 0.1,
                     n_dst, n_src)
    layout = fmt.build_local(coo, cfg)
    return (fmt, layout, torch.zeros((n_src, d)), torch.zeros((d, d)))


@functools.lru_cache(maxsize=64)
def _format_roofline_seconds(backend: str, fmt_spec: str,
                             dims: Tuple[int, int, int, int]
                             ) -> Optional[float]:
    """``t_compute + t_memory`` of one layer of ``fmt_spec`` at ``dims``,
    counted on the CPU (:func:`~repro_torch.launch.roofline.count_work`:
    the count does not depend on the device) under ``backend``'s card
    peaks, or the H100 SXM's for ``"cpu"``.  ``None`` on any failure — a
    format that will not build here just keeps ratio 1.0."""
    try:
        from repro_torch.launch.roofline import (H100_SXM, card_peaks,
                                                 count_work, roofline_terms)

        fmt, layout, x, w = roofline_layer_inputs(fmt_spec, dims)
        flops, nbytes = count_work(fmt.layer, layout, x, w)
        peaks = H100_SXM if backend == "cpu" \
            else card_peaks(backend.split(":", 1)[-1])
        terms = roofline_terms(flops, nbytes, 0, 1, peaks=peaks)
        return terms["t_compute"] + terms["t_memory"]
    except Exception as e:                    # noqa: BLE001 — estimate only
        warnings.warn(f"no roofline estimate for {fmt_spec!r}: {e}",
                      RuntimeWarning, stacklevel=2)
        return None


def _roofline_dims(stats: GraphStats) -> Tuple[int, int, int, int]:
    # capped: the ratio between formats stabilizes long before real sizes
    return (min(_pow2(stats.n_dst), 512), min(_pow2(stats.n_src), 1024),
            min(_pow2(stats.avg_deg), 16), min(_pow2(stats.feat_dim), 128))


def rank_specs(model: CostModel, n_cores: int, *,
               graph_stats: Optional[GraphStats] = None,
               backend: Optional[str] = None,
               candidates: Optional[Sequence[str]] = None,
               mode: str = "train", max_batch: int = 8,
               device: DeviceLike = None) -> List[Tuple[str, float]]:
    """Candidate three-part specs sorted by predicted seconds.

    The exchange side scores each topology's :class:`ExchangePlan` through
    ``model``; the compute side scales ``model.const`` by the candidate
    format's roofline seconds relative to the fitted base format (only when
    ``graph_stats`` pins a workload — without one every format scores 1.0
    and the ranking is purely the interconnect; the peaks are those of
    ``backend``, else of ``device``'s backend).  Ties prefer
    ``ell+pipelined``, then lexicographic — deterministic, so resumes
    re-rank identically.

    ``mode`` picks the objective: ``"train"`` — per-step seconds at the
    fitted workload's row count; ``"serving"`` — mean predicted latency
    over coalesced micro-batch sizes ``1, 2, 4, … max_batch`` (each
    micro-batch is one user-visible latency, so every size weighs
    equally; the α·steps term dominates and the ranking can invert).
    """
    from .registry import get_topology

    if mode not in ("train", "serving"):
        raise ValueError(f"unknown rank mode {mode!r}; "
                         "expected 'train' or 'serving'")
    specs = list(candidates) if candidates is not None \
        else supported_specs(three_part=True)
    n_rows = graph_stats.n_dst if graph_stats is not None else model.n_rows
    d = graph_stats.feat_dim if graph_stats is not None else model.d
    if mode == "serving":
        batch_sizes = []
        b = 1
        while b < max_batch:
            batch_sizes.append(b)
            b *= 2
        batch_sizes.append(max_batch)
    else:
        batch_sizes = [n_rows]
    base_s = None
    if graph_stats is not None:
        backend = backend or backend_key(device)
        dims = _roofline_dims(graph_stats)
        base_s = _format_roofline_seconds(backend, model.base_spec, dims)
    scored = []
    for spec in specs:
        fmt, sched, topo = spec.split("+")
        try:
            plans = [get_topology(topo).plan(b, d, n_cores,
                                             cost_model=model)
                     for b in batch_sizes]
        except ValueError:            # this topology can't run at n_cores
            continue
        ratio = 1.0
        if base_s:
            s = _format_roofline_seconds(backend, f"{fmt}+{sched}", dims)
            if s:
                ratio = s / base_s
        score = sum(model.const * ratio + model.alpha * plan.steps
                    + model.beta * plan.bytes_per_core
                    / max(plan.link_parallelism, 1.0)
                    for plan in plans) / len(plans)
        scored.append((spec, float(score)))
    scored.sort(key=lambda kv: (kv[1],
                                0 if kv[0].startswith("ell+pipelined")
                                else 1, kv[0]))
    return scored


def rank_partitions(model: CostModel, coo, n_cores: int, *,
                    topology: str = "hypercube", d: Optional[int] = None
                    ) -> List[Tuple[str, float, int]]:
    """Registered partitioners sorted by predicted step seconds on ``coo``.

    For each ``partition`` knob value this relabels the graph
    (``mincom`` → :func:`repro_torch.graph.partition.mincom_assignment`;
    ``naive`` → identity), measures the post-merge wire content with
    :func:`repro_torch.graph.partition.exchange_rows`, plans the exchange
    with ``wire_rows`` and scores it through ``model.predict``.  Returns
    ``[(name, predicted_seconds, bytes_per_core), ...]`` best-first; ties
    prefer ``naive``.
    """
    import numpy as np

    from repro_torch.graph.partition import (PARTITIONS, exchange_rows,
                                             mincom_assignment,
                                             partition_permutation)

    from .registry import get_topology

    rows = np.asarray(coo.rows, np.int64)
    cols = np.asarray(coo.cols, np.int64)
    vals = np.asarray(coo.vals)
    d = int(d) if d is not None else model.d
    topo = get_topology(topology)
    scored = []
    for name in PARTITIONS:
        if name == "mincom" and n_cores > 1 and coo.n_dst == coo.n_src:
            assign = mincom_assignment(rows, cols, coo.n_dst, n_cores)
            perm = partition_permutation(assign, n_cores)
            r, c = perm[rows], perm[cols]
        else:
            r, c = rows, cols
        wr = exchange_rows(r, c, vals, coo.n_dst, coo.n_src, n_cores)
        plan = topo.plan(coo.n_dst, d, n_cores, cost_model=model,
                         wire_rows=wr)
        scored.append((name, float(plan.predicted_seconds),
                       int(plan.bytes_per_core)))
    scored.sort(key=lambda kv: (kv[1], 0 if kv[0] == "naive" else 1, kv[0]))
    return scored


# ---------------------------------------------------------------------------
# Resolution: the three tiers.
# ---------------------------------------------------------------------------
def _entry_key(backend: str, n_cores: int, bucket: str) -> str:
    return f"{backend}|P{n_cores}|{bucket}"


def _valid_concrete_spec(spec, n_cores: int) -> bool:
    from .config import EngineConfig
    from .registry import get_topology
    if not isinstance(spec, str):
        return False
    try:
        cfg = EngineConfig.from_spec(spec)
        if cfg.is_auto:
            return False
        get_topology(cfg.topology).validate_cores(n_cores)
        return True
    except ValueError:
        return False


def _persisted_spec(backend: str, n_cores: int,
                    graph_stats: Optional[GraphStats],
                    path: Optional[str]) -> Optional[str]:
    rec = PLANNER_STORE.load(path, warn_corrupt=True)
    if rec is None:
        return None
    entries = rec.get("entries")
    if not isinstance(entries, dict):
        warnings.warn(
            f"planner record {PLANNER_STORE.path(path)!r} has no 'entries' "
            "table; falling through", RuntimeWarning, stacklevel=3)
        return None
    prefix = _entry_key(backend, n_cores, "")
    keys = []
    if graph_stats is not None:
        keys.append(_entry_key(backend, n_cores, graph_stats.bucket()))
    # deterministic prefix fallback: any bucket measured at this
    # (backend, n_cores) beats the analytic tier, sorted-first on ties
    keys.extend(k for k in sorted(entries) if k.startswith(prefix)
                and k not in keys)
    for key in keys:
        ent = entries.get(key)
        spec = ent.get("spec") if isinstance(ent, dict) else None
        if _valid_concrete_spec(spec, n_cores):
            return spec
        if ent is not None:
            warnings.warn(
                f"planner entry {key!r} names a stale/unregistered spec "
                f"{spec!r}; falling through", RuntimeWarning, stacklevel=3)
    return None


def resolve_spec(*, n_cores: int,
                 graph_stats: Optional[GraphStats] = None,
                 backend: Optional[str] = None,
                 candidates: Optional[Sequence[str]] = None,
                 path: Optional[str] = None, mode: str = "train",
                 max_batch: int = 8, device: DeviceLike = None) -> str:
    """The concrete spec ``"auto"`` stands for at ``n_cores`` on
    ``device`` (``None`` → the card; ``backend`` overrides the key).

    Tier 1: a persisted :func:`autotune` winner for this
    (backend, n_cores, bucket).  Tier 2: the cost model fitted from the
    topology record.  Tier 3: :data:`DEFAULT_SPEC`.  Pure reads — never
    measures, never sweeps — and always returns a registered spec.

    ``mode="serving"`` (the :class:`~repro_torch.serving.InferenceEngine`
    path) skips tier 1 — autotune winners measure training step
    throughput, the wrong objective for micro-batch latency — and ranks
    tier 2 with the latency-weighted objective over batch sizes
    ``1..max_batch`` (:func:`rank_specs`).
    """
    backend = backend or backend_key(device)
    if mode != "serving":
        spec = _persisted_spec(backend, n_cores, graph_stats, path)
        if spec is not None:
            return spec
    model = fit_cost_model(n_cores=n_cores, backend=backend)
    if model is not None:
        ranked = rank_specs(model, n_cores, graph_stats=graph_stats,
                            backend=backend, candidates=candidates,
                            mode=mode, max_batch=max_batch)
        if ranked:
            return ranked[0][0]
    return DEFAULT_SPEC


# ---------------------------------------------------------------------------
# Tier-1 producer: the measured sweep.
# ---------------------------------------------------------------------------
def _round_up(v: int, mult: int) -> int:
    return max(((int(v) + mult - 1) // mult) * mult, mult)


def _autotune_measure(stats_kw: Optional[Dict], n_cores: int,
                      candidates: Sequence[str], n_steps: int,
                      n_trials: int, seed: int,
                      device: DeviceLike = None) -> Dict:
    """Measure every candidate's training step on one shared synthetic
    stream, on ``device`` (``None`` → the card).

    All arms run back to back inside every trial (host load is
    common-mode), the per-arm time is the median across trials, and every
    arm's first-step loss must sit within 1e-5 of the first arm's
    (reduction-order roundoff only).  ``n_cores`` is the stacked core axis
    of one device.
    """
    import numpy as np
    import torch

    from repro_torch.graph.coo import from_edges
    from repro_torch.models import init_params

    from .engine import Engine

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if stats_kw:
        mid = _round_up(stats_kw["n_dst"], n_cores)
        frontier = _round_up(stats_kw["n_src"], n_cores)
        deg = max(int(round(stats_kw["avg_deg"])), 1)
        feat = max(int(stats_kw["feat_dim"]), 8)
    else:
        mid, frontier, deg, feat = 256, 512, 8, 64
    batch = _round_up(mid // 2, n_cores)
    hidden = feat
    rng = np.random.default_rng(seed)

    def layer(n_dst, n_src):
        e = n_dst * deg
        return from_edges(rng.integers(0, n_dst, e),
                          rng.integers(0, n_src, e),
                          np.abs(rng.standard_normal(e))
                          .astype(np.float32) + 0.1, n_dst, n_src)

    class _MB:                        # duck-typed MiniBatch: layers only
        pass

    _MB.layers = [layer(batch, mid), layer(mid, frontier)]
    x = rng.standard_normal((frontier, feat)).astype(np.float32)
    labels = rng.integers(0, 16, batch).astype(np.int32)
    runs, ref_loss, loss_match = {}, None, True
    for spec in candidates:
        bundle = Engine(spec).build(n_cores, device=dev)
        b = bundle.shard_batch(_MB(), x, labels)
        params = init_params(seed, [(feat, hidden), (hidden, 16)],
                             device=dev)
        params, loss = bundle.train_step(params, b)   # loss at init params
        first = float(loss)
        params, loss = bundle.train_step(params, b)   # warm-up
        sync()
        if ref_loss is None:
            ref_loss = first
        elif abs(first - ref_loss) > 1e-5:
            loss_match = False
        runs[spec] = {"step": bundle.train_step, "batch": b,
                      "params": params, "times": []}
    for _ in range(n_trials):
        for arm in runs.values():     # back-to-back: load is common-mode
            sync()
            t0 = time.perf_counter()
            p = arm["params"]
            for _ in range(n_steps):
                p, _loss = arm["step"](p, arm["batch"])
            sync()
            arm["times"].append((time.perf_counter() - t0) / n_steps)
    s = {spec: sorted(arm["times"])[len(arm["times"]) // 2]
         for spec, arm in runs.items()}
    winner = min(sorted(s), key=lambda k: s[k])
    return {"winner": winner, "s_per_step": s, "loss_match": loss_match,
            "stream": {"batch": batch, "mid": mid, "frontier": frontier,
                       "feat": feat, "deg": deg}}


def autotune(graph_stats: Optional[GraphStats] = None, *,
             n_cores: int = 4,
             candidates: Optional[Sequence[str]] = None,
             n_steps: int = 3, n_trials: int = 8, seed: int = 0,
             path: Optional[str] = None, force: bool = False,
             device: DeviceLike = None) -> Dict:
    """Time every candidate spec's training step on ``device`` (``None`` →
    the card; raises without one), persist the winner, return the entry.

    Idempotent per (backend, n_cores, bucket) key unless ``force`` — a
    machine autotunes once per workload bucket; training never re-tunes.
    Entries merge into the existing record so different core counts and
    buckets accumulate in one file.
    """
    dev = resolve_device(device)
    backend = backend_key(dev)
    candidates = list(candidates) if candidates is not None \
        else supported_specs(three_part=True)
    bucket = graph_stats.bucket() if graph_stats is not None else "default"
    key = _entry_key(backend, n_cores, bucket)
    rec = PLANNER_STORE.load(path) or {}
    entries = rec.get("entries")
    if not isinstance(entries, dict):
        entries = {}
    if not force:
        ent = entries.get(key)
        if isinstance(ent, dict) and _valid_concrete_spec(ent.get("spec"),
                                                          n_cores):
            return ent
    stats_kw = dataclasses.asdict(graph_stats) \
        if graph_stats is not None else None
    meas = _autotune_measure(stats_kw, n_cores, candidates, n_steps,
                             n_trials, seed, device=dev)
    entry = {
        "spec": meas["winner"], "backend": backend, "n_cores": n_cores,
        "bucket": bucket, "graph_stats": stats_kw,
        "s_per_step": meas["s_per_step"], "loss_match": meas["loss_match"],
        "stream": meas.get("stream"), "candidates": list(candidates),
        "n_steps": n_steps, "n_trials": n_trials, "seed": seed,
    }
    entries[key] = entry
    PLANNER_STORE.save({"entries": entries}, path)
    return entry
