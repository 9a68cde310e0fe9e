"""Synthetic open-loop load — Poisson arrivals, zipf vertex popularity
(port of :mod:`repro.serving.loadgen`; numpy, unchanged).

Open-loop means arrival times are fixed up front and never slow down when
the service lags (the load generator models independent users, not a
closed feedback loop) — queueing delay therefore shows up in the measured
latency exactly as it would in production.  Vertex popularity is zipf: a
few hub vertices absorb most queries, which is what makes both the
coalescer (concurrent duplicates) and the embedding cache (repeat
neighborhoods) earn their keep.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    t: float        # seconds from trace start
    node: int


def poisson_trace(rate: float, duration: float, n_nodes: int, *,
                  zipf_a: float = 1.3, seed: int = 0) -> List[Arrival]:
    """Poisson arrivals at ``rate``/s for ``duration`` s over ``n_nodes``
    vertices with zipf(``zipf_a``) popularity.

    The popularity ranking is a seeded permutation of the vertex ids, so
    "hot" vertices are spread over the graph rather than clustered at low
    ids (low ids are also the high-degree ids in the synthetic datasets —
    without the shuffle the trace would accidentally align with the
    feature store's pinned set and overstate cache wins).
    """
    if rate <= 0 or duration <= 0:
        raise ValueError(f"rate={rate} and duration={duration} must be > 0")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=max(int(rate * duration * 2),
                                                16))
    times = np.cumsum(gaps)
    times = times[times < duration]
    ranks = np.minimum(rng.zipf(zipf_a, size=len(times)) - 1, n_nodes - 1)
    perm = rng.permutation(n_nodes)
    return [Arrival(t=float(t), node=int(perm[r]))
            for t, r in zip(times, ranks)]


def percentile(xs: Sequence[float], q: float) -> float:
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), q))


def summarize(latencies_s: Sequence[float], slo_s: float,
              wall_s: float) -> Dict[str, float]:
    """Latency tail + throughput-at-SLO for one open-loop run.

    ``throughput_at_slo`` counts only requests answered within the SLO,
    over the full wall clock — a service that answers fast but drops the
    tail, or answers everything late, both score low.
    """
    lat = np.asarray(latencies_s, np.float64)
    within = int((lat <= slo_s).sum()) if len(lat) else 0
    return {
        "completed": int(len(lat)),
        "p50_ms": percentile(lat, 50) * 1e3,
        "p99_ms": percentile(lat, 99) * 1e3,
        "mean_ms": float(lat.mean() * 1e3) if len(lat) else float("nan"),
        "within_slo": within,
        "slo_ms": slo_s * 1e3,
        "wall_s": float(wall_s),
        "throughput_at_slo": within / max(wall_s, 1e-9),
    }
