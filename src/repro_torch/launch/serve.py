"""GCN serving CLI over :mod:`repro_torch.serving` (port of
:mod:`repro.launch.serve`).

Trains (or restores) a checkpoint, builds an
:class:`~repro_torch.serving.InferenceEngine` on it, and drives the
:class:`~repro_torch.serving.InferenceService` under synthetic open-loop
traffic, printing p50/p99 latency, throughput-at-SLO, the coalesce factor
and the cache hit rate.  ``--feature-cache-capacity N`` serves the features
from a ``host`` feature store behind an ``N``-row degree-keyed
:class:`~repro_torch.featurestore.HotVertexCache` (the cache is bit-exact,
so the logits do not change).  It runs on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke [--device cpu]

``--smoke`` asserts the serving contract: logits after a mixed stream of
queries and graph/feature updates equal a cold full recompute, and the
open-loop p99 stays under ``--p99-budget-ms``; it exits 1 on either
failure.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np


def _train_checkpoint(args, ckpt_dir: str):
    """Train a few steps on ``--n-cores`` stacked cores and checkpoint it:
    the serving engine then loads what a deployment would, a checkpoint
    directory, not in-process weights."""
    from repro_torch.launch.trainer import Trainer

    trainer = Trainer(args.train_spec, "flickr", n_cores=args.n_cores,
                      scale=args.scale, feat_dim=args.feat_dim,
                      hidden=args.hidden, batch_size=args.batch_size,
                      pad_multiple=max(64, args.n_cores),
                      ckpt_dir=ckpt_dir, log_every=0, seed=args.seed,
                      device=args.device)
    trainer.train_steps(args.train_steps)
    trainer.save(sync=True)
    dataset = trainer.dataset
    trainer.close()
    return dataset


def build_engine(args, ckpt_dir: str, dataset=None):
    """The engine over ``dataset`` (or a fresh flickr stand-in); with
    ``--feature-cache-capacity`` its features are a ``host`` store, which
    the engine wraps in a hot-vertex cache.  Returns (engine, dataset)."""
    from repro_torch.graph import make_dataset
    from repro_torch.serving import InferenceEngine

    if dataset is None:
        dataset = make_dataset("flickr", scale=args.scale,
                               feat_dim=args.feat_dim)
    features = dataset.features
    if args.feature_cache_capacity > 0 and not hasattr(features, "gather"):
        from repro_torch.featurestore import HostStore
        features = HostStore.from_array(features)
    return InferenceEngine(
        args.spec, dataset.graph, features, ckpt_dir=ckpt_dir,
        cache_capacity=args.cache_capacity,
        feature_cache_capacity=args.feature_cache_capacity,
        max_batch=args.max_batch, device=args.device), dataset


def mixed_stream_bit_match(engine, n_rounds: int, seed: int) -> bool:
    """Interleave queries with edge/feature updates; every query's
    incremental logits must equal the cold full recompute."""
    rng = np.random.default_rng(seed)
    n = engine.graph.n_nodes
    ok = True
    for _ in range(n_rounds):
        kind = rng.integers(0, 3)
        if kind == 0:
            ids = rng.integers(0, n, 2)
            engine.update_features(
                ids, rng.standard_normal(
                    (2, engine.feat_dim)).astype(np.float32))
        elif kind == 1:
            engine.update_edges(add=[(int(rng.integers(0, n)),
                                      int(rng.integers(0, n)))
                                     for _ in range(2)])
        else:
            v = int(rng.integers(0, n))
            nbrs = engine.graph.in_neighbors(v)
            if len(nbrs):
                engine.update_edges(remove=[(int(nbrs[0]), v)])
        q = rng.integers(0, n, 4)
        inc = engine.query(q)
        cold = engine.query(q, use_cache=False)
        ok = ok and bool((inc == cold).all())
    return ok


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", default="coo+serial",
                    help="serving Engine spec ('auto' uses the planner's "
                    "serving mode)")
    ap.add_argument("--train-spec", default="ell+pipelined",
                    help="spec the checkpoint-producing Trainer runs")
    ap.add_argument("--n-cores", type=int,
                    default=int(os.environ.get("REPRO_SERVE_CORES", 4)))
    ap.add_argument("--scale", type=float, default=0.004)
    ap.add_argument("--feat-dim", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore from here when it already holds a "
                    "checkpoint; otherwise train into it")
    ap.add_argument("--rate", type=float, default=150.0,
                    help="open-loop arrivals per second")
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--cache-capacity", type=int, default=4096)
    ap.add_argument("--feature-cache-capacity", type=int, default=0,
                    help="hot-vertex cache rows in front of a host feature "
                    "store (0: dense features, no store)")
    ap.add_argument("--update-rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="assert incremental == cold and the p99 budget")
    # ~50x the warm p50: catches a pathological regression without
    # flaking on a loaded host
    ap.add_argument("--p99-budget-ms", type=float, default=400.0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.serving import InferenceService, poisson_trace

    tmp = None
    ckpt_dir = args.ckpt_dir
    dataset = None
    if ckpt_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="repro_serve_ckpt_")
        ckpt_dir = tmp.name
    if not any(name.startswith("step_") for name in
               (os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else [])):
        print(f"training {args.train_steps} steps "
              f"({args.train_spec}, {args.n_cores} cores) -> {ckpt_dir}")
        dataset = _train_checkpoint(args, ckpt_dir)

    engine, dataset = build_engine(args, ckpt_dir, dataset)
    print(f"serving spec: {engine.spec} on {engine.device} "
          f"({engine.n_layers} layers, {engine.graph.n_nodes} nodes)")

    bit_match = mixed_stream_bit_match(engine, args.update_rounds,
                                       args.seed)
    print(f"mixed query/update stream: incremental == cold recompute: "
          f"{bit_match}")

    trace = poisson_trace(args.rate, args.duration, engine.graph.n_nodes,
                          seed=args.seed)
    # a rehearsal pass off the clock replays the same trace once, so every
    # shape bucket it hits has built its plans before the measured pass
    InferenceService(engine, max_batch=args.max_batch,
                     max_wait=args.max_wait_ms * 1e-3) \
        .replay(trace, slo=args.slo_ms * 1e-3)
    service = InferenceService(engine, max_batch=args.max_batch,
                               max_wait=args.max_wait_ms * 1e-3)
    out = service.replay(trace, slo=args.slo_ms * 1e-3)
    hit_rate = engine.cache.hit_rate
    print(f"open loop: {out['completed']} requests  "
          f"p50 {out['p50_ms']:.1f}ms  p99 {out['p99_ms']:.1f}ms  "
          f"throughput@SLO({out['slo_ms']:.0f}ms) "
          f"{out['throughput_at_slo']:.1f}/s  "
          f"coalesce {out['coalesce_factor']:.2f}x  "
          f"embedding-cache hit-rate {hit_rate:.2f}")
    feature_cache = engine.stats().get("feature_cache")
    if feature_cache is not None:
        print(f"feature cache: {feature_cache['capacity']} rows "
              f"({feature_cache['pinned']} pinned), hit-rate "
              f"{feature_cache['hit_rate']:.2f}, "
              f"{feature_cache['bytes_from_store']} bytes from the store")
    if hasattr(engine.features, "store"):
        engine.features.store.close()
    if tmp is not None:
        tmp.cleanup()
    if args.smoke:
        ok = bit_match and out["p99_ms"] < args.p99_budget_ms
        print("SERVING SMOKE", "PASS" if ok else
              f"FAIL (bit_match={bit_match}, p99={out['p99_ms']:.1f}ms, "
              f"budget={args.p99_budget_ms}ms)")
        raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
