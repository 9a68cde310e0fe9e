"""Bucket-scheme autotuner for the ELL aggregation (port of
:mod:`repro.kernels.tune`).

A small sweep over the degree-bucket capacity scheme (``caps``) of
:mod:`repro_torch.kernels.edgeplan`, timed on a synthetic skewed graph,
with the winner persisted to JSON so every later process (and every
training step) just reads the file:

    from repro_torch.kernels import tune
    cfg = tune.get_config()              # cache → record → defaults
    rec = tune.autotune()                # sweep on the card, persist

Resolution order of :func:`get_config`:

1. in-process cache;
2. the JSON record at ``$REPRO_TORCH_AUTOTUNE_PATH`` (default
   ``BENCH_autotune_torch.json`` in the CWD), only when its ``backend`` is
   this machine's: ``"cuda:" + torch.cuda.get_device_name()`` on a machine
   with a card, ``"cpu"`` without one — a record from another part, or one
   the reference wrote for a TPU, never applies;
3. :data:`DEFAULTS` (no implicit sweep: tests and library imports stay
   hermetic).

The caps arm times the real consumer, as the reference does: one
``ell_aggregate`` forward + backward per call, which on the card is one
``spmm_ell`` and one ``spmm_ell_t`` launch of the one-launch walk.  The
reference's tile arm (``br``/``bd``/``bs``, swept on a TPU only) has
nothing to sweep here: the walk's ``ITEM_ENTRIES``, ``LONG_SLICE`` and
``SHORT_SLICE`` are compile-time constants of ``csrc/spmm_ell.cu`` and
:mod:`repro_torch.kernels.spmm`, so the record's tile list stays empty
until they become runtime arguments of the kernel.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

DEFAULT_FILENAME = "BENCH_autotune_torch.json"
ENV_PATH = "REPRO_TORCH_AUTOTUNE_PATH"

#: the scheme every plan build uses before any sweep: ``"pow2"`` keeps
#: skewed rows from inflating everyone's padding
DEFAULTS: Dict[str, object] = {"caps": "pow2"}

CAPS_CANDIDATES = ["pow2", "single", [2, 8, 32]]

_STORE = None
_config: Optional[Dict] = None


def _store():
    # lazy: importing repro_torch.engine at module load would cycle back
    # through the formats' kernel imports
    global _STORE
    if _STORE is None:
        from repro_torch.engine.plans import RecordStore
        _STORE = RecordStore(DEFAULT_FILENAME, ENV_PATH)
    return _STORE


def cache_path() -> str:
    return _store().path()


def backend_key(device: DeviceLike = None) -> str:
    """The record key of ``device``: ``"cpu"``, or ``"cuda:" +`` the card's
    name (``None`` → the card; raises without one)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    return "cuda:" + torch.cuda.get_device_name(dev)


def _machine_backend() -> str:
    """The backend a plan built on this machine is for: its card when it
    has one, else the CPU."""
    return backend_key("cuda" if torch.cuda.is_available() else "cpu")


def get_config() -> Dict:
    """The tuned config (see module docstring for resolution order); a
    fresh copy each call."""
    global _config
    if _config is None:
        cfg = dict(DEFAULTS)
        rec = _store().load()             # unreadable/corrupt → None
        if rec is not None and rec.get("backend") == _machine_backend():
            try:
                cfg.update(rec.get("config", {}))
            except (ValueError, TypeError):
                pass                      # malformed config block → defaults
        _config = cfg
    return dict(_config)


def reset() -> None:
    """Drop the in-process cache (tests; after writing a new file)."""
    global _config
    _config = None


def skewed_graph(n: int, deg: int, seed: int):
    """The sweep's synthetic graph: ``n × deg`` uniform edges plus
    ``n × deg / 2`` landing on the first ``n / 16`` rows (hubs and a long
    tail, the case bucketing targets), weights ``|N(0, 1)| + 0.1``; the
    reference's draws, in its order."""
    import numpy as np

    from repro_torch.graph.coo import from_edges

    rng = np.random.default_rng(seed)
    rows = np.concatenate([
        rng.integers(0, n, n * deg),
        rng.integers(0, max(n // 16, 1), n * deg // 2),
    ])
    e = len(rows)
    coo = from_edges(rows, rng.integers(0, n, e),
                     np.abs(rng.standard_normal(e)).astype(np.float32) + 0.1,
                     n, n)
    return coo, rng


def _bench_plan_caps(caps, n: int, deg: int, d: int, n_reps: int,
                     seed: int, device: torch.device) -> float:
    """Seconds per forward + backward of ``ell_aggregate`` under one
    scheme on ``device`` (after one untimed call)."""
    from . import edgeplan
    from .ops import ell_aggregate

    coo, rng = skewed_graph(n, deg, seed)
    tables = edgeplan.build_plan(coo, caps=caps).device_tables(device)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype("float32")) \
        .to(device).requires_grad_(True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)

    def step():
        (ell_aggregate(tables, x) ** 2).sum().backward()

    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_reps):
        step()
    sync()
    return (time.perf_counter() - t0) / n_reps


def autotune(path: Optional[str] = None, *, force: bool = False,
             n: int = 512, deg: int = 8, d: int = 64, n_reps: int = 5,
             seed: int = 0, device: DeviceLike = None) -> Dict:
    """Run the sweep on ``device`` (``None`` → the card; raises without
    one), persist the winner to ``path``, return the record.

    Idempotent per file: an existing record for this backend is returned
    untouched unless ``force``.
    """
    dev = resolve_device(device)
    path = path or cache_path()
    backend = backend_key(dev)
    if not force:
        rec = _store().load(path)
        if rec is not None and rec.get("backend") == backend:
            return rec
    caps_timings: List[Dict] = []
    for caps in CAPS_CANDIDATES:
        s = _bench_plan_caps(caps, n, deg, d, n_reps, seed, dev)
        caps_timings.append({"caps": caps, "s_per_fwdbwd": s})
    best_caps = min(caps_timings, key=lambda r: r["s_per_fwdbwd"])["caps"]
    rec = {
        "backend": backend,
        "config": {"caps": best_caps},
        "sweep": {"caps": caps_timings, "tiles": [],
                  "n": n, "deg": deg, "d": d, "n_reps": n_reps},
    }
    _store().save(rec, path)
    reset()                           # next get_config() sees the new file
    return rec
