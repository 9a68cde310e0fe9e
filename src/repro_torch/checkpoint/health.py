"""Health monitoring — failure detection and straggler policy (port of
:mod:`repro.checkpoint.health`, plain Python, as is).

The monitor is the policy engine a deployment drives from heartbeats: it
consumes per-step, per-worker timing/liveness reports and emits actions:

  * ``CHECKPOINT_NOW``  — a worker missed its first heartbeat: save before
    the likely loss of a host;
  * ``EVICT_AND_RESHARD`` — worker confirmed dead (``miss_limit`` misses)
    or a persistent straggler: shrink to the survivors
    (:mod:`repro_torch.checkpoint.elastic`);
  * ``REBALANCE`` — transient straggler (> ``straggler_factor`` × median
    step time for ``patience`` consecutive steps): shed load first —
    matching the paper's observation (§5.3, Fig. 10/11) that skewed
    aggregation load, not compute, drives core idling.

Deterministic; :func:`repro_torch.launch.train.train_lm` wires it into
the loop.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence


class Action(enum.Enum):
    NONE = "none"
    CHECKPOINT_NOW = "checkpoint_now"
    REBALANCE = "rebalance"
    EVICT_AND_RESHARD = "evict_and_reshard"


@dataclasses.dataclass
class WorkerState:
    worker_id: int
    alive: bool = True
    missed_heartbeats: int = 0
    slow_streak: int = 0


@dataclasses.dataclass
class HealthMonitor:
    n_workers: int
    straggler_factor: float = 1.5
    patience: int = 3
    miss_limit: int = 2

    def __post_init__(self):
        self.workers = [WorkerState(i) for i in range(self.n_workers)]
        self.log: List[Dict] = []

    # -- report ingestion ----------------------------------------------------
    def report_step(self, step: int, step_times: Sequence[Optional[float]]
                    ) -> Dict[int, Action]:
        """step_times[i] = wall seconds for worker i, or None = no heartbeat.
        Returns {worker_id: action} for every non-NONE action."""
        alive_times = [t for t in step_times if t is not None]
        median = sorted(alive_times)[len(alive_times) // 2] if alive_times \
            else 0.0
        actions: Dict[int, Action] = {}
        for w, t in zip(self.workers, step_times):
            if not w.alive:
                continue
            if t is None:
                w.missed_heartbeats += 1
                if w.missed_heartbeats == 1:
                    actions[w.worker_id] = Action.CHECKPOINT_NOW
                if w.missed_heartbeats >= self.miss_limit:
                    w.alive = False
                    actions[w.worker_id] = Action.EVICT_AND_RESHARD
                continue
            w.missed_heartbeats = 0
            if median and t > self.straggler_factor * median:
                w.slow_streak += 1
                if w.slow_streak == self.patience:
                    actions[w.worker_id] = Action.REBALANCE
                elif w.slow_streak >= 2 * self.patience:
                    w.alive = False
                    actions[w.worker_id] = Action.EVICT_AND_RESHARD
            else:
                w.slow_streak = 0
        if actions:
            self.log.append({"step": step,
                             "actions": {k: v.value
                                         for k, v in actions.items()}})
        return actions

    # -- state ----------------------------------------------------------------
    def survivors(self) -> List[int]:
        return [w.worker_id for w in self.workers if w.alive]

    def n_alive(self) -> int:
        return len(self.survivors())
