"""InferenceService — the queue/coalescer wired to an InferenceEngine
(port of :mod:`repro.serving.service`; host-side, unchanged).

The service is the loop a deployment would run: admit requests into the
deque-backed :class:`~repro.serving.queue.RequestQueue`, close micro-batches
under the FIFO + deadline contract, run each batch's deduplicated vertex
set through one :meth:`InferenceEngine.query`, and scatter the logits back
to every coalesced request.  ``replay`` drives it under an open-loop trace
(arrival times fixed, service lag becomes queueing latency) and returns the
p50/p99/throughput-at-SLO summary the benchmarks gate on.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .engine import InferenceEngine
from .loadgen import Arrival, summarize
from .queue import InferenceRequest, MicroBatch, RequestQueue


class InferenceService:
    """One engine + one queue; synchronous single-worker serving loop."""

    def __init__(self, engine: InferenceEngine, *, max_batch: int = 8,
                 max_wait: float = 0.004, deadline_slack: float = 0.001,
                 use_cache: bool = True):
        self.engine = engine
        self.queue = RequestQueue(max_batch=max_batch, max_wait=max_wait,
                                  deadline_slack=deadline_slack)
        self.use_cache = use_cache
        self.latencies_s: List[float] = []
        self.served = 0

    # -- request plane --------------------------------------------------------
    def submit(self, node: int, *, now: Optional[float] = None,
               deadline: Optional[float] = None) -> InferenceRequest:
        now = time.perf_counter() if now is None else now
        return self.queue.submit(InferenceRequest(node=int(node),
                                                  t_arrival=now,
                                                  deadline=deadline))

    def _serve(self, batch: MicroBatch, now_fn) -> None:
        logits = self.engine.query(batch.nodes, use_cache=self.use_cache)
        pos = np.searchsorted(batch.nodes,
                              [r.node for r in batch.requests])
        done = now_fn()
        for r, p in zip(batch.requests, pos):
            r.result = logits[p]
            r.t_done = done
            self.latencies_s.append(r.latency)
        self.served += len(batch.requests)

    def step(self, *, now: Optional[float] = None, force: bool = False
             ) -> int:
        """Serve at most one ready batch; returns requests answered."""
        t = time.perf_counter() if now is None else now
        batch = self.queue.next_batch(t, force=force)
        if batch is None:
            return 0
        before = self.served
        self._serve(batch, (lambda: now) if now is not None
                    else time.perf_counter)
        return self.served - before

    def drain(self, *, now: Optional[float] = None) -> int:
        """Flush everything queued (shutdown path)."""
        total = 0
        while len(self.queue):
            total += self.step(now=now, force=True)
        return total

    # -- open-loop replay -----------------------------------------------------
    def replay(self, trace: Sequence[Arrival], *, slo: float = 0.05,
               default_deadline: Optional[float] = None) -> Dict[str, float]:
        """Run the trace open-loop in real time and summarize latency.

        Arrivals are admitted at their scheduled offsets from the replay
        start (never earlier — the loop sleeps ahead of schedule, so a
        fast engine cannot batch the future); a request's latency is
        completion wall-time minus its SCHEDULED arrival, so backlog shows
        up as queueing delay exactly like an outside observer would see.
        """
        t0 = time.perf_counter()
        i = 0
        n = len(trace)
        while i < n or len(self.queue):
            now = time.perf_counter() - t0
            while i < n and trace[i].t <= now:
                a = trace[i]
                deadline = None if default_deadline is None \
                    else a.t + default_deadline
                self.queue.submit(InferenceRequest(
                    node=a.node, t_arrival=a.t, deadline=deadline))
                i += 1
            if self.queue.ready(now):
                batch = self.queue.next_batch(now)
                self._serve(batch, lambda: time.perf_counter() - t0)
                continue
            if i >= n:
                # nothing else arrives: drain the sub-max_wait tail
                if len(self.queue):
                    batch = self.queue.next_batch(now, force=True)
                    self._serve(batch, lambda: time.perf_counter() - t0)
                continue
            # idle: sleep to the next arrival or queue wakeup
            wake = trace[i].t
            qw = self.queue.next_wakeup(now)
            if qw is not None:
                wake = min(wake, qw)
            if wake > now:
                time.sleep(min(wake - now, 0.01))
        wall = time.perf_counter() - t0
        out = summarize(self.latencies_s, slo, wall)
        out["coalesce_factor"] = self.queue.coalesce_factor
        return out

    def stats(self) -> Dict[str, float]:
        return {"served": self.served, "use_cache": self.use_cache,
                "queue": self.queue.stats(),
                "engine": self.engine.stats()}
