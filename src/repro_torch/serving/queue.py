"""Request queue + coalescer — deque admission, deduplicated micro-batches
(port of :mod:`repro.serving.queue`; host-side, unchanged).

**Ordering contract (FIFO + deadline):** requests are served in strict
arrival order — a micro-batch is always a contiguous prefix of the queue,
never a reordering (no request can be starved by later arrivals, and a
request's queueing delay is bounded by ``max_wait`` plus one batch's
service time).  Deadlines never reorder; they only *accelerate flushing*:
when the HEAD request's deadline is within ``deadline_slack`` of now, the
batch closes immediately instead of waiting out ``max_wait``.  A batch
closes when the first of these holds:

1. ``max_batch`` requests are queued (size flush),
2. the head request has waited ``max_wait`` seconds (age flush),
3. the head request's deadline is ≤ ``deadline_slack`` away (deadline
   flush).

The head of the queue is ``popleft`` on a :class:`collections.deque` —
O(1), replacing the seed LM server's O(n) ``list.pop(0)`` admission
pattern.

Coalescing happens at batch-close: concurrent queries for the same vertex
collapse into one engine row (:attr:`MicroBatch.nodes` is the sorted unique
vertex set) and every request gets its logits scattered back.  The
cumulative ``coalesce_factor`` (requests served / unique rows computed) is
the benchmark's measure of how much concurrent demand the dedup absorbed.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

_rid = itertools.count()


@dataclasses.dataclass
class InferenceRequest:
    """One node-level query: which vertex, when it arrived, when it must
    answer.  ``result``/``t_done`` are filled by the service."""

    node: int
    t_arrival: float
    deadline: Optional[float] = None
    rid: int = dataclasses.field(default_factory=lambda: next(_rid))
    result: Optional[np.ndarray] = None
    t_done: Optional[float] = None

    @property
    def latency(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_arrival


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """A closed batch: the FIFO-prefix requests plus their deduplicated
    vertex set (sorted ascending — the engine's canonical row order)."""

    requests: List[InferenceRequest]
    nodes: np.ndarray                  # sorted unique int64 vertex ids

    @property
    def coalesce_factor(self) -> float:
        return len(self.requests) / max(len(self.nodes), 1)


class RequestQueue:
    """Deque-backed FIFO with size/age/deadline flushing (contract above)."""

    def __init__(self, *, max_batch: int = 8, max_wait: float = 0.004,
                 deadline_slack: float = 0.001):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.deadline_slack = float(deadline_slack)
        self._q: Deque[InferenceRequest] = deque()
        self.submitted = 0
        self.served_requests = 0
        self.served_unique = 0
        self.batches = 0
        self.flush_reasons = {"size": 0, "age": 0, "deadline": 0,
                              "drain": 0}

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, req: InferenceRequest) -> InferenceRequest:
        self._q.append(req)
        self.submitted += 1
        return req

    # -- flush policy ---------------------------------------------------------
    def _flush_reason(self, now: float) -> Optional[str]:
        if not self._q:
            return None
        if len(self._q) >= self.max_batch:
            return "size"
        head = self._q[0]
        if head.deadline is not None \
                and head.deadline - now <= self.deadline_slack:
            return "deadline"
        if now - head.t_arrival >= self.max_wait:
            return "age"
        return None

    def ready(self, now: float) -> bool:
        return self._flush_reason(now) is not None

    def next_wakeup(self, now: float) -> Optional[float]:
        """Earliest future time a waiting batch will flush on its own (age
        or deadline), or ``None`` for an empty queue — the service sleeps
        until min(this, next arrival)."""
        if not self._q:
            return None
        head = self._q[0]
        t = head.t_arrival + self.max_wait
        if head.deadline is not None:
            t = min(t, head.deadline - self.deadline_slack)
        return max(t, now)

    def next_batch(self, now: float, *, force: bool = False
                   ) -> Optional[MicroBatch]:
        """Close and return the head batch if a flush condition holds
        (``force=True`` drains regardless — shutdown path)."""
        reason = self._flush_reason(now)
        if reason is None:
            if not (force and self._q):
                return None
            reason = "drain"
        reqs = [self._q.popleft()
                for _ in range(min(self.max_batch, len(self._q)))]
        nodes = np.unique(np.fromiter((r.node for r in reqs), np.int64,
                                      len(reqs)))
        self.flush_reasons[reason] += 1
        self.batches += 1
        self.served_requests += len(reqs)
        self.served_unique += len(nodes)
        return MicroBatch(requests=reqs, nodes=nodes)

    # -- metrics --------------------------------------------------------------
    @property
    def coalesce_factor(self) -> float:
        """Cumulative requests-per-computed-row across all served batches."""
        return self.served_requests / max(self.served_unique, 1)

    def stats(self) -> Dict[str, float]:
        return {"submitted": self.submitted, "batches": self.batches,
                "served_requests": self.served_requests,
                "served_unique": self.served_unique,
                "coalesce_factor": self.coalesce_factor,
                "queued": len(self._q), **{f"flush_{k}": v for k, v in
                                           self.flush_reasons.items()}}
