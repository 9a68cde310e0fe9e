"""Feature-wave schedule of the pipelined fold (port of
:func:`repro.core.schedule.feature_waves`; the routing and accounting parts
of that module are not ported yet, ROADMAP port Queue 1)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FeatureWave:
    """One feature-dimension chunk of the pipelined fold (half-open)."""

    start: int
    size: int

    @property
    def stop(self) -> int:
        return self.start + self.size


def feature_waves(d: int, n_chunks: int) -> Tuple[FeatureWave, ...]:
    """Chunk a feature dimension into the double-buffer wave schedule.

    Chunks are contiguous, cover ``[0, d)`` exactly and differ in size by
    at most one column, so the math is bit-identical to the unchunked
    schedule (same per-element add order).
    """
    if d <= 0:
        raise ValueError(f"feature dim must be positive, got {d}")
    n_chunks = max(1, min(int(n_chunks), d))
    base, rem = divmod(d, n_chunks)
    waves = []
    start = 0
    for k in range(n_chunks):
        size = base + (1 if k < rem else 0)
        waves.append(FeatureWave(start=start, size=size))
        start += size
    return tuple(waves)
