"""Declarative Engine configuration (port of :mod:`repro.engine.config`).

Spec grammar, as in the reference: ``format[+schedule[+topology[+partition]]]``
— ``"ell"``, ``"ell+pipelined"``, ``"ell+pipelined+ring"``,
``"ell+pipelined+hypercube+mincom"``.  An omitted schedule takes the
format's default, an omitted topology ``hypercube``, an omitted partition
``naive``; ``.spec`` is the canonical spelling.  ``merge`` is a config
field, not a spec part.  The ``"auto"`` spec and the ``block`` format
parse to an error naming the slice that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

from . import registry

Caps = Union[str, Sequence[int], None]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Declarative spec of one aggregation engine: the reference's spec
    parts plus the knobs the port reads.

    n_chunks: feature waves of the pipelined schedule (``None`` → the
              schedule's default, one wave)
    caps:     ELL bucket capacities (``None`` → the default scheme)
    block_tiles: destination tiles of the block format's single-device
              layer (distributed paths always tile per core)
    lr:       SGD learning rate of ``EngineBundle.train_step``
    (The reference's mesh ``axis`` has no counterpart: the stacked cores
    are a tensor axis.)
    """

    format: str = "coo"
    schedule: Optional[str] = None
    topology: Optional[str] = None
    partition: str = "naive"
    merge: str = "dedup"
    caps: Caps = None
    n_chunks: Optional[int] = None
    block_tiles: int = 4
    lr: float = 0.05

    def __post_init__(self):
        from repro_torch.kernels.edgeplan import validate_merge
        registry.validate_partition(self.partition)
        validate_merge(self.merge)
        if self.format == registry.AUTO_SPEC:
            raise NotImplementedError(
                f"the {registry.AUTO_SPEC!r} spec is not ported yet; it comes "
                f"with {registry.AUTO_SLICE} — name a concrete spec from "
                f"{registry.supported_specs()}")
        fmt = registry.get_format(self.format)
        if self.schedule is None:
            object.__setattr__(self, "schedule", fmt.default_schedule)
        if self.topology is None:
            object.__setattr__(self, "topology", registry.DEFAULT_TOPOLOGY)
        registry.validate_combo(self.format, self.schedule, self.topology)
        if self.caps is not None and not isinstance(self.caps, str):
            object.__setattr__(self, "caps", tuple(int(c) for c in self.caps))
        if self.n_chunks is not None and int(self.n_chunks) < 1:
            raise ValueError(f"n_chunks must be >= 1, got {self.n_chunks}")
        if self.block_tiles < 1:
            raise ValueError(
                f"block_tiles must be >= 1, got {self.block_tiles}")

    @classmethod
    def from_spec(cls, spec: str, **overrides) -> "EngineConfig":
        """Parse ``format[+schedule[+topology[+partition]]]`` into a
        validated config; ``overrides`` set the remaining knobs."""
        parts = [p.strip() for p in spec.split("+")]
        if not 1 <= len(parts) <= 4 or not all(parts):
            raise ValueError(
                f"bad engine spec {spec!r}: expected 'format', "
                f"'format+schedule', 'format+schedule+topology' or "
                f"'format+schedule+topology+partition'; valid "
                f"specs: {registry.supported_specs()} (+ optionally one of "
                f"{list(registry.TOPOLOGIES)}, then one of "
                f"{list(registry.PARTITIONS)})")
        kw = dict(overrides)
        kw["format"] = parts[0]
        if len(parts) >= 2:
            kw["schedule"] = parts[1]
        if len(parts) >= 3:
            kw["topology"] = parts[2]
        if len(parts) == 4:
            kw["partition"] = parts[3]
        return cls(**kw)

    @property
    def spec(self) -> str:
        """Canonical spec: two parts when topology and partition are the
        defaults, the topology spelled out otherwise, ``+partition`` only
        when it is not ``naive``."""
        base = f"{self.format}+{self.schedule}"
        if self.partition != "naive":
            return f"{base}+{self.topology}+{self.partition}"
        if self.topology == registry.DEFAULT_TOPOLOGY:
            return base
        return f"{base}+{self.topology}"
