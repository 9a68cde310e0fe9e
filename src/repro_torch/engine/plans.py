"""Shared persistence for tuned records (port of :mod:`repro.engine.plans`):
one file → env → default contract.

Two tuners persist winners to JSON so later processes just read the file:
the ELL bucket-scheme sweep (:mod:`repro_torch.kernels.tune`) and the spec
planner (:mod:`repro_torch.engine.planner`).  Both resolve their path the
same way — an explicit argument beats the ``$REPRO_TORCH_*_PATH``
environment override beats the default filename in the CWD — and both
treat a missing, unreadable or corrupt file as "no record" (library
imports and tests stay hermetic; a broken cache can never crash a training
run).  :class:`RecordStore` is that contract.

The port's stores have their own default names and env vars
(``BENCH_*_torch.json``, ``REPRO_TORCH_*_PATH``), so it never reads a
winner the reference measured on another backend.  Stores hold plain JSON
dicts; schema and staleness checks (backend match, registered-spec checks)
stay with the consumer.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Optional


class RecordStore:
    """File-backed JSON record with env-var path override.

    ``path()`` resolution: explicit argument → ``$<env_var>`` → the
    default filename in the CWD.
    """

    def __init__(self, default_filename: str, env_var: str):
        self.default_filename = default_filename
        self.env_var = env_var

    def path(self, path: Optional[str] = None) -> str:
        if path is not None:
            return path
        return os.environ.get(self.env_var, self.default_filename)

    def load(self, path: Optional[str] = None, *,
             warn_corrupt: bool = False) -> Optional[Dict]:
        """The record dict, or ``None`` when the file is missing,
        unreadable, corrupt, or not a JSON object.  ``warn_corrupt`` emits
        a ``RuntimeWarning`` for files that exist but cannot be used —
        callers fall back, they never crash on a bad cache."""
        p = self.path(path)
        if not os.path.exists(p):
            return None
        try:
            with open(p) as f:
                rec = json.load(f)
        except (OSError, ValueError) as e:
            if warn_corrupt:
                warnings.warn(f"ignoring unreadable record {p!r}: {e}",
                              RuntimeWarning, stacklevel=2)
            return None
        if not isinstance(rec, dict):
            if warn_corrupt:
                warnings.warn(f"ignoring non-object record {p!r}",
                              RuntimeWarning, stacklevel=2)
            return None
        return rec

    def save(self, rec: Dict, path: Optional[str] = None) -> str:
        p = self.path(path)
        with open(p, "w") as f:
            json.dump(rec, f, indent=1)
        return p
