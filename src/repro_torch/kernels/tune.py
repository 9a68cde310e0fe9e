"""Bucket configuration of the ELL engine (port of the default tier of
:mod:`repro.kernels.tune`).

Only the default is ported: ``caps="pow2"`` keeps skewed rows from
inflating everyone's padding.  The port reads no persisted autotune record
— the reference's winners were measured on a TPU or a CPU and do not apply
to this card; a Hopper sweep writing its own record is later work
(ROADMAP, port Queue 1).
"""
from __future__ import annotations

from typing import Dict

DEFAULTS: Dict[str, object] = {"caps": "pow2"}


def get_config() -> Dict[str, object]:
    """The bucket configuration every plan build without explicit caps
    uses (a fresh copy; callers may not mutate the defaults)."""
    return dict(DEFAULTS)
