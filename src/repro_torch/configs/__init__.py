"""Config registry (the port's copy of :mod:`repro.configs`, LM archs
only): ``--arch <id>`` → ArchConfig, plus the assigned
input-shape grid and the per-cell applicability policy (DESIGN
§Arch-applicability).

40 cells = 10 archs × 4 shapes; 33 runnable + 7 documented long_500k skips
(pure full-attention archs would need a 500k² score matrix / 500k KV per
layer with no sub-quadratic structure)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ArchConfig

_ARCH_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "stablelm-3b": "stablelm_3b",
    "gemma3-27b": "gemma3_27b",
    "llama3.2-1b": "llama3p2_1b",
    "yi-6b": "yi_6b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mamba2-1.3b": "mamba2_1p3b",
    "chameleon-34b": "chameleon_34b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch '{name}'; available: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


# ---------------------------------------------------------------------------
# the assigned shape grid
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str            # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}

# archs with a sub-quadratic long-context path (DESIGN §Arch-applicability):
# SSM state (mamba2), hybrid state + one shared-block KV (zamba2), and
# gemma3's 5:1 sliding-window locality (global layers are O(L)/token at
# decode, which is the runnable budget).
_LONG_OK = {"zamba2-1.2b", "mamba2-1.3b", "gemma3-27b"}


def applicable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape not in SHAPES:
        raise KeyError(shape)
    if shape == "long_500k" and arch not in _LONG_OK:
        return False, ("pure full-attention stack: 500k decode has no "
                       "sub-quadratic path (KV cache + O(L) scores per "
                       "token over 524288 positions) — documented skip")
    return True, ""


def all_cells(include_skipped: bool = False):
    """Yield (arch, shape, runnable, reason) for the 40-cell grid."""
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            ok, reason = applicable(arch, shape)
            if ok or include_skipped:
                yield arch, shape, ok, reason
