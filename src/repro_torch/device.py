"""The port's one device rule: the card by default, the CPU only on request.

Every entry point that takes ``device=`` resolves it here.  ``None`` means
``"cuda"``; a CUDA device on a machine without a GPU raises instead of
falling back, so a run that was meant for the card can never quietly
measure or serve from the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device` (``None`` → ``"cuda"``).

    Raises ``RuntimeError`` for a CUDA device when
    ``torch.cuda.is_available()`` is false, and ``ValueError`` for a device
    type the port does not run on (only ``cuda`` and ``cpu``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
