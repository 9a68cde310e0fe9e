"""GCN weights (port of :func:`repro.distributed.gcn_train.init_params`;
the rest of :mod:`repro.models.gcn_model` is not ported yet, ROADMAP port
Queue 1).

The same scale as the reference, ``N(0, 1) · d_in^-½`` per layer, drawn
from an explicit :class:`torch.Generator` on the CPU and then moved, so a
seed gives the same weights on every device.  ``jax.random`` streams are
not reproducible without JAX: runs that must match the reference start
from a checkpoint instead (:mod:`repro_torch.checkpoint`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

Params = List[Dict[str, torch.Tensor]]


def init_params(seed: int, dims_io: Sequence[Tuple[int, int]],
                device: DeviceLike = None) -> Params:
    """``[{"w": [d_in, d_out] float32}, ...]``, output layer last, on
    ``device`` (``None`` → the card)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    return [{"w": (torch.randn((d_in, d_out), generator=gen)
                   * d_in ** -0.5).to(dev)}
            for d_in, d_out in dims_io]
