"""Elastic scaling — the scale plan and the host gather (port of the
device-independent part of :mod:`repro.checkpoint.elastic`).

Checkpoints store GLOBAL host arrays (:mod:`repro_torch.checkpoint.manager`),
so elasticity reduces to "restore onto the new layout".  This module keeps:

  * :func:`scale_plan` — given the devices left, the largest
    (data, model) mesh with the fixed model-parallel degree and the
    per-device batch rescaling that keeps the global batch;
  * :func:`gather_global` — a tree of tensors → the same tree of host
    numpy arrays.

The reference's ``reshard`` / ``make_mesh_from_plan`` / ``shardings_like``
place trees on a JAX device mesh; their counterpart is a
``torch.distributed`` device mesh, which comes with the multi-GPU backend.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_map


def gather_global(tree: Any) -> Any:
    """Device tree → host numpy tree (global arrays)."""
    def host(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().cpu().numpy()
        return np.asarray(leaf)
    return tree_map(host, tree)


@dataclasses.dataclass(frozen=True)
class ScalePlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_devices: int
    per_device_batch_scale: float   # multiply per-device batch by this


def scale_plan(n_available: int, *, model_parallel: int = 16,
               global_batch: int = 256) -> ScalePlan:
    """Largest (data, model) mesh with the fixed model-parallel degree.

    The paper's 16-core hypercube is a property of the MODEL layout, so
    elasticity trades only the data axis: lose a node → drop one data
    replica, keep the global batch by scaling the per-device batch.  The
    formula is the reference's, its unused ``old_data`` included.
    """
    if n_available < model_parallel:
        # degrade model parallelism by powers of two (hypercube needs 2^k)
        mp = 1 << int(np.log2(max(n_available, 1)))
        data = 1
    else:
        mp = model_parallel
        data = n_available // model_parallel
    new_world = data * mp
    old_data = max(global_batch // max(global_batch // max(data, 1), 1), 1)  # noqa: F841
    return ScalePlan(
        mesh_shape=(data, mp), axis_names=("data", "model"),
        n_devices=new_world,
        per_device_batch_scale=global_batch / (data * (global_batch // max(data, 1))) if data else 1.0,
    )
