"""Elastic scaling — reshard a running job onto a different mesh (port of
:mod:`repro.checkpoint.elastic`).

Checkpoints store GLOBAL host arrays (:mod:`repro_torch.checkpoint.manager`),
so elasticity reduces to "restore with the new mesh's shardings"
(``restore(..., shardings=)``).  This module supplies the pieces around
that:

  * :func:`reshard` — live tree → new mesh (no disk round-trip): gather
    to whole tensors, then each rank takes its part under the target
    shardings.  Used when the job keeps running but the healthy-device set
    changed;
  * :func:`scale_plan` — given the devices left, the largest
    (data, model) mesh with the fixed model-parallel degree and the
    per-device batch rescaling that keeps the global batch, and
    :func:`make_mesh_from_plan`, the ``DeviceMesh`` of a plan;
  * :func:`gather_global` — a tree of tensors (placed, given their
    shardings) → the same tree of host numpy arrays, and
    :func:`shardings_like`.

A placed tree holds each rank's part of every leaf as a plain tensor, and
the :class:`~repro_torch.distributed.sharding.NamedSharding` tree beside
it says where each part lies (``launch/steps.py::tree_shardings``).  A
rank outside a mesh holds nothing of a tree placed on it (``None``
leaves) and joins none of its collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (NamedSharding, gather_tree,
                                              place_tree)
from repro_torch.optim.optimizers import tree_map


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return None if leaf is None else np.asarray(leaf)


def gather_global(tree: Any, shardings: Any = None) -> Any:
    """Device tree → host numpy tree (global arrays).  A tree placed on a
    mesh takes its ``shardings``: the whole of each leaf is gathered
    first (a collective: every rank of the mesh calls it)."""
    if shardings is not None:
        tree = gather_tree(tree, shardings)
    return tree_map(_host, tree)


def reshard(tree: Any, shardings: Any, source: Any = None) -> Any:
    """Place a tree onto new shardings leaf by leaf: whole leaves (host
    arrays or tensors), or a tree placed by ``source`` (gathered whole
    first, over the source mesh).  Each rank of the target mesh gets its
    part on its device, a rank outside it ``None``."""
    if source is not None:
        tree = gather_tree(tree, source)
    return place_tree(tree, shardings)


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


def make_mesh_from_plan(plan: ScalePlan, devices: Optional[Sequence] = None,
                        *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``plan.mesh_shape`` named ``plan.axis_names``
    over the first ``plan.n_devices`` ranks of the default process group
    (or over the ranks ``devices``), on ``device_type`` (the card unless
    the caller asks for ``"cpu"``).  Every rank of the process group calls
    it (it makes the mesh's process groups); a rank outside the mesh gets
    a mesh it is not in (``get_coordinate()`` is ``None``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh_from_plan needs a process group: call "
                           "torch.distributed.init_process_group first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs an NVIDIA GPU; pass "
                           "device_type='cpu' for gloo on the CPU")
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))[:plan.n_devices]
    if len(ranks) != plan.n_devices:
        raise ValueError(f"the plan's {plan.n_devices} devices, but "
                         f"{len(ranks)} ranks to place them on")
    return DeviceMesh(device_type,
                      torch.tensor(ranks).reshape(plan.mesh_shape),
                      mesh_dim_names=tuple(plan.axis_names))


def shardings_like(tree: Any, mesh, spec_fn: Callable) -> Any:
    """Build a shardings tree: ``spec_fn(leaf) -> spec`` for each leaf
    (most callers use a constant replicated spec, ``()``)."""
    return tree_map(lambda leaf: NamedSharding(mesh, tuple(spec_fn(leaf))),
                    tree)
