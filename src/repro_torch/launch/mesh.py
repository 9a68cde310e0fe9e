"""The core-axis mesh (port of :mod:`repro.launch.mesh`'s
``make_topology_mesh``).

The reference's mesh has one device per hypercube core.  The port's
``model`` axis has one rank per process, and the Engine spreads the P
cores over its W ranks, ``P / W`` stacked on each
(:mod:`repro_torch.engine.engine`).  A FUNCTION, not a module constant:
importing this module touches no process group and no device.  The TPU
production meshes (``make_production_mesh``) are not ported (ROADMAP
Queue 1, decisions).
"""
from __future__ import annotations

from repro_torch.distributed.sharding import MODEL

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_topology_mesh(n_cores: int, topology: str = "hypercube",
                       axis: str = MODEL, *, device_type: str = "cuda"):
    """A 1-D ``DeviceMesh`` named ``axis`` over every rank of the default
    process group, validated against a registered topology.

    The topology owns the core-count contract
    (``Topology.validate_cores``: a power of two), so a bad count dies here
    with the topology's own error.  The ranks must divide the cores in a
    power-of-two split, and a topology without rounds across ranks
    (``crosses_ranks`` false; every built-in has them) refuses more than
    one (``NotImplementedError``).  ``device_type`` is
    ``"cuda"`` (NCCL) unless the caller asks for ``"cpu"`` (gloo); the
    default process group must already run that backend — this function
    starts none and falls back to none.  On ``cuda`` each rank's current
    device (``torch.cuda.set_device``) is its card.
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.engine.registry import get_topology
    from repro_torch.topology.base import CoreLayout

    topo = get_topology(topology)
    topo.validate_cores(int(n_cores))
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type {device_type!r}: expected 'cuda' or "
                         "'cpu'")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_topology_mesh needs a process group: call "
            "torch.distributed.init_process_group (torchrun sets RANK, "
            "WORLD_SIZE and LOCAL_RANK) first")
    backend = str(dist.get_backend()).lower()
    if _BACKENDS[device_type] not in backend:
        raise RuntimeError(f"a {device_type} mesh runs on "
                           f"{_BACKENDS[device_type]}, but the process "
                           f"group's backend is {backend}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs an NVIDIA GPU; pass "
                           "device_type='cpu' for gloo on the CPU")
    world = dist.get_world_size()
    if n_cores % world or world & (world - 1):
        raise ValueError(f"{world} ranks do not split {n_cores} cores (the "
                         "rank count must be a power of two dividing the "
                         "core count)")
    topo.check_layout(CoreLayout(n_cores=int(n_cores), first=0,
                                 count=int(n_cores) // world))
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))
