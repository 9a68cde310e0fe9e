"""Placement rules over a ``torch.distributed`` ``DeviceMesh`` — one place
that knows where every tensor lives (port of
:mod:`repro.distributed.sharding`).

Mesh axes (:func:`repro_torch.launch.mesh.make_topology_mesh`):
  * ``pod``   — outer data-parallel axis across pods
  * ``data``  — data parallel within a pod
  * ``model`` — the core axis: the paper's hypercube for graph aggregation
                (each rank holds a contiguous range of the P cores)

The paper's NUMA rule generalizes: *a tensor is sharded on the axis that
makes its heaviest consumer local.*  Node features and edge blocks shard
over ``model``; GCN weights are replicated (the Weight Bank) and their
gradients all-reduced.

A spec is a plain tuple with one entry per tensor dimension: a mesh axis
name, a tuple of names, or ``None`` — the content of the reference's
``PartitionSpec``, normalized as it normalizes it (a one-name tuple is the
name, an empty tuple is ``None``).  :func:`named` turns a spec into the
``DTensor`` placements over the mesh's dimensions, and
:func:`axis_layout` is the one rule that spreads a per-core-stacked axis
over ranks (a :class:`~repro_torch.topology.base.CoreLayout`), and
:func:`put_block` / :func:`leading_axis_put` place one such leaf: this
rank's contiguous block of its leading axis, on the rank's device, in one
transfer.  :func:`use_mesh` makes a mesh current, as ``jax.set_mesh`` does
in the reference, so code that names axes (``grad_accum(axis_names=...)``)
resolves them to the mesh's process groups.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

MODEL = "model"
DATA = "data"
POD = "pod"

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s dimension ``name``."""
    return int(mesh.size(_names(mesh).index(name)))


def _entry(axes) -> Entry:
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes
    return axes


def _spec(*entries) -> Spec:
    return tuple(_entry(e) for e in entries)


def batch_axes(mesh) -> Tuple[str, ...]:
    """All data-parallel axes present in this mesh (pod outermost)."""
    return tuple(a for a in (POD, DATA) if a in _names(mesh))


def dp_size(mesh) -> int:
    out = 1
    for a in batch_axes(mesh):
        out *= axis_size(mesh, a)
    return out


# --- activation specs -------------------------------------------------------
def act_batch(mesh, *trailing: Optional[str]) -> Spec:
    """[batch, ...] activation: batch over all DP axes."""
    return _spec(batch_axes(mesh), *trailing)


def act_batch_seq(mesh, shard_seq: bool = False) -> Spec:
    """[batch, seq, d] activation; optionally sequence-sharded over model."""
    if shard_seq:
        return _spec(batch_axes(mesh), MODEL, None)
    return _spec(batch_axes(mesh), None, None)


# --- weight specs (megatron pairing: col-shard then row-shard) --------------
def w_col(mesh) -> Spec:
    """[d_in, d_out] with d_out over model (QKV proj, FFN up/gate)."""
    return _spec(None, MODEL)


def w_row(mesh) -> Spec:
    """[d_in, d_out] with d_in over model (attn out proj, FFN down)."""
    return _spec(MODEL, None)


def w_replicated(mesh) -> Spec:
    return ()


def embed_vocab(mesh) -> Spec:
    """[vocab, d] — vocab over model."""
    return _spec(MODEL, None)


def moe_expert(mesh) -> Spec:
    """[experts, d_in, d_out] — experts over model (EP)."""
    return _spec(MODEL, None, None)


def kv_cache(mesh) -> Spec:
    """[batch, heads_kv, seq, hd] — batch over DP, kv heads over model."""
    return _spec(batch_axes(mesh), MODEL, None, None)


# --- graph (paper) specs ----------------------------------------------------
def node_features(mesh) -> Spec:
    """[n_nodes, d] — rows over model: the NUMA placement (core i owns its
    nodes' features in its own memory)."""
    return _spec(MODEL, None)


def edge_shards(mesh) -> Spec:
    """[P, e_max] sender-side edge blocks — leading axis over model."""
    return _spec(MODEL, None)


def gcn_weights(mesh) -> Spec:
    """GCN weights are replicated over model (the paper's Weight Bank keeps
    a synchronized copy per core) and all-reduced."""
    return ()


def named(mesh, spec: Spec) -> list:
    """The ``DTensor`` placements of ``spec`` over ``mesh``'s dimensions:
    ``Shard(i)`` on a mesh dimension that tensor dimension ``i`` names,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in _names(mesh):
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def leading_axis_spec(a, axis: str = MODEL) -> Spec:
    """Spec of a per-core-stacked host artifact: leading axis over ``axis``,
    everything else replicated — the rule every edge layout (flat COO
    lists, Block-Message tiles, pre-reduced ELL tables) shares."""
    return _spec(axis, *([None] * (np.ndim(a) - 1)))


def mesh_device(mesh) -> torch.device:
    """The device this rank's blocks live on: the current card of a
    ``cuda`` mesh, the CPU of a ``cpu`` one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_layout(mesh, n: int, axis: str = MODEL):
    """This rank's :class:`~repro_torch.topology.base.CoreLayout` of a
    leading axis of ``n`` split evenly over ``axis``: rank ``r`` of it
    holds ``[r · n / size, (r + 1) · n / size)`` — the one rule that
    spreads cores (or any per-core-stacked axis) over ranks."""
    from repro_torch.topology.base import CoreLayout

    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"leading axis of {n} does not split over the "
                         f"{size} ranks of {axis!r}")
    count = n // size
    return CoreLayout(n_cores=n, first=mesh.get_local_rank(axis) * count,
                      count=count, group=mesh.get_group(axis))


def put_block(layout, a, device) -> torch.Tensor:
    """Place one per-core-stacked leaf (a host array or a tensor on any
    device) on ``device`` in one transfer: all of it without a ``layout``,
    else this rank's block of its leading axis (``layout.block``)."""
    if layout is not None:
        a = a[layout.block(a.shape[0])]
    if isinstance(a, torch.Tensor):
        return a.contiguous().to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def leading_axis_put(mesh, a, axis: str = MODEL) -> torch.Tensor:
    """Place one per-core-stacked leaf: this rank's contiguous block of its
    leading axis over ``axis``, on the rank's device, in one transfer (a
    host array or a tensor on any device)."""
    return put_block(axis_layout(mesh, len(a), axis), a, mesh_device(mesh))


# --- the current mesh (jax.set_mesh) ----------------------------------------
_CURRENT = []


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` current inside the block (nests)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost :func:`use_mesh` mesh, or ``None``."""
    return _CURRENT[-1] if _CURRENT else None
