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

A placed tree holds each rank's block of every leaf as a plain tensor;
:class:`NamedSharding` (``jax.sharding.NamedSharding``'s counterpart) says
which block, and the moves between placements are :func:`shard` /
:func:`place_tree` (whole → block, no transfer), :func:`take` /
:func:`take_tree` (block → a finer block, no transfer) and :func:`gather`
/ :func:`gather_layers` / :func:`gather_tree` (block → a coarser block:
``all_gather`` over the dropped axes).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Optional, Tuple, Union

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


# --- placed trees: where each leaf lives, and the moves between places ------
def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, the major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where one leaf lives on ``mesh`` (``jax.sharding.NamedSharding``'s
    counterpart): ``spec`` has an entry per dimension of the leaf, and a
    rank holds the block of each dimension that its coordinates on the
    entry's axes select (several axes on one dimension: the first the
    major), the whole dimension where the entry is ``None``.

    The port keeps a stack of layers as a list of per-layer tensors where
    the reference keeps one ``[L, ...]`` leaf, so one layer's sharding
    also carries ``layer = (entry, index, L)``: the reference spec's entry
    for the layer axis, which layer this is, and how many the stack has.
    ``spec`` is then the reference's spec without that entry
    (:attr:`stacked_spec` gives it back).  Where the entry names axes
    (``zero1_spec`` puts the data axes there), a rank holds the layers of
    its block of ``[0, L)`` whole and, of the others, an empty tensor
    ``[0, *block]``: the same bytes as the reference's shard."""

    mesh: Any
    spec: Spec
    layer: Optional[Tuple[Entry, int, int]] = None

    @property
    def placements(self) -> list:
        """``DTensor`` placements of :attr:`spec` (:func:`named`)."""
        return named(self.mesh, self.spec)

    @property
    def stacked_spec(self) -> Spec:
        """The reference's spec of the whole leaf: with the layer axis's
        entry first on one layer of a stack."""
        if self.layer is None:
            return tuple(self.spec)
        return (self.layer[0],) + tuple(self.spec)

    def _coords(self):
        coords = self.mesh.get_coordinate()
        if coords is None:
            return None
        return dict(zip(_names(self.mesh), coords))

    def index(self, entry: Entry) -> Tuple[int, int]:
        """(this rank's block, blocks) of a dimension split by ``entry``:
        row-major over the entry's axes."""
        coords = self._coords()
        idx, count = 0, 1
        for a in entry_axes(entry):
            size = axis_size(self.mesh, a)
            idx, count = idx * size + coords[a], count * size
        return idx, count

    @property
    def member(self) -> bool:
        """Whether this rank is one of the mesh's."""
        return self.mesh.get_coordinate() is not None

    @property
    def holds(self) -> bool:
        """Whether this rank holds the leaf's data: it is one of the mesh's
        and, on one layer of a stack with a sharded layer axis, the layer
        falls in its block."""
        if not self.member:
            return False
        if self.layer is None or self.layer[0] is None:
            return True
        entry, i, n = self.layer
        idx, count = self.index(entry)
        return idx * (n // count) <= i < (idx + 1) * (n // count)

    def block(self, global_shape) -> Tuple[slice, ...]:
        """This rank's slice of each dimension of a leaf of
        ``global_shape``."""
        out = []
        for dim, entry in zip(global_shape, tuple(self.spec)
                              + (None,) * len(global_shape)):
            idx, count = self.index(entry)
            per = dim // count
            out.append(slice(idx * per, (idx + 1) * per))
        return tuple(out)

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """The shape of what this rank holds of a leaf of ``global_shape``
        (one layer's shape on one layer of a stack): its block, or
        ``(0, *block)`` for a layer it does not hold."""
        shape = tuple(s.stop - s.start for s in self.block(global_shape))
        return shape if self.holds else (0,) + shape


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = torch.as_tensor(a)
    return a.to(device=device, dtype=dtype or a.dtype)


@torch.no_grad()
def shard(a, sharding: NamedSharding, device=None, dtype=None):
    """This rank's part of a global leaf (a tensor or a host array) under
    ``sharding``, on ``device`` (``None`` → :func:`mesh_device`): its
    block, contiguous (the tensor itself when the block is all of it and
    it is already there), ``[0, *block]`` of a layer it does not hold,
    and ``None`` on a rank outside the mesh (it holds nothing)."""
    if not sharding.member:
        return None
    device = mesh_device(sharding.mesh) if device is None else device
    idx = sharding.block(tuple(a.shape))
    shape = tuple(s.stop - s.start for s in idx)
    if not sharding.holds:
        return _tensor(a[:0], device, dtype).new_empty((0,) + shape)
    if shape != tuple(a.shape):
        a = a[idx]
    return _tensor(a, device, dtype).contiguous()


@torch.no_grad()
def take(t: torch.Tensor, src: Spec, sharding: NamedSharding
         ) -> torch.Tensor:
    """From a block placed by ``src`` to this rank's block under
    ``sharding`` on the same mesh, with no transfer: ``sharding`` may only
    add axes on dimensions that ``src`` leaves whole (and on the layer
    axis of one layer of a stack)."""
    idx = []
    for dim, a, b in zip(t.shape, tuple(src) + (None,) * t.ndim,
                         tuple(sharding.spec) + (None,) * t.ndim):
        if entry_axes(a) == entry_axes(b):
            idx.append(slice(None))
            continue
        if a is not None:
            raise ValueError(f"take: {src} → {sharding.spec} moves a "
                             "sharded dimension")
        i, count = sharding.index(b)
        per = dim // count
        idx.append(slice(i * per, (i + 1) * per))
    idx = tuple(idx)
    if not sharding.holds:
        return t.new_empty((0,) + tuple(t[idx].shape))
    if all(s == slice(None) for s in idx):
        return t
    return t[idx].contiguous()


def _all_gather(t: torch.Tensor, dim: int, group, size: int
                ) -> torch.Tensor:
    import torch.distributed as dist

    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


@torch.no_grad()
def gather(t: torch.Tensor, sharding: NamedSharding, to: Spec = ()
           ) -> torch.Tensor:
    """From this rank's block under ``sharding`` to its block under ``to``
    (by default the whole leaf): an ``all_gather`` along each dimension
    whose axes ``to`` drops, over each dropped axis of size > 1, the
    minor first.  ``to`` keeps or drops a dimension's entry whole.  A
    collective over those axes: every rank of them calls it.  (One layer
    of a stack with a sharded layer axis moves with its stack:
    :func:`gather_layers`.)"""
    mesh = sharding.mesh
    for dim, a, b in zip(range(t.ndim), tuple(sharding.spec)
                         + (None,) * t.ndim, tuple(to) + (None,) * t.ndim):
        if entry_axes(a) == entry_axes(b):
            continue
        if b is not None:
            raise ValueError(f"gather: {sharding.spec} → {to} splits a "
                             "dimension anew")
        for ax in reversed(entry_axes(a)):
            size = axis_size(mesh, ax)
            if size > 1:
                t = _all_gather(t, dim, mesh.get_group(ax), size)
    return t


@torch.no_grad()
def gather_layers(layers: list, shardings: list) -> list:
    """One stack's per-layer tensors, placed with its layer axis sharded
    (each rank holds its block of layers whole), as every layer on every
    rank of the layer axis's mesh axes: the held layers stacked, then one
    ``all_gather`` over each of those axes of size > 1, the minor
    first."""
    entry = shardings[0].layer[0]
    mesh = shardings[0].mesh
    sizes = [(ax, axis_size(mesh, ax)) for ax in entry_axes(entry)]
    if all(size == 1 for _, size in sizes):
        return list(layers)
    held = torch.stack([t for t, sh in zip(layers, shardings) if sh.holds])
    for ax, size in reversed(sizes):
        if size > 1:
            held = _all_gather(held, 0, mesh.get_group(ax), size)
    return list(held.unbind(0))


def _is_stack(shardings) -> bool:
    return isinstance(shardings, list) and bool(shardings) and isinstance(
        shardings[0], NamedSharding) and shardings[0].layer is not None


def map_placed(fn, tree, shardings, *rest):
    """``fn(part, sharding, *rest_parts)`` over the units of a placed tree:
    each leaf with its :class:`NamedSharding` (or ``None``), and each
    stack (a list of one-layer shardings) as one list, so that a stack
    with a sharded layer axis moves as a whole.  Dicts, lists, tuples,
    named tuples and dataclasses (the caches) keep their structure."""
    if shardings is None or isinstance(shardings, NamedSharding) \
            or _is_stack(shardings):
        return fn(tree, shardings, *rest)
    if isinstance(tree, dict):
        return {k: map_placed(fn, tree[k], shardings[k], *(r[k] for r in rest))
                for k in tree}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return type(tree)(**{k: map_placed(
            fn, getattr(tree, k), getattr(shardings, k),
            *(getattr(r, k) for r in rest)) for k in names})
    if isinstance(tree, (list, tuple)):
        items = [map_placed(fn, v, shardings[i], *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    raise TypeError(f"no sharding for a {type(tree).__name__} leaf")


def place_tree(tree, shardings, device=None):
    """A tree of global leaves (tensors or host arrays) as each rank's
    parts (:func:`shard`); a leaf whose sharding is ``None`` stays as it
    is."""
    def one(a, sh):
        if sh is None:
            return a
        if isinstance(sh, list):
            return [shard(x, s, device) for x, s in zip(a, sh)]
        return shard(a, sh, device)
    return map_placed(one, tree, shardings)


def take_tree(tree, src, shardings):
    """A tree placed by ``src`` cut to the finer placements ``shardings``
    on the same mesh, leaf by leaf with no transfer (:func:`take`)."""
    def one(t, sh, s):
        if isinstance(sh, list):
            return [take(x, a.spec, b) for x, a, b in zip(t, s, sh)]
        return take(t, s.spec, sh)
    return map_placed(one, tree, shardings, src)


def gather_tree(tree, shardings, to=None):
    """A placed tree moved to the placements ``to`` (a tree of shardings on
    the same mesh; ``None``: every leaf whole on every rank): the layer
    blocks of a stack first (:func:`gather_layers`), then each leaf's
    dimensions (:func:`gather`).  A collective: every rank of the mesh
    calls it; a rank outside it gets ``None`` leaves."""
    def one(a, sh, *dst):
        if sh is None:
            return a
        tgt = dst[0] if dst else None
        if not isinstance(sh, list):
            if not sh.member:
                return None
            return gather(a, sh, () if tgt is None else tgt.spec)
        if not sh[0].member:
            return [None] * len(sh)
        if sh[0].layer[0] is not None:
            a = gather_layers(a, sh)
        tgt = [None] * len(sh) if tgt is None else tgt
        return [gather(x, s, () if t is None else t.spec)
                for x, s, t in zip(a, sh, tgt)]
    if to is None:
        return map_placed(one, tree, shardings)
    return map_placed(one, tree, shardings, to)
