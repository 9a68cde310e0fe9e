"""Step builders and sharding assignment (port of
:mod:`repro.launch.steps`): shared by the dry run, training and serving.

:func:`build_step` returns the callable of one cell's kind, with the
reference's defaults: ``"train"`` an AdamW training step with remat on,
``"prefill"`` the serving prefill, ``"decode"`` the one-token serve step.
Built under :func:`~repro_torch.distributed.sharding.use_mesh`, the train
and prefill steps run across the ranks of a ``(data, model)``
``DeviceMesh`` (:func:`mesh_train_step`, :func:`mesh_prefill`).

Sharding assignment is rule-based, the reference's rules kept exactly
(megatron TP pairing, EP on experts, vocab-sharded embeddings, DP on
batch) with its divisibility SANITIZER: any named axis that does not
evenly divide its dim is dropped to None — which makes odd dims
(llama4's 40 heads, seamless' 256206 vocab, mamba2's 50280 vocab,
long_500k's batch=1) place cleanly.  A spec is the plain tuple of
:mod:`repro_torch.distributed.sharding`, and :func:`tree_shardings`
returns a tree of its :class:`~repro_torch.distributed.sharding.
NamedSharding` s.  The reference keeps a stack of layers as one ``[L,
...]`` leaf; the port keeps one tensor per layer, so a per-layer tensor's
spec is the reference's without its leading layer entry, and
:func:`zero1_spec`'s data axes, which for a stack of ``L % dp == 0``
layers land on the layer axis, give each data rank its block of layers
whole (``NamedSharding.layer``).

On a mesh each leaf is STORED in its :func:`tree_shardings` placement
(the moments in ``zero1``'s), and the step gathers it to the placement it
COMPUTES in, which :func:`tp_plan` decides block by block: a block whose
leaves the sanitizer keeps split over ``model``, and whose heads split
too, computes in that split, as GSPMD computes the reference's from the
same rules (``models/*`` under a ``tensor_parallel.Split``: megatron's
column / row pairs with f and g, Mamba2's channel split, the
vocab-parallel embedding, head and loss; the MoE expert stacks keep
their ``model`` block under ``moe_ffn_ep``); any other block computes
whole on every rank, gathered.  At ``W > 1`` the row blocks' products and
the vocab's log-sum-exp sum over ``model`` in parts, so a mesh step is
no longer bit-equal to the unsharded one (within 1e-6 of its loss); on
one rank it is.  The GSPMD constraint ``sp_spec`` is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import Shape
from repro_torch.distributed.sharding import (MODEL, NamedSharding, Spec,
                                              _spec, axis_size,
                                              current_mesh, entry_axes,
                                              gather_tree, take, take_tree,
                                              use_mesh)
from repro_torch.distributed.tensor_parallel import (SPLIT, WHOLE, Split,
                                                     gather_vocab,
                                                     split_for, use_split)
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import (apply_updates,
                                          clip_by_global_norm, tree_leaves,
                                          tree_map)

KINDS = ("train", "prefill", "decode")

# leaf-name → trailing-dim spec (a stack's layer entry goes in front)
_COL = (None, MODEL)       # output-dim sharded
_ROW = (MODEL, None)       # input-dim sharded (psum after)
_NAME_RULES: Dict[str, Tuple] = {
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    "w_gate": _COL, "w_up": _COL, "w_down": _ROW,
    "w_z": _COL, "w_x": _COL, "w_dt": _COL, "out_proj": _ROW,
    "w_B": (), "w_C": (), "router": (),
    "conv_wx": (None, MODEL), "conv_bx": (MODEL,),
    "conv_wB": (), "conv_bB": (), "conv_wC": (), "conv_bC": (),
    "dt_bias": (MODEL,), "A_log": (MODEL,), "D": (MODEL,),
    "norm_g": (MODEL,),
    "embed": (MODEL, None),             # vocab-sharded
    "lm_head": (None, MODEL),
}
# MoE expert stacks [e, d, f]: EP over experts + FSDP over the data axes on
# d — without the data shard a 400B-expert arch (llama4) cannot fit HBM;
# the step all-gathers the data shard before use (the standard FSDP trade)
_DP = "__dp__"                         # placeholder → dp_axes(mesh)
_EXPERT_RULES: Dict[str, Tuple] = {
    "w_gate": (MODEL, _DP, None), "w_up": (MODEL, _DP, None),
    "w_down": (MODEL, _DP, None),
}
_STACK_KEYS = {"layers", "moe_layers", "dense_layers", "enc_layers",
               "dec_layers", "mamba_layers"}


def _names(mesh) -> Dict[str, int]:
    return {a: axis_size(mesh, a) for a in (mesh.mesh_dim_names or ())}


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def sanitize(spec: Tuple, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop axis names that don't divide their dim (or don't exist)."""
    sizes = _names(mesh)
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            fixed.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        ok = True
        for a in axes:
            if a not in sizes:
                ok = False
                break
            size *= sizes[a]
        fixed.append(ax if ok and dim % size == 0 else None)
    return _spec(*fixed)


def param_spec(path, leaf_shape: Tuple[int, ...], mesh) -> Spec:
    """The spec of the leaf at ``path`` (its tree keys; list indices are
    skipped) of shape ``leaf_shape``.  A leaf under a stack key is one
    layer: its spec is the reference's for the stacked leaf without the
    leading layer entry."""
    names = tuple(p for p in path if isinstance(p, str))
    if not names:
        return ()
    name = names[-1]
    if name.startswith("x_"):          # cross-attention clones
        name = name[2:]
    rules = _NAME_RULES
    if name in _EXPERT_RULES and len(leaf_shape) == 3:
        rules = _EXPERT_RULES
    trailing = [dp_axes(mesh) if ax == _DP else ax
                for ax in rules.get(name, ())]
    return sanitize(tuple(trailing), leaf_shape, mesh)


def zero1_spec(pspec: Spec, leaf_shape: Tuple[int, ...], mesh) -> Spec:
    """ZeRO-1: shard optimizer moments over the data axes too — inject the
    dp axes on the first still-unsharded divisible dim.  The f32 moments
    are the memory bulk at scale; the step reduces each gradient and runs
    the update in this placement, then gathers the new params back."""
    dp = dp_axes(mesh)
    if not dp:
        return tuple(pspec)
    used = set()
    for ax in pspec:
        used.update(entry_axes(ax))
    if any(a in used for a in dp):
        return tuple(pspec)
    sizes = _names(mesh)
    size = 1
    for a in dp:
        size *= sizes[a]
    new = list(pspec) + [None] * (len(leaf_shape) - len(pspec))
    for i, (ax, dim) in enumerate(zip(new, leaf_shape)):
        if ax is None and dim % size == 0 and dim >= size:
            new[i] = dp
            break
    return _spec(*new)


def _walk(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of tensors: dicts and dataclasses
    by key, named tuples by field, lists by index, ``None`` kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(fn, v, path + (k,)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _walk(fn, getattr(tree, f.name),
                                           path + (f.name,))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        items = [_walk(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(path, tree)


def tree_shardings(tree: Any, mesh, *, zero1: bool = False) -> Any:
    """Shardings for a tree of tensors (real, meta or fake: only shapes
    are read) via the param rules — :func:`lm.param_tree` 's layout, or an
    AdamW state of it: one :class:`NamedSharding` per tensor, one list of
    per-layer shardings per stack."""
    def one(path, leaf):
        spec = param_spec(path, tuple(leaf.shape), mesh)
        if zero1:
            spec = zero1_spec(spec, tuple(leaf.shape), mesh)
        return NamedSharding(mesh, spec)

    def stack(path, layers):
        n = len(layers)
        out = []
        for i, leaf in enumerate(layers):
            shape = (n,) + tuple(leaf.shape)
            spec = (None,) + param_spec(path, tuple(leaf.shape), mesh)
            if zero1:
                spec = zero1_spec(spec, shape, mesh)
            out.append(NamedSharding(mesh, spec[1:], layer=(spec[0], i, n)))
        return out

    def walk(node, path):
        if isinstance(node, list):
            return stack(path, node)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, path + (f,))
                                for f, v in zip(node._fields, node)))
        if node is None:
            return None
        return one(path, node)

    return walk(tree, ())


def _meta(tree: Any) -> Any:
    return _walk(lambda _, t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _abstract(make: Callable) -> Any:
    """``make()`` traced on shape-only tensors (a ``FakeTensorMode``), as
    meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return _meta(make())


# ---------------------------------------------------------------------------
# abstract inputs per cell
# ---------------------------------------------------------------------------
def _batch_specs(cfg: ArchConfig, shape: Shape, mesh
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(meta batch, its shardings): the batch over the data axes."""
    dp = dp_axes(mesh)
    gb, s = shape.global_batch, shape.seq_len

    def leaf(shp, dtype):
        spec = (dp,) + (None,) * (len(shp) - 1)
        return (torch.empty(shp, dtype=dtype, device="meta"),
                NamedSharding(mesh, sanitize(spec, shp, mesh)))

    if cfg.family == "encdec":
        # enc side carries seq_len frames; dec side trains on seq_len//4 text
        dec = max(s // 4, 64)
        parts = {"frames": leaf((gb, s, cfg.d_model), torch.float32),
                 "tokens": leaf((gb, dec), torch.int32),
                 "labels": leaf((gb, dec), torch.int32)}
    else:
        parts = {"tokens": leaf((gb, s), torch.int32),
                 "labels": leaf((gb, s), torch.int32)}
    return ({k: v[0] for k, v in parts.items()},
            {k: v[1] for k, v in parts.items()})


def _abstract_params(cfg: ArchConfig, mesh) -> Tuple[Any, Any]:
    tree = _abstract(lambda: lm.param_tree(lm.init_params(
        torch.Generator().manual_seed(0), cfg)))
    return tree, tree_shardings(tree, mesh)


def _abstract_opt(cfg: ArchConfig, params_tree: Any, mesh
                  ) -> Tuple[Any, Any]:
    state = adamw(1e-4)[0](params_tree)
    return state, tree_shardings(state, mesh, zero1=True)


def _cache_spec_fn(cfg: ArchConfig, shape: Shape, mesh):
    """Spec rules for cache leaves (KV / SSM states), by leaf name.  The
    reference's cache classes flatten with index keys, so its rules see no
    leaf name and every cache leaf takes the last rule, ``(None, dp)``;
    :func:`_abstract_cache` passes no names either, to place as it does."""
    dp = dp_axes(mesh)

    def assign(path, leaf):
        names = tuple(p for p in path if isinstance(p, str))
        nm = names[-1] if names else ""
        shp = tuple(leaf.shape)
        if nm in ("k", "v"):            # [L, b, S, kv, hd]
            spec = (None, dp, None, MODEL, None)
            s = sanitize(spec, shp, mesh)
            if s[1] is None and len(shp) == 5:
                # batch unshardable (long_500k b=1): context-shard S instead
                s = sanitize((None, None, "data", MODEL, None), shp, mesh)
            return s
        if nm in ("cross_k", "cross_v"):
            return sanitize((None, dp, None, MODEL, None), shp, mesh)
        if nm == "ssm":                 # [L, b, nh, n, p]
            return sanitize((None, dp, MODEL, None, None), shp, mesh)
        if nm in ("conv_x",):           # [L, b, k-1, di]
            return sanitize((None, dp, None, MODEL), shp, mesh)
        if nm in ("conv_B", "conv_C"):
            return sanitize((None, dp, None, None), shp, mesh)
        return sanitize((None, dp), shp, mesh)

    return assign


def _abstract_cache(cfg: ArchConfig, shape: Shape, mesh, params_tree: Any
                    ) -> Tuple[Any, Any]:
    gb, s = shape.global_batch, shape.seq_len

    def make():
        params = None
        if cfg.family == "encdec":
            params = lm.params_from_tree(_walk(
                lambda _, t: torch.zeros(t.shape, dtype=t.dtype),
                params_tree))
        return lm.init_cache(cfg, gb, s, enc_frames=min(s, 4096)
                             if cfg.family == "encdec" else 0,
                             params=params, device="cpu")

    cache = _abstract(make)
    assign = _cache_spec_fn(cfg, shape, mesh)
    return cache, _walk(lambda _, leaf: NamedSharding(mesh, assign((), leaf)),
                        cache)


def abstract_inputs(cfg: ArchConfig, shape: Shape, mesh, *,
                    chunk: int = 128) -> Tuple[Tuple, Dict[str, Any]]:
    """Returns ``(args, info)``: ``args`` the cell's step inputs as meta
    tensors at their GLOBAL shapes (params as :func:`lm.param_tree`;
    :func:`lm.params_from_tree` makes the model of it), ``info["shardings"]``
    the tree of :class:`NamedSharding` s that places them, and
    ``info["out_shardings"]`` the placements of what the step returns."""
    params, params_sh = _abstract_params(cfg, mesh)
    if shape.kind == "train":
        opt, opt_sh = _abstract_opt(cfg, params, mesh)
        batch, batch_sh = _batch_specs(cfg, shape, mesh)
        return (params, opt, batch), {
            "shardings": (params_sh, opt_sh, batch_sh),
            "out_shardings": (params_sh, opt_sh, None)}
    if shape.kind == "prefill":
        batch, batch_sh = _batch_specs(cfg, shape, mesh)
        batch.pop("labels")
        batch_sh.pop("labels")
        return (params, batch), {"shardings": (params_sh, batch_sh),
                                 "out_shardings": None}
    if shape.kind == "decode":
        cache, cache_sh = _abstract_cache(cfg, shape, mesh, params)
        gb = shape.global_batch
        token = torch.empty((gb, 1), dtype=torch.int32, device="meta")
        pos = torch.empty((), dtype=torch.int32, device="meta")
        token_sh = NamedSharding(mesh, sanitize((dp_axes(mesh), None),
                                                (gb, 1), mesh))
        return (params, cache, token, pos), {
            "shardings": (params_sh, cache_sh, token_sh,
                          NamedSharding(mesh, ())),
            "out_shardings": (None, cache_sh)}
    raise ValueError(shape.kind)


def sp_spec_for(cfg: ArchConfig, shape: Shape, mesh) -> Optional[Spec]:
    """Sequence-parallel residual spec [b, s, d]: batch over DP, seq over
    model — dropped per-dim when not divisible."""
    dp = dp_axes(mesh)
    gb, s = shape.global_batch, shape.seq_len
    return sanitize((dp, MODEL, None), (gb, s, cfg.d_model), mesh)


def ep_spec_for(cfg: ArchConfig, shape: Shape, mesh) -> Optional[Spec]:
    """Expert-parallel pin for the [b, e, cap, ·] MoE intermediates."""
    if cfg.family != "moe":
        return None
    dp = dp_axes(mesh)
    return sanitize((dp, MODEL, None, None),
                    (shape.global_batch, cfg.moe_experts, 8, 8), mesh)


# ---------------------------------------------------------------------------
# the steps on a mesh
# ---------------------------------------------------------------------------
# each block of tp_plan and the leaves it runs on (a cross-attention
# clone ``x_*`` as its namesake; ``head`` is ``embed`` when the embeddings
# are tied; the expert stacks are told apart by their rank)
_BLOCKS: Dict[str, Tuple[str, ...]] = {
    "embed": ("embed",),
    "attn": ("wq", "wo"),
    "kv": ("wk", "wv"),
    "ffn": ("w_gate", "w_up", "w_down"),
    "mamba": ("w_z", "w_x", "w_dt", "conv_wx", "conv_bx", "dt_bias",
              "A_log", "D", "norm_g", "out_proj"),
    "experts": (),
    "head": ("lm_head",),
}


def _block_of(path, shape: Tuple[int, ...]) -> Optional[str]:
    """The :data:`_BLOCKS` block the leaf at ``path`` belongs to, or
    ``None`` for one that computes whole wherever it lives (the norms'
    gains, the router, Mamba2's ``B`` / ``C`` leaves)."""
    names = [p for p in path if isinstance(p, str)]
    if not names:
        return None
    name = names[-1][2:] if names[-1].startswith("x_") else names[-1]
    if name in _EXPERT_RULES and len(shape) == 3:
        return "experts"
    for block, leaves in _BLOCKS.items():
        if name in leaves:
            return block
    return None


def tp_plan(cfg: ArchConfig, mesh, *, ep_spec=None) -> Dict[str, str]:
    """Which of ``cfg``'s blocks compute split over ``mesh``'s ``model``
    axis (``"split"``) and which whole on every rank (``"whole"``), for
    the blocks the family has.  A block splits where the sanitizer keeps
    ``model`` on every leaf of it (:func:`param_spec`) and, on top of it,
    its heads split: attention where ``n_heads % W == 0``, its KV heads
    where also ``n_kv_heads % W == 0`` (else K and V compute whole and
    each rank keeps the heads its queries read), Mamba2 where
    ``ssm_heads % W == 0``.  The head is the embedding's block when the
    embeddings are tied.  The experts split under expert parallelism
    (``ep_spec``).  On one rank every block splits, trivially."""
    return _plan(cfg, mesh, _abstract_params(cfg, mesh)[0], ep_spec)


def _plan(cfg: ArchConfig, mesh, shapes, ep_spec) -> Dict[str, str]:
    """:func:`tp_plan` from the params' (meta) tree ``shapes``."""
    w = axis_size(mesh, MODEL) if MODEL in _names(mesh) else 1
    keeps: Dict[str, bool] = {}
    for path, leaf in zip(_paths(shapes), tree_leaves(shapes)):
        block = _block_of(path, tuple(leaf.shape))
        if block is None:
            continue
        spec = param_spec(path, tuple(leaf.shape), mesh)
        kept = any(MODEL in entry_axes(e) for e in spec)
        keeps[block] = keeps.get(block, True) and kept
    heads = {"attn": cfg.n_heads, "kv": cfg.n_kv_heads,
             "mamba": cfg.ssm_heads}
    plan = {}
    for block in _BLOCKS:
        if block == "head" and cfg.tie_embeddings:
            plan[block] = plan["embed"]
        elif block == "experts":
            if "experts" in keeps:
                plan[block] = SPLIT if ep_spec is not None \
                    and keeps[block] else WHOLE
        elif block in keeps:
            ok = keeps[block] and heads.get(block, w) % w == 0
            if block == "kv":
                ok = ok and plan.get("attn") == SPLIT
            plan[block] = SPLIT if ok else WHOLE
    return plan


def _compute_spec(path, shape: Tuple[int, ...], sh: NamedSharding,
                  plan: Dict[str, str]) -> Spec:
    """The placement a stored leaf of ``shape`` computes in: its stored
    ``model`` split where its block splits (an expert stack without its
    data shard), whole elsewhere."""
    block = _block_of(path, shape)
    if block is None or plan.get(block, WHOLE) == WHOLE:
        return ()
    if block == "experts":
        return (MODEL, None, None)
    return tuple(sh.spec)


class _Placed:
    """The placements of ``cfg``'s params and AdamW moments on ``mesh``
    (:func:`tree_shardings`, ``zero1`` for the moments), their global
    shapes, :func:`tp_plan`'s plan, the placement each leaf computes in,
    and the :class:`~repro_torch.distributed.tensor_parallel.Split` the
    layers compute under (``None`` without a ``model`` axis)."""

    def __init__(self, cfg: ArchConfig, mesh, ep_spec):
        self.shapes, self.params = _abstract_params(cfg, mesh)
        self.moments = tree_shardings(self.shapes, mesh, zero1=True)
        self.plan = _plan(cfg, mesh, self.shapes, ep_spec)
        self.compute = _rebuild(self.params, [
            NamedSharding(mesh, _compute_spec(path, tuple(leaf.shape), sh,
                                              self.plan))
            for path, leaf, sh in zip(_paths(self.shapes),
                                      tree_leaves(self.shapes),
                                      tree_leaves(self.params))])
        self.split = Split.over(mesh, self.plan) \
            if MODEL in _names(mesh) else None

    def check(self, tree, shardings, what: str) -> None:
        """Raise unless every local leaf of ``tree`` has the shape its
        sharding gives this rank."""
        for t, sh, shape in zip(tree_leaves(tree), tree_leaves(shardings),
                                tree_leaves(self.shapes)):
            want = sh.shard_shape(tuple(shape.shape))
            if tuple(t.shape) != want:
                raise ValueError(f"{what}: a leaf of {tuple(t.shape)} where "
                                 f"this rank's part of {tuple(shape.shape)} "
                                 f"under {sh.stacked_spec} is {want}")


def _paths(tree) -> list:
    out = []
    _walk(lambda path, _: out.append(path), tree)
    return out


def _rebuild(like, flat: list) -> Any:
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def _batch_rows(batch: Dict[str, torch.Tensor], mesh) -> Tuple[Any, Any]:
    """This rank's rows of a global batch by ``_batch_specs``' rule (the
    batch over the data axes, dropped where they do not divide it), and
    the rule's entry for the batch dimension."""
    gb = batch["tokens"].shape[0]
    entry = sanitize((dp_axes(mesh),), (gb,), mesh)[0]
    return {k: take(v, (), NamedSharding(mesh, (entry,)))
            for k, v in batch.items()}, entry


def _check_ep(cfg: ArchConfig, ep_spec, split, mesh) -> None:
    """A MoE step over data shards routes each shard on its own, so its
    aux loss is the mean of the shards' (the reference's ``moe_ffn_ep``):
    it takes an ``ep_spec`` naming the axes the batch lies over."""
    if cfg.family != "moe":
        return
    if ep_spec is None:
        if any(axis_size(mesh, a) > 1 for a in entry_axes(split)):
            raise ValueError(
                "a MoE model on a mesh with its batch over the data axes "
                "takes ep_spec=ep_spec_for(cfg, shape, mesh): its aux loss "
                "is the mean of the per-shard values")
        return
    if entry_axes(ep_spec[0]) != entry_axes(split):
        raise ValueError(f"ep_spec {ep_spec} routes over the data axes "
                         f"{entry_axes(ep_spec[0])}, the batch lies over "
                         f"{entry_axes(split)}")


def _data_sum(t: torch.Tensor, mesh, split) -> torch.Tensor:
    """``t`` summed over the data axes the batch lies over (in place
    where it is contiguous)."""
    import torch.distributed as dist

    if any(axis_size(mesh, ax) > 1 for ax in entry_axes(split)):
        t = t.contiguous()
    for ax in entry_axes(split):
        if axis_size(mesh, ax) > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM,
                            group=mesh.get_group(ax))
    return t


def _norm_reduce(shardings: list, mesh):
    """The ``reduce`` of :func:`clip_by_global_norm` for gradients placed
    by ``shardings``: each leaf's squared sum counted once per block (on
    the rank at coordinate 0 of every axis its placement does not name),
    then summed over every mesh axis."""
    import torch.distributed as dist

    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    keep = []
    for sh in shardings:
        named = set(entry_axes(sh.layer[0]) if sh.layer else ())
        for e in sh.spec:
            named.update(entry_axes(e))
        keep.append(all(c == 0 for a, c in coords.items()
                        if a not in named))

    def reduce(sq: torch.Tensor) -> torch.Tensor:
        if all(keep) and mesh.size() == 1:
            return sq
        sq = torch.where(torch.tensor(keep, device=sq.device), sq,
                         torch.zeros_like(sq))
        for ax in mesh.mesh_dim_names:
            if axis_size(mesh, ax) > 1:
                dist.all_reduce(sq, op=dist.ReduceOp.SUM,
                                group=mesh.get_group(ax))
        return sq

    return reduce


def _mesh_grads(cfg: ArchConfig, placed: _Placed, mesh, *, chunk: int,
                remat: bool, ep_spec) -> Callable:
    """``(local, batch) → (nll, aux, denom, grads, split)``: the forward
    and backward of a mesh step on this rank's rows of ``batch``, ``local``
    the params' tree placed by ``placed.params``.  Each leaf is gathered
    to its compute placement and the layers run under ``placed.split``;
    ``grads`` come in the compute placement, summed over the data axes
    the batch lies over (``split``, ``_batch_rows``' entry); ``nll`` is
    this rank's rows' NLL sum, ``denom`` the global token count."""
    def run(local, batch):
        rows, split = _batch_rows(batch, mesh)
        _check_ep(cfg, ep_spec, split, mesh)
        with torch.no_grad():
            full = gather_tree(local, placed.params, placed.compute)
        model = lm.params_from_tree(full)
        del full
        tree = lm.param_tree(model)
        with use_mesh(mesh), use_split(placed.split), torch.enable_grad():
            logits, aux = lm.forward(model, rows, cfg, chunk=chunk,
                                     remat=remat, ep_spec=ep_spec)
            nll = lm.nll_sum(logits, rows)
            del logits
            denom = lm.token_count(batch)
            loss = nll / denom + lm.AUX_COEF * aux
            grads = iter(torch.autograd.grad(loss, tree_leaves(tree)))
        del model, tree
        with torch.no_grad():
            grads = tree_map(lambda _: _data_sum(next(grads), mesh, split),
                             local)
        return nll.detach(), aux.detach(), denom, grads, split

    return run


def mesh_value_and_grad(cfg: ArchConfig, mesh, *, chunk: int = 64,
                        remat: bool = True, ep_spec=None) -> Callable:
    """``(params, batch) → (loss, grads)`` across the ranks of ``mesh``:
    the loss of :func:`mesh_train_step` (the reference's ``lm_loss`` over
    the global batch) and its gradient, each leaf in the params'
    :func:`tree_shardings` placement (``gather_global`` makes them
    whole): the reference's ``jax.value_and_grad(lm_loss)`` on a mesh."""
    placed = _Placed(cfg, mesh, ep_spec)
    run = _mesh_grads(cfg, placed, mesh, chunk=chunk, remat=remat,
                      ep_spec=ep_spec)

    def value_and_grad(params, batch):
        local = lm.param_tree(params)
        placed.check(local, placed.params, "params")
        nll, aux, denom, grads, split = run(local, batch)
        with torch.no_grad():
            loss = _data_sum(nll.clone(), mesh, split) / denom \
                + lm.AUX_COEF * aux
            return loss, take_tree(grads, placed.compute, placed.params)

    return value_and_grad


def mesh_train_step(cfg: ArchConfig, optimizer, mesh, *, clip: float = 1.0,
                    chunk: int = 64, remat: bool = True,
                    ep_spec=None) -> Callable:
    """:func:`lm.train_step_fn`'s step across the ranks of ``mesh``:
    ``(params, opt_state, batch) → (params, opt_state, metrics)``.

    ``params`` (the model, each leaf this rank's part under
    :func:`tree_shardings`) and ``opt_state`` (AdamW's, its moments under
    ``tree_shardings(..., zero1=True)``) come back in those placements;
    ``batch`` is the global batch, of which the rank takes its rows by
    ``_batch_specs``' rule.  Only the leaves whose block computes whole
    (:func:`tp_plan`) are gathered; the others compute in their stored
    ``model`` block.  The loss is the reference's over the global batch
    (each rank's rows over the global token count, plus the aux loss);
    each gradient, already this rank's part where its leaf computes
    split, is summed over the data axes and cut to the moments'
    placement, where the global-norm clip and the update run; the new
    params are gathered back to theirs.  At ``W > 1`` the split products
    sum over ``model`` in parts: the loss and params sit within rounding
    of the unsharded step's, not on its bits."""
    _, update = optimizer
    placed = _Placed(cfg, mesh, ep_spec)
    run = _mesh_grads(cfg, placed, mesh, chunk=chunk, remat=remat,
                      ep_spec=ep_spec)

    def step(params, opt_state, batch):
        local = lm.param_tree(params)
        placed.check(local, placed.params, "params")
        placed.check(opt_state.mu, placed.moments, "opt_state.mu")
        nll, aux, denom, grads, split = run(local, batch)
        with torch.no_grad():
            grads = take_tree(grads, placed.compute, placed.moments)
            grads, gnorm = clip_by_global_norm(
                grads, clip, reduce=_norm_reduce(
                    tree_leaves(placed.moments), mesh))
            p_z = take_tree(local, placed.params, placed.moments)
            updates, opt_state = update(grads, opt_state, p_z)
            del grads
            new = gather_tree(apply_updates(p_z, updates), placed.moments,
                              placed.params)
            del updates, p_z
            total = _data_sum(nll.clone(), mesh, split)
            metrics = {"loss": total / denom + lm.AUX_COEF * aux,
                       "grad_norm": gnorm}
        return lm.params_from_tree(new), opt_state, metrics

    return step


def mesh_prefill(cfg: ArchConfig, mesh, *, chunk: int = 64, ep_spec=None,
                 last_logits: bool = True) -> Callable:
    """:func:`lm.prefill_fn`'s prefill across the ranks of ``mesh``:
    ``(params, batch) → logits`` of this rank's rows of the global batch
    (``_batch_specs``' rule) over the whole vocab, ``params`` placed by
    :func:`tree_shardings`, the leaves of the blocks that compute whole
    gathered (:func:`tp_plan`), and a split head's vocab blocks gathered
    at the end (the reference's prefill returns its logits unplaced)."""
    placed = _Placed(cfg, mesh, ep_spec)

    def prefill(params, batch):
        local = lm.param_tree(params)
        placed.check(local, placed.params, "params")
        rows, split = _batch_rows(batch, mesh)
        _check_ep(cfg, ep_spec, split, mesh)
        with torch.no_grad(), use_mesh(mesh), use_split(placed.split):
            model = lm.params_from_tree(gather_tree(local, placed.params,
                                                    placed.compute))
            logits, _ = lm.forward(model, rows, cfg, chunk=chunk,
                                   ep_spec=ep_spec, last_logits=last_logits)
            return gather_vocab(logits, split_for("head"))

    return prefill


def build_step(cfg: ArchConfig, kind: str, *, chunk: int = 128,
               lr: float = 3e-4, remat: bool = True,
               ep_spec=None) -> Callable:
    """The step of ``kind`` for ``cfg``: ``"train"`` →
    ``(params, opt_state, batch) → (params, opt_state, metrics)`` with
    AdamW at ``lr`` (its state from ``adamw(lr)[0](lm.param_tree(params))``)
    and ``remat``; ``"prefill"`` → ``(params, batch) → last-position
    logits``; ``"decode"`` → ``(params, cache, token, pos) → (logits,
    cache)``.  ``ValueError`` on any other kind.  Under ``use_mesh(mesh)``
    the train and prefill steps run across the mesh's ranks
    (:func:`mesh_train_step`, :func:`mesh_prefill`; the MoE layers
    expert-parallel with ``ep_spec=ep_spec_for(cfg, shape, mesh)``), and
    decode raises (serving over a mesh is ROADMAP Queue 1 item 10.4)."""
    if kind not in KINDS:
        raise ValueError(f"build_step kind {kind!r} is none of {KINDS}")
    mesh = current_mesh()
    if mesh is not None:
        if kind == "train":
            return mesh_train_step(cfg, adamw(lr), mesh, chunk=chunk,
                                   remat=remat, ep_spec=ep_spec)
        if kind == "prefill":
            return mesh_prefill(cfg, mesh, chunk=chunk, ep_spec=ep_spec)
        raise NotImplementedError(
            "decode on a mesh: serving over a mesh is ROADMAP Queue 1 item "
            "10.4")
    if kind == "train":
        return lm.train_step_fn(cfg, adamw(lr), chunk=chunk, remat=remat,
                                ep_spec=ep_spec)
    if kind == "prefill":
        return lm.prefill_fn(cfg, chunk=chunk, ep_spec=ep_spec)
    return lm.decode_fn(cfg)
