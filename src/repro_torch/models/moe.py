"""Mixture-of-Experts FFN — token-choice top-k with capacity dispatch (port
of :mod:`repro.models.moe`).

Serves llama4-maverick (128e top-1, dense/moe interleaved pairs) and
moonshot-v1 (64e top-6, all-moe).  Per sample, each token's top-k experts
(the first k of a stable descending sort of the router's probabilities:
``jax.lax.top_k``'s order, the lower expert first on a tie) take its
hidden state into an ``[e, cap, d]`` buffer at its position in the
expert's queue; slots past the capacity ``cap`` drop, as in the reference.
The three expert products are batched matmuls over the experts, and the
gated combine gathers each kept slot back.

The reference scatter-adds every slot into the buffer, the dropped ones as
zeros at position ``cap - 1``.  Kept slots have unique (expert, position)
pairs, so the port writes them with a plain index put and sends the
dropped ones to a spare position ``cap`` that is cut off: the same values,
with no accumulating (atomic) scatter and no host sync.

:func:`moe_ffn_ep` is the expert-parallel layer over the current mesh's
``model`` axis: each rank runs its block of the experts on the tokens
routed to them, and one fold over ``model`` sums the partial outputs.
"""
from __future__ import annotations

import types
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.tensor_parallel import replicate

from .config import ArchConfig
from .transformer import (KVCache, LayerParams, LMParams, _logits,
                          _norm_init, attn_block, decode_attn_block,
                          dense_block, embed_tokens, init_attn_params,
                          init_dense_layer, remat_call, rmsnorm,
                          stack_layers, swiglu, upcast, zero_gains)

MOE_LEAVES = ("wq", "wk", "wv", "wo", "router", "w_gate", "w_up", "w_down",
              "ln_attn", "ln_ffn")


class MoELayer(LayerParams):
    """One MoE layer: the attention leaves of a dense layer, ``router [d,
    e]`` (f32 whatever the model's type), the experts' ``w_gate`` /
    ``w_up [e, d, f]`` and ``w_down [e, f, d]``, and the two norm gains."""

    LEAVES = MOE_LEAVES


class MoeLM(LMParams):
    """``embed``, ``moe_layers`` (:class:`MoELayer` each), with
    ``moe_interleave`` 2 also ``dense_layers`` (the dense half of each
    pair), ``ln_final`` and ``lm_head`` (``None`` when tied)."""


def init_moe_params(gen: torch.Generator, cfg: ArchConfig,
                    dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    return {
        "router": _norm_init(gen, (d, e), d ** -0.5, torch.float32),
        "w_gate": _norm_init(gen, (e, d, f), d ** -0.5, dtype),
        "w_up": _norm_init(gen, (e, d, f), d ** -0.5, dtype),
        "w_down": _norm_init(gen, (e, f, d), f ** -0.5, dtype),
    }


def capacity(n_tokens: int, n_experts: int, topk: int,
             factor: float = 1.25) -> int:
    """Per-expert buffer rows: the reference's formula, kept exactly
    (padded to 8, at least 8)."""
    c = int(factor * n_tokens * topk / n_experts)
    return max(8, ((c + 7) // 8) * 8)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of the last axis and their indices, largest first,
    the lower index first among equals (``jax.lax.top_k``'s order):
    the first ``k`` of a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, p: MoELayer, cfg: ArchConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router + top-k + the Switch aux loss.  x: [b, s, d] → (gates [b, s,
    k] f32, expert ids [b, s, k] int64, aux scalar)."""
    b, s, _ = x.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    logits = upcast(x) @ p.router
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean((0, 1))
    ce = _counts(eidx.reshape(-1), e).float() / (b * s * k)
    return gates, eidx, e * torch.sum(me * ce)


def _counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=e)`` for ids in ``[0, e)``, with an
    output shape that does not depend on the ids' values (a shape-only
    trace cannot read them)."""
    return torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.int64))


def _one_hot(ids: torch.Tensor, e: int) -> torch.Tensor:
    """``F.one_hot(ids, e)`` without its range check, which reads the ids'
    values."""
    return (ids[..., None] == torch.arange(e, device=ids.device)).long()


def _positions(eidx_flat: torch.Tensor, e: int, cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity plan: each routed slot's position in its expert's queue
    (``[..., s·k]``, in slot order), clipped to ``cap - 1`` where it
    drops, and whether it is kept."""
    eidx_flat = eidx_flat.long()
    onehot = _one_hot(eidx_flat, e)
    pos = torch.gather(torch.cumsum(onehot, -2) - 1, -1,
                       eidx_flat[..., None])[..., 0]
    keep = pos < cap
    return torch.where(keep, pos, cap - 1), keep


def moe_ffn(x: torch.Tensor, p: MoELayer, cfg: ArchConfig,
            capacity_factor: float = 1.25, ep_spec=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [b, s, d] → (y [b, s, d], aux_loss scalar), per-sample dispatch
    as the reference's single-device path; with an ``ep_spec``, the
    expert-parallel :func:`moe_ffn_ep`."""
    if ep_spec is not None:
        return moe_ffn_ep(x, p, cfg, capacity_factor, ep_spec)
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    gates, eidx, aux = _route(x, p, cfg)
    cap = capacity(s, e, k, capacity_factor)
    flat_e = eidx.reshape(b, s * k)
    safe_pos, keep = _positions(flat_e, e, cap)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    xk = x.repeat_interleave(k, dim=1)                     # [b, s·k, d]
    # kept slots land at unique (expert, position); dropped ones at the
    # spare position cap, cut off below
    buf = x.new_zeros((b, e, cap + 1, d)).index_put(
        (rows, flat_e, torch.where(keep, safe_pos, cap)), xk)[:, :, :cap]
    gate_h = F.silu(torch.einsum("becd,edf->becf", buf, p.w_gate))
    up_h = torch.einsum("becd,edf->becf", buf, p.w_up)
    out = torch.einsum("becf,efd->becd", gate_h * up_h, p.w_down)
    got = torch.where(keep[..., None], out[rows, flat_e, safe_pos], 0)
    y = (got * gates.reshape(b, s * k, 1).to(got.dtype)
         ).reshape(b, s, k, d).sum(2)
    return y, aux


class _Fold(torch.autograd.Function):
    """Megatron's g: the partial outputs of every rank of ``group`` summed
    forward — one ``reduce_scatter`` over the sequence and one
    ``all_gather`` back (the reference's ``psum_scatter`` onto its
    sequence-sharded residual, with the port's residual whole on every
    rank) — and the gradient passed on unchanged backward (every rank
    holds the same ``dy``)."""

    @staticmethod
    def forward(ctx, y, group, size):
        import torch.distributed as dist

        full = y.transpose(0, 1).contiguous()              # [s, b, d]
        part = full.new_empty((full.shape[0] // size,) + full.shape[1:])
        dist.reduce_scatter_tensor(part, full, op=dist.ReduceOp.SUM,
                                   group=group)
        dist.all_gather_into_tensor(full, part, group=group)
        return full.transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AuxMean(torch.autograd.Function):
    """The aux loss as the reference's: the mean over the data shards of
    each shard's value (the ``model`` ranks of a shard hold the same),
    summed over the data ``groups`` forward; backward each rank's share
    of the gradient, ``1 / (dp · W)``, since the router's gradient is then
    summed over ``model`` and the data axes."""

    @staticmethod
    def forward(ctx, aux, groups, dp, w):
        import torch.distributed as dist

        ctx.share = dp * w
        if dp > 1:
            aux = aux.clone()
            for group in groups:
                dist.all_reduce(aux, op=dist.ReduceOp.SUM, group=group)
            return aux / dp
        return aux.view_as(aux)

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.share if ctx.share > 1 else g), None, None, None


def moe_ffn_ep(x: torch.Tensor, p: MoELayer, cfg: ArchConfig,
               capacity_factor: float, ep_spec
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the current mesh's ``model`` axis (port of
    the reference's ``shard_map`` message passing), on this rank's part:
    ``x`` [b_l, s, d] this rank's data shard (the same on every ``model``
    rank), ``p.router`` whole and the expert stacks this rank's block
    ``[e / W, ...]`` of the ``W`` ``model`` ranks → (y [b_l, s, d], the
    same on every ``model`` rank; aux: the mean over the data shards of
    each shard's aux loss, over the data axes ``ep_spec[0]`` names).

    Every rank routes the whole sequence identically (the same
    ``_route``, the GLOBAL capacity and ``_positions``), scatters into its
    ``[b_l, e / W, cap, d]`` buffer only the slots bound for its own
    experts (expert ids ``[j·e/W, (j+1)·e/W)`` on rank ``j``), runs them,
    combines its gated slots and folds the partial outputs over
    ``model`` with one reduce-scatter and one all-gather of the ``[b_l,
    s, d]`` activation: the wire does not depend on top-k.  Backward,
    the gradients of ``x`` and the router are summed over ``model``.
    ``ValueError`` without a current mesh, or where ``W`` divides neither
    the experts nor the sequence (the reference's ``shard_map`` refuses
    the same shapes)."""
    from repro_torch.distributed.sharding import (MODEL, axis_size,
                                                  current_mesh, entry_axes)

    mesh = current_mesh()
    if mesh is None:
        raise ValueError("moe_ffn_ep needs a current mesh with a 'model' "
                         "axis: call it inside "
                         "repro_torch.distributed.sharding.use_mesh(mesh)")
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    w = axis_size(mesh, MODEL)
    if e % w or s % w:
        raise ValueError(f"moe_ffn_ep: {w} 'model' ranks divide neither "
                         f"{e} experts and {s} tokens evenly")
    e_local = e // w
    if p.w_gate.shape[0] != e_local:
        raise ValueError(f"moe_ffn_ep takes this rank's {e_local} of {e} "
                         f"experts, got {p.w_gate.shape[0]}")
    group = mesh.get_group(MODEL)
    data = [a for a in entry_axes(ep_spec[0]) if axis_size(mesh, a) > 1]
    dp = 1
    for a in data:
        dp *= axis_size(mesh, a)
    cap = capacity(s, e, k, capacity_factor)
    x = replicate(x, group, w)
    router = replicate(p.router, group, w)
    gates, eidx, aux = _route(x, types.SimpleNamespace(router=router), cfg)
    flat_e = eidx.reshape(b, s * k)
    safe_pos, keep = _positions(flat_e, e, cap)            # GLOBAL capacity
    lo = mesh.get_local_rank(MODEL) * e_local
    mine = (flat_e >= lo) & (flat_e < lo + e_local)
    keep_l = keep & mine
    fe_l = torch.where(mine, flat_e - lo, 0)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    xk = x.repeat_interleave(k, dim=1)                     # [b, s·k, d]
    buf = x.new_zeros((b, e_local, cap + 1, d)).index_put(
        (rows, fe_l, torch.where(keep_l, safe_pos, cap)), xk)[:, :, :cap]
    gate_h = F.silu(torch.einsum("becd,edf->becf", buf, p.w_gate))
    up_h = torch.einsum("becd,edf->becf", buf, p.w_up)
    out = torch.einsum("becf,efd->becd", gate_h * up_h, p.w_down)
    got = torch.where(keep_l[..., None], out[rows, fe_l, safe_pos], 0)
    y = (got * gates.reshape(b, s * k, 1).to(got.dtype)
         ).reshape(b, s, k, d).sum(2)
    y = _Fold.apply(y, group, w)
    aux = _AuxMean.apply(aux, [mesh.get_group(a) for a in data], dp, w)
    return y, aux


def drop_fraction(x: torch.Tensor, p: MoELayer, cfg: ArchConfig,
                  capacity_factor: float = 1.25) -> float:
    """The share of routed (token, expert) slots that :func:`moe_ffn`
    drops on ``x`` [b, s, d] at ``capacity_factor``."""
    b, s, _ = x.shape
    _, eidx, _ = _route(x, p, cfg)
    cap = capacity(s, cfg.moe_experts, cfg.moe_topk, capacity_factor)
    _, keep = _positions(eidx.reshape(b, -1), cfg.moe_experts, cap)
    return float(1.0 - keep.float().mean())


# ---------------------------------------------------------------------------
# MoE decoder stacks
# ---------------------------------------------------------------------------
def init_moe_layer(gen: torch.Generator, cfg: ArchConfig,
                   dtype: torch.dtype = torch.bfloat16) -> MoELayer:
    return MoELayer({**init_attn_params(gen, cfg, dtype),
                     **init_moe_params(gen, cfg, dtype),
                     **zero_gains(gen, cfg, dtype, "ln_attn", "ln_ffn")})


def init_moe_stack_params(gen: torch.Generator, cfg: ArchConfig,
                          dtype: torch.dtype = torch.bfloat16) -> MoeLM:
    """llama4 style (interleave 2): (dense, moe) pairs; moonshot style
    (interleave 1): moe layers only."""
    parts: Dict[str, object] = {
        "embed": _norm_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype)}
    if cfg.moe_interleave == 2:
        n_pairs = cfg.n_layers // 2
        parts["dense_layers"] = stack_layers(
            n_pairs, lambda: init_dense_layer(gen, cfg, dtype))
        parts["moe_layers"] = stack_layers(
            n_pairs, lambda: init_moe_layer(gen, cfg, dtype))
    else:
        parts["moe_layers"] = stack_layers(
            cfg.n_layers, lambda: init_moe_layer(gen, cfg, dtype))
    parts["lm_head"] = None if cfg.tie_embeddings else _norm_init(
        gen, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5, dtype)
    parts["ln_final"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=gen.device)
    return MoeLM(**parts)


def _moe_block(x: torch.Tensor, p: MoELayer, cfg: ArchConfig,
               w_eff: Optional[int], positions: torch.Tensor,
               cf: float = 1.25, ep_spec=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = x + attn_block(rmsnorm(x, p.ln_attn, cfg.norm_eps), p, cfg, w_eff,
                       positions)
    y, aux = moe_ffn(rmsnorm(h, p.ln_ffn, cfg.norm_eps), p, cfg,
                     capacity_factor=cf, ep_spec=ep_spec)
    return h + y, aux


def _pair_block(x: torch.Tensor, pd: Optional[LayerParams], pm: MoELayer,
                cfg: ArchConfig, positions: torch.Tensor, cf: float, ep_spec
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the stack (the reference's scan body): the dense layer
    of an interleaved pair, if any, then the MoE layer."""
    if pd is not None:
        x = dense_block(x, pd, cfg, None, positions)
    return _moe_block(x, pm, cfg, None, positions, cf, ep_spec)


def _pairs(params: MoeLM, cfg: ArchConfig) -> List[Tuple]:
    """The stack in order: ``(dense layer or None, moe layer)``."""
    if cfg.moe_interleave == 2:
        return list(zip(params.dense_layers, params.moe_layers))
    return [(None, p) for p in params.moe_layers]


def moe_forward(params: MoeLM, tokens: torch.Tensor, cfg: ArchConfig, *,
                embeddings: Optional[torch.Tensor] = None,
                capacity_factor: float = 1.25, remat: bool = False,
                ep_spec=None, last_logits: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits [b, s, vocab] f32, aux_loss scalar: the layers' sum over
    ``cfg.n_layers``, as the reference divides it).  ``remat`` recomputes
    each step of the stack (a pair when interleaved) in the backward."""
    s = tokens.shape[1]
    x = embeddings if embeddings is not None \
        else embed_tokens(tokens, params.embed)
    positions = torch.arange(s, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pd, pm in _pairs(params, cfg):
        x, a = remat_call(remat, _pair_block, x, pd, pm, cfg, positions,
                          capacity_factor, ep_spec)
        aux = aux + a
    if last_logits:
        x = x[:, -1:]
    return _logits(params, x, cfg), aux / cfg.n_layers


def moe_decode_step(params: MoeLM, cache: KVCache, token: torch.Tensor,
                    pos: int, cfg: ArchConfig, capacity_factor: float = 1.25
                    ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode; the cache spans ALL attention layers in stack
    order (interleave 2: ``cache[2i]`` the dense layer of pair ``i``,
    ``cache[2i + 1]`` its moe layer)."""
    h = F.embedding(token.long(), params.embed)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []

    def attn_then(h, p):
        i = len(ks)
        att, kc, vc = decode_attn_block(rmsnorm(h, p.ln_attn, cfg.norm_eps),
                                        p, cfg, cache.k[i], cache.v[i], pos,
                                        True)
        ks.append(kc)
        vs.append(vc)
        return h + att

    for pd, pm in _pairs(params, cfg):
        if pd is not None:
            h = attn_then(h, pd)
            h = h + swiglu(rmsnorm(h, pd.ln_ffn, cfg.norm_eps), pd)
        h = attn_then(h, pm)
        y, _ = moe_ffn(rmsnorm(h, pm.ln_ffn, cfg.norm_eps), pm, cfg,
                       capacity_factor=capacity_factor)
        h = h + y
    return _logits(params, h, cfg), KVCache(k=torch.stack(ks),
                                            v=torch.stack(vs))

