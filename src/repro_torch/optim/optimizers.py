"""Optimizers — functional, over trees of tensors (port of
:mod:`repro.optim.optimizers`).

The paper's training uses SGD (Eq. 4: W ← W − η∇L), here with momentum as
the reference's GCN loop runs it; the LM trainer uses AdamW with global-norm
clipping and, optionally, the cosine schedule.  AdamW's moments are f32
whatever the params' type, and its step an int32 tensor.  A tree is a tensor, or a dict, list or
tuple (named tuples included) of trees; states are trees too, so they
checkpoint exactly like params.  Every update keeps the reference's order
of operations, each rounded in float32: ``m = μ·m + g``, ``upd = −lr·m``,
``p + upd``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Union

import torch

OptState = Any
Params = Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):                   # a named tuple
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


class SGDState(NamedTuple):
    momentum: Any          # tree like params (float32), or () if momentum == 0
    step: torch.Tensor     # int32 scalar


def sgd(lr: float, momentum: float = 0.0):
    """Paper Eq. 4.  Returns ``(init_fn, update_fn)``."""

    def init(params) -> SGDState:
        mom = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device),
                       params) if momentum else ()
        device = tree_leaves(params)[0].device
        return SGDState(momentum=mom,
                        step=torch.zeros((), dtype=torch.int32,
                                         device=device))

    def update(grads, state: SGDState, params):
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.float(),
                           state.momentum, grads)
            upd = tree_map(lambda m: -lr * m, mom)
        else:
            mom = ()
            upd = tree_map(lambda g: -lr * g.float(), grads)
        return upd, SGDState(momentum=mom, step=state.step + 1)

    return init, update


class AdamWState(NamedTuple):
    mu: Any                # first moment, tree like params (float32)
    nu: Any                # second moment (float32)
    step: torch.Tensor     # int32 scalar


def _f32_like(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def adamw(lr: Union[Callable[[torch.Tensor], torch.Tensor], float],
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0):
    """AdamW; ``lr`` may be a schedule of the step (an int32 tensor).
    Returns ``(init_fn, update_fn)``."""

    def init(params) -> AdamWState:
        device = tree_leaves(params)[0].device
        return AdamWState(mu=_f32_like(params), nu=_f32_like(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=device))

    def update(grads, state: AdamWState, params):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        stepf = step.to(torch.float32)
        c1 = 1 - b1 ** stepf
        c2 = 1 - b2 ** stepf

        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        upd = tree_map(
            lambda m, v, p: -lr_t * ((m / c1) / (torch.sqrt(v / c2) + eps)
                                     + weight_decay * p.float()),
            mu, nu, params)
        return upd, AdamWState(mu=mu, nu=nu, step=step)

    return init, update


def clip_by_global_norm(grads, max_norm: float, *, reduce=None):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``;
    returns ``(clipped, norm)``.  The squares are summed leaf by leaf in
    tree order, as the reference sums them.  ``reduce`` (for gradients
    spread over ranks) maps the leaves' squared sums, one tensor, to their
    sums over the ranks."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    if reduce is not None:
        sq = list(reduce(torch.stack(sq)).unbind(0))
    total = 0
    for s in sq:
        total = total + s
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then cosine decay
    to ``floor_frac · peak`` at ``total``; a function of the step tensor."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak * (floor_frac + (1 - floor_frac)
                      * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)
