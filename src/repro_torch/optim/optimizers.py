"""Optimizers — functional, over trees of tensors (port of the SGD half of
:mod:`repro.optim.optimizers`).

The paper's training uses SGD (Eq. 4: W ← W − η∇L), here with momentum as
the reference's GCN loop runs it.  A tree is a tensor, or a dict, list or
tuple (named tuples included) of trees; states are trees too, so they
checkpoint exactly like params.  Every update keeps the reference's order
of operations, each rounded in float32: ``m = μ·m + g``, ``upd = −lr·m``,
``p + upd``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

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


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)
