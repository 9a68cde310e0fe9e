"""Sequence estimator (paper §4.4, Table 1; port of
:mod:`repro.core.estimator`) — choose AgCo vs CoAg per layer.

In mini-batch training the layer adjacency A ∈ R^{n × n̄} is rectangular
(n = destination nodes of this hop, n̄ = sampled frontier), so aggregating
first can *shrink* the feature matrix exactly like combining first — the
optimal order depends on the dataset and the sampling hyper-parameters.
The system controller evaluates the full-training-step complexity of both
orders before launching and configures the pipeline accordingly.

Complexities follow Table 1 (per layer, per mini-batch):

                 forward            backward           gradient     transpose
  Ours CoAg   n̄dh + eh          eh + n̄dh           n̄dh          hd (+bc once)
  Ours AgCo   ed  + ndh          ndh + ed            ndh          hd (+bc once)

with storage  CoAg: n̄d + n̄h + e | n̄h + nh   /  AgCo: n̄d + nd + e | nd + nh.
The naive variants add the Table-1 transpose rows (Aᵀ, Wᵀ, Xᵀ or (AX)ᵀ)
on top of the same loss-error transpose ``b·c``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Tuple

Order = Literal["coag", "agco"]


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """Static per-layer quantities the estimator reads from the batch plan.

    b:     mini-batch size (seed nodes; only used for the one-off E^L transpose)
    n:     destination nodes of this hop  (rows of A)
    nbar:  source nodes / sampled frontier (cols of A)
    d:     input feature dim
    h:     output feature dim
    e:     nnz of A
    c:     classes (loss width; top layer only)
    """

    b: int
    n: int
    nbar: int
    d: int
    h: int
    e: int
    c: int = 0


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    order: Order
    time: float
    storage: float


def time_ours(s: LayerShape, order: Order) -> float:
    if order == "coag":
        fwd = s.nbar * s.d * s.h + s.e * s.h
        bwd = s.e * s.h + s.nbar * s.d * s.h
        grad = s.nbar * s.d * s.h
    else:
        fwd = s.e * s.d + s.n * s.d * s.h
        bwd = s.n * s.d * s.h + s.e * s.d
        grad = s.n * s.d * s.h
    transpose = s.h * s.d + s.b * s.c      # Wᵀ + (E^L)ᵀ (loss layer only)
    return float(fwd + bwd + grad + transpose)


def time_naive(s: LayerShape, order: Order) -> float:
    """Table-1 CoAg/AgCo rows (baseline dataflow with big transposes).

    The reference (``src/repro/core/estimator.py:70-77``) subtracts the
    ``b·c`` loss-error transpose from ``time_ours`` and never adds it back,
    so it prices naive below ours whenever ``b·c > n̄·(e + d)``.  Here the
    naive dataflow pays it too.  The same constant goes on both orders, so
    :func:`choose_order` picks what the reference picks for every shape;
    only the price differs, by exactly ``b·c``."""
    base = time_ours(s, order) - (s.h * s.d + s.b * s.c)
    if order == "coag":
        transpose = s.nbar * s.e + s.h * s.d + s.nbar * s.d   # Aᵀ, Wᵀ, Xᵀ
    else:
        transpose = s.nbar * s.e + s.h * s.d + s.n * s.d      # Aᵀ, Wᵀ, (AX)ᵀ
    return float(base + transpose + s.b * s.c)               # + (E^L)ᵀ


def storage_ours(s: LayerShape, order: Order) -> float:
    if order == "coag":
        return float(s.nbar * s.d + s.nbar * s.h + s.e + s.nbar * s.h + s.n * s.h)
    return float(s.nbar * s.d + s.n * s.d + s.e + s.n * s.d + s.n * s.h)


def storage_naive(s: LayerShape, order: Order) -> float:
    extra = s.e + (s.nbar * s.d if order == "coag" else s.n * s.d)
    return storage_ours(s, order) + float(extra)


def choose_order(s: LayerShape, dataflow: str = "ours") -> CostEstimate:
    """The estimator: evaluate both orders, return the cheaper (time first,
    storage as tie-break) — run once per (dataset, sampler, model) config at
    launch, like the paper's register-configured system controller."""
    tfn = time_ours if dataflow == "ours" else time_naive
    sfn = storage_ours if dataflow == "ours" else storage_naive
    cands = [CostEstimate(o, tfn(s, o), sfn(s, o)) for o in ("coag", "agco")]
    cands.sort(key=lambda ce: (ce.time, ce.storage))
    return cands[0]


def layer_shapes_for_batch(batch_size: int, fanouts, feat_dim: int,
                           hidden: int, n_classes: int, avg_degree: float
                           ) -> Tuple[LayerShape, ...]:
    """Build the per-layer LayerShape plan for a sampled mini-batch, using
    expected frontier sizes (what the controller knows before sampling)."""
    n = batch_size
    hops = [batch_size]
    for f in fanouts:
        n = int(n * (min(f, avg_degree) + 1))
        hops.append(n)
    # layer l aggregates hop l+1 -> hop l ; features flow top(input)->bottom
    shapes = []
    in_dim = feat_dim
    for l in range(len(fanouts) - 1, -1, -1):
        out_dim = n_classes if l == 0 else hidden
        e = int(hops[l] * (min(fanouts[l], avg_degree) + 1))
        shapes.append(LayerShape(b=batch_size, n=hops[l], nbar=hops[l + 1],
                                 d=in_dim, h=out_dim, e=e, c=n_classes))
        in_dim = out_dim
    return tuple(reversed(shapes))  # index by layer depth (0 = closest to output)
