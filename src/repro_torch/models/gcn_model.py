"""The paper's models: 2-layer GCN and GraphSAGE-mean for node
classification (port of :mod:`repro.models.gcn_model`).

Each layer's execution order (CoAg/AgCo) is chosen by the sequence
estimator from the sampled-batch shape plan (paper §4.4), and the backward
runs the transpose-free "Ours" dataflow (the ``coo`` layer's written
backward) unless ``dataflow='naive'`` selects the Table-1 baseline.  Every
combination, SAGE's root path included, goes through the port's ``gemm``
kernel.

Weights are drawn from an explicit :class:`torch.Generator` on the CPU
and then moved, so a generator state gives the same weights on every
device.  ``jax.random`` streams cannot be reproduced without JAX: runs
that must match the reference start from its weights
(:func:`params_from_reference`) or from a reference-layout checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.baseline import gcn_layer_baseline
from repro_torch.core.estimator import LayerShape, choose_order
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.coo import COO
from repro_torch.kernels.gemm import gemm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str
    feat_dim: int
    hidden: int                     # paper §5.1: 256
    n_classes: int
    n_layers: int = 2               # paper trains 2-layer models
    model: str = "gcn"              # 'gcn' | 'sage'  (SAGE adds a root path)
    dataflow: str = "ours"          # 'ours' | 'naive' (Table-1 baseline)
    multilabel: bool = False
    engine: Optional[str] = None    # Engine spec for 'ours' layers, e.g.
    #                                 "coo+serial" (the default)


def init_params(seed: int, dims_io: Sequence[Tuple[int, int]],
                device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
    """The flat weight stack of the stacked-core Trainer and the serving
    engine (the reference's ``repro.distributed.gcn_train.init_params``):
    ``[{"w": [d_in, d_out] float32}, ...]``, output layer last, on
    ``device`` (``None`` → the card), ``N(0, 1) · d_in^-½`` per layer."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    return [{"w": (torch.randn((d_in, d_out), generator=gen)
                   * d_in ** -0.5).to(dev)}
            for d_in, d_out in dims_io]


def init_gcn_params(gen: torch.Generator, cfg: GCNConfig,
                    dtype=torch.float32, device: DeviceLike = None
                    ) -> Params:
    """``{"layers": [{"w": [d_in, d_out]}, ...]}`` (SAGE adds ``w_root``),
    ``N(0, 1) · d_in^-½``, input layer first, on ``device`` (``None`` →
    the card).  Every ``w`` is drawn before any ``w_root``, so one
    generator state gives a GCN and a SAGE model the same ``w`` (the
    reference's split keys give the same)."""
    dev = resolve_device(device)
    dims = [cfg.feat_dim] + [cfg.hidden] * (cfg.n_layers - 1) \
        + [cfg.n_classes]
    io = list(zip(dims[:-1], dims[1:]))

    def draw(d_in, d_out):
        return (torch.randn((d_in, d_out), generator=gen)
                * d_in ** -0.5).to(dtype=dtype, device=dev)

    layers = [{"w": draw(*shape)} for shape in io]
    if cfg.model == "sage":
        for layer, shape in zip(layers, io):
            layer["w_root"] = draw(*shape)
    return {"layers": layers}


def params_from_reference(params: Params, device: DeviceLike = None
                          ) -> Params:
    """The reference's ``{"layers": [{"w", "w_root"?: ndarray}]}`` as the
    port's tree of float32 tensors on ``device`` (``None`` → the card).
    Leaves may already be tensors; they are copied, never aliased."""
    dev = resolve_device(device)

    def put(v) -> torch.Tensor:
        if not isinstance(v, torch.Tensor):
            return torch.from_numpy(np.array(v, np.float32)).to(dev)
        return v.to(device=dev, dtype=torch.float32, copy=True)

    return {"layers": [{k: put(v) for k, v in layer.items()}
                       for layer in params["layers"]]}


def pick_orders(cfg: GCNConfig, shapes: Sequence[LayerShape]
                ) -> Tuple[str, ...]:
    """Sequence estimator, once per (dataset, sampler, model) at launch."""
    return tuple(choose_order(s, dataflow=cfg.dataflow).order
                 for s in shapes)


class _Combine(torch.autograd.Function):
    """``x @ w`` through the ``gemm`` kernel (SAGE's root path), with the
    matmul backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor):
        ctx.save_for_backward(x, w)
        return gemm(x.contiguous(), w.contiguous())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        return (g @ w.T if need_x else None, x.T @ g if need_w else None)


def gcn_forward(params: Params, layers: Sequence[COO], x: torch.Tensor,
                cfg: GCNConfig, orders: Sequence[str]) -> torch.Tensor:
    """layers[l] aggregates hop l+1 → hop l; x is the deepest hop's
    features, on the device the model runs on.  Iterate deepest-first
    (layers reversed), matching sampler.MiniBatch."""
    if cfg.dataflow == "ours":
        # one declarative entry point; the default spec is the serial COO
        # oracle (the paper's Table-1 "Ours")
        from repro_torch.engine import Engine
        engine = Engine(cfg.engine or "coo+serial")

        def layer_fn(A, h, w, **kw):
            return engine.layer(A, h, w, device=h.device, **kw)
    else:
        layer_fn = gcn_layer_baseline
    h = x
    n = len(params["layers"])
    for l in range(n - 1, -1, -1):
        A = layers[l]
        p = params["layers"][n - 1 - l]
        activate = l != 0                      # no ReLU on the logits layer
        out = layer_fn(A, h, p["w"], order=orders[l], activate=False)
        if cfg.model == "sage":
            # SAGE-mean: aggregate-neighbors path + root path
            out = out + _Combine.apply(h[:A.n_dst], p["w_root"])
        h = torch.relu(out) if activate else out
    return h


def _valid(b: int, n_valid: Optional[int], device) -> torch.Tensor:
    return torch.arange(b, device=device) < (n_valid if n_valid is not None
                                             else b)


def gcn_loss(params: Params, layers: Sequence[COO], x: torch.Tensor,
             labels: torch.Tensor, cfg: GCNConfig, orders: Sequence[str],
             n_valid: Optional[int] = None) -> torch.Tensor:
    """Softmax CE (single-label) or sigmoid BCE (multilabel: yelp/amazon).
    ``n_valid`` masks padded seed rows."""
    logits = gcn_forward(params, layers, x, cfg, orders)
    valid = _valid(logits.shape[0], n_valid, logits.device)
    z = logits.float()
    if cfg.multilabel:
        per = torch.relu(z) - z * labels + torch.log1p(torch.exp(-z.abs()))
        per = per.sum(-1)
    else:
        logp = torch.log_softmax(z, dim=-1)
        per = -logp.gather(-1, labels.long()[:, None])[:, 0]
    per = torch.where(valid, per, 0.0)
    return per.sum() / valid.sum().clamp(min=1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             n_valid: Optional[int] = None) -> torch.Tensor:
    valid = _valid(logits.shape[0], n_valid, logits.device)
    hit = (logits.argmax(-1) == labels) & valid
    return hit.sum() / valid.sum().clamp(min=1)
