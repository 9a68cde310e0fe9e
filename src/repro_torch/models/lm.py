"""Unified LM wrapper (port of :mod:`repro.models.lm`, the ``dense``
family).

``init_params`` / ``forward`` / ``lm_loss`` / ``train_step_fn`` /
``prefill_fn`` / ``init_cache`` / ``decode_fn`` dispatch on
``cfg.family`` as in the reference; the other families (moe, ssm, hybrid,
encdec) raise ``NotImplementedError`` naming their ROADMAP item.

Training takes its gradients from ``torch.autograd`` through the dense
forward (``prefill_fn`` and ``decode_fn`` wrap the same forward in
``no_grad``; the training step does not).  The optimizers see the model as
:func:`param_tree`, a tree in the reference's leaf order, and
:func:`params_to_reference` / :func:`params_from_reference` (and their
``opt_state`` counterparts for AdamW) convert to and from the reference's
stacked layout, which is also the checkpoint layout: either package resumes
the other's LM checkpoints.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.optimizers import (AdamWState, apply_updates,
                                          clip_by_global_norm, tree_leaves,
                                          tree_map)

from . import transformer as _dense
from .config import ArchConfig

Params = _dense.DenseLM


def _dense_only(cfg: ArchConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what} for the {cfg.family!r} family ({cfg.name}) is not "
            "ported yet: the port runs the dense family only (ROADMAP "
            "Queue 1 item 9: MoE / SSM / hybrid / encdec)")


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random weights from ``gen``, on ``gen``'s device (the reference's
    shapes and scales, not its random stream)."""
    _dense_only(cfg, "init_params")
    return _dense.init_dense_params(gen, cfg, dtype)


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, last_logits: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits f32, aux_loss scalar).  ``batch['embeddings']``
    substitutes the embedding lookup when present."""
    _dense_only(cfg, "forward")
    logits = _dense.dense_forward(params, batch["tokens"], cfg,
                                  embeddings=batch.get("embeddings"),
                                  last_logits=last_logits)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, aux_coef: float = 0.01, chunk: int = 64) -> torch.Tensor:
    """Next-token cross-entropy (labels = tokens shifted by the pipeline).

    ``chunk`` is the SSM families' scan chunk, accepted for the reference's
    signature.  With autograd on, a sequence longer than
    ``FLASH_THRESHOLD`` raises: it would reach ``flash_mha``, which has no
    backward (the reference differentiates its XLA scan there)."""
    _dense_only(cfg, "lm_loss")
    if torch.is_grad_enabled() \
            and batch["tokens"].shape[1] > _dense.FLASH_THRESHOLD:
        raise NotImplementedError(
            f"training past FLASH_THRESHOLD ({_dense.FLASH_THRESHOLD} keys) "
            "would run flash_mha, which has no backward (ROADMAP Queue 1 "
            "item 9)")
    logits, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    mask = batch.get("mask")
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = nll.numel()
    return nll.sum() / denom + aux_coef * aux


def train_step_fn(cfg: ArchConfig, optimizer, *, clip: float = 1.0,
                  chunk: int = 64) -> Callable:
    """The training step ``(params, opt_state, batch) → (params, opt_state,
    {"loss", "grad_norm"})``: loss → autograd gradients of every leaf of
    :func:`param_tree` → global-norm clip → ``optimizer``'s update →
    new params (a new module; the given one is left untouched).
    ``optimizer`` is an ``(init_fn, update_fn)`` pair from
    :mod:`repro_torch.optim`, initialized on :func:`param_tree`."""
    _dense_only(cfg, "train_step_fn")
    _, update = optimizer

    def step(params: Params, opt_state, batch: Dict[str, torch.Tensor]):
        tree = param_tree(params)
        with torch.enable_grad():
            loss = lm_loss(params, batch, cfg, chunk=chunk)
            grads = iter(torch.autograd.grad(loss, tree_leaves(tree)))
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(
                tree_map(lambda _: next(grads), tree), clip)
            updates, opt_state = update(grads, opt_state, tree)
            del grads
            new = params_from_tree(apply_updates(tree, updates))
        return new, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def prefill_fn(cfg: ArchConfig, *, last_logits: bool = True) -> Callable:
    """Serving prefill: by default only the LAST position's logits are
    computed (generation needs one row).  Runs without autograd."""
    _dense_only(cfg, "prefill_fn")

    def prefill(params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = forward(params, batch, cfg, last_logits=last_logits)
        return logits

    return prefill


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, *,
               device: DeviceLike = None) -> _dense.KVCache:
    """A zero KV cache on ``device`` (``None`` → the card)."""
    _dense_only(cfg, "init_cache")
    return _dense.KVCache.zeros(cfg, batch, max_seq, dtype,
                                device=resolve_device(device))


def decode_fn(cfg: ArchConfig) -> Callable:
    """One-token serve step ``(params, cache, token [b, 1], pos) →
    (logits [b, 1, vocab] f32, new cache)``, without autograd."""
    _dense_only(cfg, "decode_fn")

    def step(params: Params, cache: _dense.KVCache, token: torch.Tensor,
             pos: int) -> Tuple[torch.Tensor, _dense.KVCache]:
        with torch.no_grad():
            return _dense.dense_decode_step(params, cache, token, int(pos),
                                            cfg)

    return step


def param_tree(params: Params) -> Dict[str, Any]:
    """The module's parameters as a tree in the reference's leaf order:
    dict keys sorted (``embed``, ``layers``, ``lm_head`` when untied,
    ``ln_final``), ``layers`` a dict of the sorted leaf names, each a list
    of the per-layer tensors (the reference's stacked ``[L, ...]`` leaf,
    layer by layer).  The tensors are the module's own."""
    tree: Dict[str, Any] = {"embed": params.embed, "layers": {
        name: [getattr(layer, name) for layer in params.layers]
        for name in sorted(_dense.LAYER_LEAVES)}}
    if params.lm_head is not None:
        tree["lm_head"] = params.lm_head
    tree["ln_final"] = params.ln_final
    return tree


def params_from_tree(tree: Mapping[str, Any]) -> Params:
    """A :func:`param_tree`-shaped tree of tensors as the port's modules
    (the tensors are wrapped, not copied)."""
    layers = tree["layers"]
    n = len(layers["wq"])
    mods = [_dense.DenseLayer({name: layers[name][i]
                               for name in _dense.LAYER_LEAVES})
            for i in range(n)]
    return _dense.DenseLM(tree["embed"], mods, tree["ln_final"],
                          tree.get("lm_head"))


def _tree_from_reference(tree: Mapping[str, Any], cfg: ArchConfig,
                         dev: torch.device) -> Dict[str, Any]:
    """A reference-layout tree (stacked ``layers`` leaves) as a
    :func:`param_tree`-shaped tree of tensors on ``dev``."""
    def tensor(a) -> torch.Tensor:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":      # ml_dtypes: exact via f32
            return torch.from_numpy(arr.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(arr, copy=True)).to(dev)

    layers = tree["layers"]
    n = int(np.shape(layers["wq"])[0])
    if n != cfg.n_layers:
        raise ValueError(f"the tree has {n} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    out: Dict[str, Any] = {"embed": tensor(tree["embed"]), "layers": {}}
    for name in sorted(_dense.LAYER_LEAVES):
        stacked = np.asarray(layers[name])
        out["layers"][name] = [tensor(stacked[i]) for i in range(n)]
    if tree.get("lm_head") is not None:
        out["lm_head"] = tensor(tree["lm_head"])
    out["ln_final"] = tensor(tree["ln_final"])
    return out


def _tree_to_reference(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A :func:`param_tree`-shaped tree as the reference's layout: host
    numpy leaves, each ``layers`` list stacked ``[L, ...]``."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    out: Dict[str, Any] = {"embed": host(tree["embed"]), "layers": {
        name: np.stack([host(t) for t in leaves])
        for name, leaves in tree["layers"].items()}}
    if tree.get("lm_head") is not None:
        out["lm_head"] = host(tree["lm_head"])
    out["ln_final"] = host(tree["ln_final"])
    return out


def params_from_reference(tree: Mapping[str, Any], cfg: ArchConfig,
                          device: DeviceLike = None) -> Params:
    """The reference's dense param tree (numpy arrays, or anything
    ``np.asarray`` takes: ``embed``, ``layers`` with every leaf stacked
    ``[L, ...]``, ``ln_final``, optional ``lm_head``) as the port's
    modules on ``device`` (``None`` → the card), value for value in the
    same ``x @ w`` layout and type."""
    _dense_only(cfg, "params_from_reference")
    return params_from_tree(_tree_from_reference(tree, cfg,
                                                 resolve_device(device)))


def params_to_reference(params: Params) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_reference`: the reference's tree
    of host numpy arrays."""
    return _tree_to_reference(param_tree(params))


def opt_state_from_reference(state: Any, cfg: ArchConfig,
                             device: DeviceLike = None) -> AdamWState:
    """The reference's ``AdamWState`` (``mu``, ``nu``, ``step``: numpy, or
    anything ``np.asarray`` takes) as the port's, its moments
    :func:`param_tree`-shaped on ``device`` and its step an int32
    tensor."""
    _dense_only(cfg, "opt_state_from_reference")
    dev = resolve_device(device)
    return AdamWState(mu=_tree_from_reference(state.mu, cfg, dev),
                      nu=_tree_from_reference(state.nu, cfg, dev),
                      step=torch.tensor(int(np.asarray(state.step)),
                                        dtype=torch.int32, device=dev))


def opt_state_to_reference(state: AdamWState) -> AdamWState:
    """The port's AdamW state in the reference's layout: moments as
    reference trees of numpy arrays, the step an int32 numpy scalar."""
    return AdamWState(mu=_tree_to_reference(state.mu),
                      nu=_tree_to_reference(state.nu),
                      step=state.step.detach().cpu().numpy())
