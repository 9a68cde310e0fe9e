"""Unified LM wrapper (port of :mod:`repro.models.lm`, the ``dense``
family).

``init_params`` / ``forward`` / ``prefill_fn`` / ``init_cache`` /
``decode_fn`` dispatch on ``cfg.family`` as in the reference; the other
families (moe, ssm, hybrid, encdec) raise ``NotImplementedError`` naming
their ROADMAP item, and ``lm_loss`` / ``train_step_fn`` belong to the LM
training slice, not ported yet.  ``params_from_reference`` carries the
reference's dense param tree over exactly.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

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


def params_from_reference(tree: Mapping[str, Any], cfg: ArchConfig,
                          device: DeviceLike = None) -> Params:
    """The reference's dense param tree (numpy arrays, or anything
    ``np.asarray`` takes: ``embed``, ``layers`` with every leaf stacked
    ``[L, ...]``, ``ln_final``, optional ``lm_head``) as the port's
    modules on ``device`` (``None`` → the card), value for value in the
    same ``x @ w`` layout and type."""
    _dense_only(cfg, "params_from_reference")
    dev = resolve_device(device)

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
    stacked = {name: np.asarray(layers[name])
               for name in _dense.LAYER_LEAVES}
    mods = [_dense.DenseLayer({name: tensor(stacked[name][i])
                               for name in _dense.LAYER_LEAVES})
            for i in range(n)]
    head: Optional[Any] = tree.get("lm_head")
    return _dense.DenseLM(tensor(tree["embed"]), mods,
                          tensor(tree["ln_final"]),
                          None if head is None else tensor(head))
