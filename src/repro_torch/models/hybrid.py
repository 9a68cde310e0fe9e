"""Zamba2-style hybrid — Mamba2 backbone + ONE shared attention block (port
of :mod:`repro.models.hybrid`).

zamba2-1.2b: 38 Mamba2 layers (d_model 2048, ssm_state 64); a single
transformer block (32H, kv 32, d_ff 8192) whose weights are SHARED is
applied after every ``attn_every`` layers: ``n_seg = L // attn_every``
segments of (``attn_every`` mamba layers → shared block), then the
remainder mamba layers (38 = 6 × 6 + 2).

Decode state = a :class:`MambaCache` over all mamba layers + a KV cache with
one slot per shared-block *application* (same weights, different
activations: each application has its own keys and values).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .mamba2 import (MambaCache, init_mamba_layer, mamba_residual,
                     mamba_decode_layers, stacked_cache)
from .transformer import (DenseLayer, KVCache, LMParams, _logits, _norm_init,
                          attn_block, decode_attn_block, embed_tokens,
                          init_dense_layer, remat_call, rmsnorm, stack_layers,
                          swiglu)


class HybridLM(LMParams):
    """``embed`` (tied head), ``mamba_layers`` (:class:`MambaLayer` each),
    ``shared`` (one :class:`DenseLayer`) and ``ln_final``."""


def _seg_counts(cfg: ArchConfig) -> Tuple[int, int, int]:
    seg = cfg.attn_every
    n_seg = cfg.n_layers // seg
    return seg, n_seg, cfg.n_layers - n_seg * seg


def init_hybrid_params(gen: torch.Generator, cfg: ArchConfig,
                       dtype: torch.dtype = torch.bfloat16) -> HybridLM:
    embed = _norm_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype)
    layers = stack_layers(cfg.n_layers,
                          lambda: init_mamba_layer(gen, cfg, dtype))
    return HybridLM(embed=embed, mamba_layers=layers,
                    shared=init_dense_layer(gen, cfg, dtype),
                    ln_final=torch.zeros((cfg.d_model,), dtype=dtype,
                                         device=gen.device))


def _shared_block(h: torch.Tensor, p: DenseLayer, cfg: ArchConfig,
                  w_eff: Optional[int], positions: torch.Tensor
                  ) -> torch.Tensor:
    h = h + attn_block(rmsnorm(h, p.ln_attn, cfg.norm_eps), p, cfg, w_eff,
                       positions)
    return h + swiglu(rmsnorm(h, p.ln_ffn, cfg.norm_eps), p)


def hybrid_forward(params: HybridLM, tokens: torch.Tensor, cfg: ArchConfig,
                   *, chunk: int = 64,
                   embeddings: Optional[torch.Tensor] = None,
                   remat: bool = False,
                   last_logits: bool = False) -> torch.Tensor:
    """``remat`` recomputes each Mamba2 layer in the backward (the shared
    block is kept, as the reference checkpoints only its Mamba body)."""
    s = tokens.shape[1]
    x = embeddings if embeddings is not None \
        else embed_tokens(tokens, params.embed)
    positions = torch.arange(s, device=x.device)[None, :]
    seg, n_seg, _ = _seg_counts(cfg)
    for i, p in enumerate(params.mamba_layers):
        x = remat_call(remat, mamba_residual, x, p, cfg, chunk)
        if i < n_seg * seg and (i + 1) % seg == 0:
            x = _shared_block(x, params.shared, cfg, None, positions)
    if last_logits:
        x = x[:, -1:]
    return _logits(params, x, cfg)


@dataclasses.dataclass(frozen=True)
class HybridCache:
    mamba: MambaCache      # over all n_layers mamba blocks
    attn: KVCache          # [n_seg, b, S, kv, hd]: one slot per application

    @classmethod
    def zeros(cls, cfg: ArchConfig, batch: int, max_seq: int,
              dtype: torch.dtype = torch.bfloat16, device=None
              ) -> "HybridCache":
        _, n_seg, _ = _seg_counts(cfg)
        return cls(mamba=MambaCache.zeros(cfg, batch, device=device),
                   attn=KVCache.zeros(cfg, batch, max_seq, dtype,
                                      device=device, n_layers=n_seg))


def hybrid_decode_step(params: HybridLM, cache: HybridCache,
                       token: torch.Tensor, pos: int, cfg: ArchConfig
                       ) -> Tuple[torch.Tensor, HybridCache]:
    h = F.embedding(token.long(), params.embed)
    seg, n_seg, rem = _seg_counts(cfg)
    shared = params.shared
    layers = list(params.mamba_layers)
    new: Dict[str, list] = {"conv_x": [], "conv_B": [], "conv_C": [],
                            "ssm": []}
    ks, vs = [], []
    for a in range(n_seg):
        lo = a * seg
        h = mamba_decode_layers(h, layers[lo:lo + seg], cfg,
                                cache.mamba.slice_layers(lo, lo + seg), new)
        att, kc, vc = decode_attn_block(
            rmsnorm(h, shared.ln_attn, cfg.norm_eps), shared, cfg,
            cache.attn.k[a], cache.attn.v[a], pos, True)
        h = h + att
        h = h + swiglu(rmsnorm(h, shared.ln_ffn, cfg.norm_eps), shared)
        ks.append(kc)
        vs.append(vc)
    if rem:
        lo = n_seg * seg
        h = mamba_decode_layers(h, layers[lo:], cfg,
                                cache.mamba.slice_layers(lo, cfg.n_layers),
                                new)
    return _logits(params, h, cfg), HybridCache(
        mamba=stacked_cache(new),
        attn=KVCache(k=torch.stack(ks), v=torch.stack(vs)))
