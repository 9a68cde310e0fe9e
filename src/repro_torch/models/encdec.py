"""Encoder-decoder transformer — seamless-m4t-medium's text/speech backbone
(port of :mod:`repro.models.encdec`).

The modality frontend is a STUB, as in the reference: the encoder consumes
precomputed frame embeddings ``[b, s_enc, d]``; the decoder is a causal
transformer with per-layer cross-attention into the encoder memory.  Past
``FLASH_THRESHOLD`` keys the encoder's bidirectional self-attention and the
cross-attention (``sq`` decoder rows against ``sk`` frames, no mask) run
``flash_mha`` non-causal.

Decode: a self-attention KV cache per decoder layer + cross K/V computed
once from the encoder memory (:func:`prefill_cross`); they never change
during decode.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .transformer import (DenseLayer, KVCache, LayerParams, LMParams,
                          _logits, _norm_init, apply_rope, attend,
                          attend_auto, decode_attn_block, gqa_project,
                          init_attn_params, init_ffn_params, remat_call,
                          rmsnorm, stack_layers, swiglu, zero_gains)

DEC_LEAVES = ("wq", "wk", "wv", "wo", "x_wq", "x_wk", "x_wv", "x_wo",
              "w_gate", "w_up", "w_down", "ln_self", "ln_cross", "ln_ffn")


class DecLayer(LayerParams):
    """One decoder layer: self-attention ``wq``..``wo``, cross-attention
    ``x_wq``..``x_wo`` (queries from the decoder, keys and values from the
    encoder memory), the FFN, and ``ln_self`` / ``ln_cross`` / ``ln_ffn``."""

    LEAVES = DEC_LEAVES


class EncDecLM(LMParams):
    """``embed`` (tied head), ``enc_layers`` (:class:`DenseLayer` each),
    ``dec_layers`` (:class:`DecLayer` each), ``ln_enc`` and ``ln_final``."""


def init_enc_layer(gen: torch.Generator, cfg: ArchConfig,
                   dtype: torch.dtype = torch.bfloat16) -> DenseLayer:
    return DenseLayer({**init_attn_params(gen, cfg, dtype),
                       **init_ffn_params(gen, cfg, dtype),
                       **zero_gains(gen, cfg, dtype, "ln_attn", "ln_ffn")})


def init_dec_layer(gen: torch.Generator, cfg: ArchConfig,
                   dtype: torch.dtype = torch.bfloat16) -> DecLayer:
    self_attn = init_attn_params(gen, cfg, dtype)
    cross = init_attn_params(gen, cfg, dtype)
    return DecLayer({**self_attn,
                     **{f"x_{k}": v for k, v in cross.items()},
                     **init_ffn_params(gen, cfg, dtype),
                     **zero_gains(gen, cfg, dtype, "ln_self", "ln_cross",
                                  "ln_ffn")})


def init_encdec_params(gen: torch.Generator, cfg: ArchConfig,
                       dtype: torch.dtype = torch.bfloat16) -> EncDecLM:
    embed = _norm_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype)
    enc = stack_layers(cfg.enc_layers, lambda: init_enc_layer(gen, cfg,
                                                              dtype))
    dec = stack_layers(cfg.n_layers, lambda: init_dec_layer(gen, cfg, dtype))
    gains = zero_gains(gen, cfg, dtype, "ln_enc", "ln_final")
    return EncDecLM(embed=embed, enc_layers=enc, dec_layers=dec, **gains)


def _heads(x: torch.Tensor, w: torch.Tensor, n: int, hd: int
           ) -> torch.Tensor:
    """``x @ w`` as ``[b, s, n, hd]``."""
    return (x @ w).reshape(*x.shape[:2], n, hd)


def _enc_layer(h: torch.Tensor, p: DenseLayer, cfg: ArchConfig,
               positions: torch.Tensor) -> torch.Tensor:
    """One encoder layer (the reference's scan body)."""
    b, s, _ = h.shape
    q, k, v = gqa_project(rmsnorm(h, p.ln_attn, cfg.norm_eps), p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attend_auto(q, k, v, causal=False)
    h = h + o.reshape(b, s, cfg.n_heads * cfg.hd) @ p.wo
    return h + swiglu(rmsnorm(h, p.ln_ffn, cfg.norm_eps), p)


def encode(params: EncDecLM, frames: torch.Tensor, cfg: ArchConfig, *,
           remat: bool = False) -> torch.Tensor:
    """frames: [b, s_enc, d] precomputed embeddings (the stub frontend's
    output, cast to the weights' type).  Bidirectional self-attention with
    RoPE positions.  ``remat`` recomputes each layer in the backward."""
    h = frames.to(params.embed.dtype)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for p in params.enc_layers:
        h = remat_call(remat, _enc_layer, h, p, cfg, positions)
    return rmsnorm(h, params.ln_enc, cfg.norm_eps)


def _cross_attend(h: torch.Tensor, p: DecLayer, cfg: ArchConfig,
                  memory: torch.Tensor) -> torch.Tensor:
    """h: [b, s_dec, d] queries; memory: [b, s_enc, d]; no mask."""
    b, s, _ = h.shape
    q = _heads(h, p.x_wq, cfg.n_heads, cfg.hd)
    k = _heads(memory, p.x_wk, cfg.n_kv_heads, cfg.hd)
    v = _heads(memory, p.x_wv, cfg.n_kv_heads, cfg.hd)
    o = attend_auto(q, k, v, causal=False)
    return o.reshape(b, s, cfg.n_heads * cfg.hd) @ p.x_wo


def _dec_layer(h: torch.Tensor, p: DecLayer, cfg: ArchConfig,
               positions: torch.Tensor, memory: torch.Tensor
               ) -> torch.Tensor:
    """One decoder layer (the reference's scan body)."""
    b, s, _ = h.shape
    q, k, v = gqa_project(rmsnorm(h, p.ln_self, cfg.norm_eps), p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attend_auto(q, k, v, causal=True)
    h = h + o.reshape(b, s, cfg.n_heads * cfg.hd) @ p.wo
    h = h + _cross_attend(rmsnorm(h, p.ln_cross, cfg.norm_eps), p, cfg,
                          memory)
    return h + swiglu(rmsnorm(h, p.ln_ffn, cfg.norm_eps), p)


def decode_train(params: EncDecLM, memory: torch.Tensor,
                 tokens: torch.Tensor, cfg: ArchConfig, *,
                 remat: bool = False,
                 last_logits: bool = False) -> torch.Tensor:
    """Teacher-forced decoder: tokens [b, s_dec] → logits [b, s_dec,
    vocab] f32.  ``remat`` recomputes each layer in the backward."""
    h = F.embedding(tokens.long(), params.embed)
    positions = torch.arange(tokens.shape[1], device=h.device)[None, :]
    for p in params.dec_layers:
        h = remat_call(remat, _dec_layer, h, p, cfg, positions, memory)
    if last_logits:
        h = h[:, -1:]
    return _logits(params, h, cfg)


def encdec_forward(params: EncDecLM, frames: torch.Tensor,
                   tokens: torch.Tensor, cfg: ArchConfig, *,
                   remat: bool = False,
                   last_logits: bool = False) -> torch.Tensor:
    memory = encode(params, frames, cfg, remat=remat)
    return decode_train(params, memory, tokens, cfg, remat=remat,
                        last_logits=last_logits)


# ---------------------------------------------------------------------------
# decode with cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EncDecCache:
    self_kv: KVCache          # [L_dec, b, S_dec, kv, hd]
    cross_k: torch.Tensor     # [L_dec, b, S_enc, kv, hd]: precomputed
    cross_v: torch.Tensor


def prefill_cross(params: EncDecLM, memory: torch.Tensor, cfg: ArchConfig,
                  batch: int, max_dec: int,
                  dtype: torch.dtype = torch.bfloat16) -> EncDecCache:
    """Project the encoder memory through every decoder layer's cross K/V
    once (they are decode-invariant); the self-attention cache starts at
    zero on the memory's device."""
    ks, vs = [], []
    for p in params.dec_layers:
        ks.append(_heads(memory, p.x_wk, cfg.n_kv_heads, cfg.hd))
        vs.append(_heads(memory, p.x_wv, cfg.n_kv_heads, cfg.hd))
    return EncDecCache(
        self_kv=KVCache.zeros(cfg, batch, max_dec, dtype,
                              device=memory.device, n_layers=cfg.n_layers),
        cross_k=torch.stack(ks).to(dtype), cross_v=torch.stack(vs).to(dtype))


def encdec_decode_step(params: EncDecLM, cache: EncDecCache,
                       token: torch.Tensor, pos: int, cfg: ArchConfig
                       ) -> Tuple[torch.Tensor, EncDecCache]:
    h = F.embedding(token.long(), params.embed)
    b = h.shape[0]
    ks, vs = [], []
    for i, p in enumerate(params.dec_layers):
        att, kc, vc = decode_attn_block(
            rmsnorm(h, p.ln_self, cfg.norm_eps), p, cfg, cache.self_kv.k[i],
            cache.self_kv.v[i], pos, True)
        h = h + att
        ks.append(kc)
        vs.append(vc)
        # cross attention against the precomputed encoder K/V (no mask)
        q = _heads(rmsnorm(h, p.ln_cross, cfg.norm_eps), p.x_wq,
                   cfg.n_heads, cfg.hd)
        o = attend(q, cache.cross_k[i], cache.cross_v[i], None)
        h = h + o.reshape(b, 1, cfg.n_heads * cfg.hd) @ p.x_wo
        h = h + swiglu(rmsnorm(h, p.ln_ffn, cfg.norm_eps), p)
    return _logits(params, h, cfg), EncDecCache(
        self_kv=KVCache(k=torch.stack(ks), v=torch.stack(vs)),
        cross_k=cache.cross_k, cross_v=cache.cross_v)
