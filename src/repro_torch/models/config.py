"""Architecture config — one dataclass describes every assigned arch (the
port's copy of :mod:`repro.models.config`; every family runs in the
port).

``family`` selects the block pattern:
  dense   — decoder-only transformer (stablelm, llama3.2, yi, gemma3,
            chameleon: early-fusion VLM = dense LM over a fused vocab)
  moe     — decoder-only with MoE FFN layers (llama4-maverick: dense/moe
            interleaved pairs; moonshot: all-moe)
  ssm     — Mamba2 / SSD stack (attention-free)
  hybrid  — zamba2: mamba2 backbone + ONE shared attention block re-applied
            every ``attn_every`` layers
  encdec  — seamless-m4t: bidirectional encoder over precomputed frame
            embeddings (stub frontend) + causal decoder w/ cross-attention

All stacks are homogeneous *by construction* (the reference runs layers
under ``lax.scan`` with stacked params; the port loops over an
``nn.ModuleList``): heterogeneity is expressed as per-layer
FLAG VECTORS (gemma3's 5-local:1-global mask pattern, zamba2's shared-attn
schedule) or as scanned PAIRS (llama4's dense+moe interleave) — in the
reference this keeps HLO size O(1) in depth.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # --- attention pattern ---
    sliding_window: Optional[int] = None    # local-attention window
    global_every: int = 0                   # gemma3: layer i is global iff (i+1) % k == 0
    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 0
    moe_interleave: int = 1                 # 2 ⇒ scan (dense, moe) pairs
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0                     # zamba2 shared block period
    # --- enc-dec ---
    enc_layers: int = 0
    # --- common ---
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    modality_stub: Optional[str] = None     # 'audio' | 'vision' frontend note

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def scaled(self, *, n_layers: Optional[int] = None, d_model: Optional[int] = None,
               n_heads: Optional[int] = None, n_kv_heads: Optional[int] = None,
               d_ff: Optional[int] = None, vocab: Optional[int] = None,
               moe_experts: Optional[int] = None, head_dim: Optional[int] = None,
               enc_layers: Optional[int] = None, ssm_head_dim: Optional[int] = None,
               moe_topk: Optional[int] = None,
               ) -> "ArchConfig":
        """Reduced-config variant for CPU smoke tests (same family/pattern)."""
        return dataclasses.replace(
            self,
            n_layers=n_layers or self.n_layers,
            d_model=d_model or self.d_model,
            n_heads=n_heads or self.n_heads,
            n_kv_heads=n_kv_heads or self.n_kv_heads,
            d_ff=d_ff or self.d_ff,
            vocab=vocab or self.vocab,
            moe_experts=moe_experts if moe_experts is not None else self.moe_experts,
            moe_topk=moe_topk if moe_topk is not None else self.moe_topk,
            head_dim=head_dim if head_dim is not None else self.head_dim,
            enc_layers=enc_layers if enc_layers is not None else self.enc_layers,
            ssm_head_dim=ssm_head_dim or self.ssm_head_dim,
        )

    # --- analytic parameter/FLOP counts (roofline MODEL_FLOPS = 6·N·D) -----
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = self.moe_experts * 3 * d * self.d_ff
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, n = self.d_inner, self.ssm_state
            # in_proj (z,x,B,C,dt) + conv + out_proj (+ heads' A, D, dt_bias)
            ssm = d * (2 * di + 2 * n + self.ssm_heads) \
                + self.ssm_conv * (di + 2 * n) + di * d + 3 * self.ssm_heads
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "dense":
            per_layer = attn + dense_ffn
            total = self.n_layers * per_layer
        elif self.family == "moe":
            n_moe = self.n_layers // self.moe_interleave
            n_dense = self.n_layers - n_moe
            total = self.n_layers * attn + n_dense * dense_ffn \
                + n_moe * (moe_ffn + d * self.moe_experts)
        elif self.family == "ssm":
            total = self.n_layers * ssm
        elif self.family == "hybrid":
            n_attn_apps = 0 if not self.attn_every else 1  # ONE shared block
            total = self.n_layers * ssm + n_attn_apps * (attn + dense_ffn)
        elif self.family == "encdec":
            enc = self.enc_layers * (attn + dense_ffn)
            dec = self.n_layers * (2 * attn + dense_ffn)   # self + cross
            total = enc + dec
        else:
            raise ValueError(self.family)
        return total + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of E experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        n_moe = self.n_layers // self.moe_interleave
        inactive = n_moe * (self.moe_experts - self.moe_topk) * 3 * d * self.d_ff
        return full - inactive
