"""Mamba2 / SSD (state-space duality) blocks — mamba2-1.3b and the zamba2
backbone (port of :mod:`repro.models.mamba2`).

Per block:  z/x/B/C/dt projections (split, as the reference's);  causal
depthwise conv (width 4) on x, B, C;  SSD over (x·dt, A, B, C);  gated
RMSNorm by silu(z);  out_proj.  A is scalar-per-head, dt softplus-positive.
No Pallas kernel is involved in the reference; the port's SSD is plain
torch.

The chunked SSD (:func:`ssd_scan`) computes each chunk's quadratic
(attention-like) form and its state contribution for all chunks at once,
and loops over the chunks only to carry the ``[b, heads, state, head_dim]``
state, where the reference scans every step of a chunk.  Decode is the
O(1) single-token recurrence on the same state (:func:`ssd_step`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .transformer import (LayerParams, LMParams, _logits, _norm_init,
                          remat_call, rmsnorm, stack_layers)

MAMBA_LEAVES = ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_wx", "conv_bx",
                "conv_wB", "conv_bB", "conv_wC", "conv_bC", "dt_bias",
                "A_log", "D", "norm_g", "out_proj", "ln")


class MambaLayer(LayerParams):
    """One Mamba2 block: projections ``w_z`` / ``w_x [d, di]``, ``w_B`` /
    ``w_C [d, n]``, ``w_dt [d, nh]``; the convs' ``conv_w* [k, ch]`` and
    ``conv_b* [ch]``, ``dt_bias``, ``A_log`` and ``D [nh]`` (all f32);
    ``norm_g [di]``, ``out_proj [di, d]`` and the pre-norm gain ``ln``."""

    LEAVES = MAMBA_LEAVES


class SsmLM(LMParams):
    """``embed`` (tied head), ``layers`` (:class:`MambaLayer` each) and
    ``ln_final``."""


# ---------------------------------------------------------------------------
# causal depthwise conv (width k): train form + streaming decode form
# ---------------------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """x: [b, l, ch]; w: [k, ch]; causal depthwise conv + silu."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + l, :] * w[i] for i in range(k))
    return F.silu(out + b)


def conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: [b, ch]; conv_state: [b, k-1, ch] (previous inputs, oldest
    first).  Returns (y_t [b, ch], new conv_state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # [b, k, ch]
    y = torch.einsum("bkc,kc->bc", window, w)
    return F.silu(y + b), window[:, 1:, :]


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------
def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 64, h_init: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [b, l, nh, p]; dt: [b, l, nh] (f32, >0); A: [nh] (f32, <0);
    B, C: [b, l, n] (one group, broadcast over heads); D: [nh].

    Returns (y [b, l, nh, p] in x's type, final state [b, nh, n, p] f32).
    The sums run in f32 (float64 for float64 inputs).

    Within a chunk, the decay between steps i >= j is exp(cum_i - cum_j).
    The reference takes exp of the difference for every (i, j) and zeroes
    the pairs above the diagonal after it; there cum_i - cum_j > 0 can
    overflow to inf (dt·A summed over a chunk), which leaves the forward
    intact but makes the backward 0·inf = NaN.  Here the difference is
    masked to -inf above the diagonal before the exp: exp(-inf) = 0, equal
    to the reference wherever the reference is finite.
    """
    b, l, nh, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"seq len {l} not divisible by chunk {chunk}")
    c = l // chunk
    # f32 state and sums (float64 inputs keep float64: a yardstick)
    f32 = torch.float64 if x.dtype == torch.float64 else torch.float32
    xs = x.to(f32).reshape(b, c, chunk, nh, p)
    dts = dt.to(f32).reshape(b, c, chunk, nh)
    Bs = B.to(f32).reshape(b, c, chunk, n)
    Cs = C.to(f32).reshape(b, c, chunk, n)
    cum = torch.cumsum(dts * A, dim=2)                       # [b,c,Q,nh]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    # --- intra-chunk (diagonal block), every chunk at once
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b,c,i,j,nh]
    Lmat = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", Cs, Bs)
    w = scores[..., None] * Lmat * dts[:, :, None, :, :]     # [b,c,i,j,nh]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xs)
    # --- each chunk's state contribution and decay
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)           # [b,c,Q,nh]
    S = torch.einsum("bcjn,bcjhp->bchnp", Bs,
                     (dts * decay_out)[..., None] * xs)
    decay = torch.exp(cum[:, :, -1, :])                      # [b,c,nh]
    # --- carry the state over the chunks: H_c enters chunk c
    H = h_init.to(f32) if h_init is not None \
        else torch.zeros((b, nh, n, p), dtype=f32, device=x.device)
    states = []
    for ci in range(c):
        states.append(H)
        H = decay[:, ci, :, None, None] * H + S[:, ci]
    Hs = torch.stack(states, dim=1)                          # [b,c,nh,n,p]
    y = y + torch.einsum("bcin,bchnp->bcihp", Cs, Hs) \
        * torch.exp(cum)[..., None]
    y = y.reshape(b, l, nh, p) + D[None, None, :, None] * x.to(f32)
    return y.to(x.dtype), H


def ssd_step(H: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor,
             D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence.  H: [b, nh, n, p]; x_t: [b, nh, p];
    dt_t: [b, nh]; B_t, C_t: [b, n].  Returns (new H, y_t [b, nh, p])."""
    xf = x_t.float()
    decay = torch.exp(dt_t * A)                                  # [b, nh]
    S = torch.einsum("bn,bh,bhp->bhnp", B_t.float(), dt_t, xf)
    H = decay[:, :, None, None] * H + S
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), H) + D[None, :, None] * xf
    return H, y.to(x_t.dtype)


# ---------------------------------------------------------------------------
# the Mamba2 block (split projections)
# ---------------------------------------------------------------------------
def init_mamba_layer(gen: torch.Generator, cfg: ArchConfig,
                     dtype: torch.dtype = torch.bfloat16) -> MambaLayer:
    """The reference's shapes, scales and types (A = -exp(0) = -1, D = 1,
    zero biases and gains)."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, k = cfg.ssm_heads, cfg.ssm_conv
    s = d ** -0.5
    f32 = torch.float32
    dev = gen.device

    def const(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=dev)

    return MambaLayer({
        "w_z": _norm_init(gen, (d, di), s, dtype),
        "w_x": _norm_init(gen, (d, di), s, dtype),
        "w_B": _norm_init(gen, (d, n), s, dtype),
        "w_C": _norm_init(gen, (d, n), s, dtype),
        "w_dt": _norm_init(gen, (d, nh), s, dtype),
        "conv_wx": _norm_init(gen, (k, di), k ** -0.5, f32),
        "conv_bx": const((di,), 0.0, f32),
        "conv_wB": _norm_init(gen, (k, n), k ** -0.5, f32),
        "conv_bB": const((n,), 0.0, f32),
        "conv_wC": _norm_init(gen, (k, n), k ** -0.5, f32),
        "conv_bC": const((n,), 0.0, f32),
        "dt_bias": const((nh,), 0.0, f32),
        "A_log": const((nh,), 0.0, f32),
        "D": const((nh,), 1.0, f32),
        "norm_g": const((di,), 0.0, dtype),
        "out_proj": _norm_init(gen, (di, d), di ** -0.5, dtype),
        "ln": const((d,), 0.0, dtype),
    })


def _in_proj(h: torch.Tensor, p: MambaLayer):
    return h @ p.w_z, h @ p.w_x, h @ p.w_B, h @ p.w_C, h @ p.w_dt


def _gated_out(y: torch.Tensor, z: torch.Tensor, p: MambaLayer,
               cfg: ArchConfig) -> torch.Tensor:
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p.norm_g, cfg.norm_eps)
    return y @ p.out_proj


def mamba_block(x: torch.Tensor, p: MambaLayer, cfg: ArchConfig, *,
                chunk: int = 64) -> torch.Tensor:
    """Full-sequence Mamba2 block (pre-norm residual applied by caller)."""
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    b, l, _ = x.shape
    z, xin, B, C, dt = _in_proj(rmsnorm(x, p.ln, cfg.norm_eps), p)
    xin = causal_conv(xin.float(), p.conv_wx, p.conv_bx)
    B = causal_conv(B.float(), p.conv_wB, p.conv_bB)
    C = causal_conv(C.float(), p.conv_wC, p.conv_bC)
    xs = xin.reshape(b, l, nh, hp).to(x.dtype)
    dt = F.softplus(dt.float() + p.dt_bias)
    y, _ = ssd_scan(xs, dt, -torch.exp(p.A_log), B, C, p.D, chunk=chunk)
    return _gated_out(y.reshape(b, l, di), z, p, cfg)


def mamba_decode_block(x_t: torch.Tensor, p: MambaLayer, cfg: ArchConfig,
                       conv_x: torch.Tensor, conv_B: torch.Tensor,
                       conv_C: torch.Tensor, ssm_state: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """x_t: [b, 1, d] one token.  Returns (out, conv_x', conv_B', conv_C',
    ssm')."""
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, B, C, dt = _in_proj(rmsnorm(x_t, p.ln, cfg.norm_eps)[:, 0], p)
    xin, conv_x = conv_step(xin.float(), conv_x, p.conv_wx, p.conv_bx)
    B, conv_B = conv_step(B.float(), conv_B, p.conv_wB, p.conv_bB)
    C, conv_C = conv_step(C.float(), conv_C, p.conv_wC, p.conv_bC)
    xs = xin.reshape(-1, nh, hp).to(x_t.dtype)
    dt = F.softplus(dt.float() + p.dt_bias)
    ssm_state, y = ssd_step(ssm_state, xs, dt, -torch.exp(p.A_log), B, C,
                            p.D)
    out = _gated_out(y.reshape(-1, di), z, p, cfg)
    return out[:, None, :], conv_x, conv_B, conv_C, ssm_state


# ---------------------------------------------------------------------------
# pure-SSM stack (mamba2-1.3b)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MambaCache:
    conv_x: torch.Tensor   # [L, b, k-1, di] f32
    conv_B: torch.Tensor   # [L, b, k-1, n] f32
    conv_C: torch.Tensor   # [L, b, k-1, n] f32
    ssm: torch.Tensor      # [L, b, nh, n, p] f32

    @classmethod
    def zeros(cls, cfg: ArchConfig, batch: int,
              n_layers: Optional[int] = None, device=None) -> "MambaCache":
        L = n_layers or cfg.n_layers
        k1 = cfg.ssm_conv - 1
        kw = dict(dtype=torch.float32, device=device)
        return cls(
            conv_x=torch.zeros((L, batch, k1, cfg.d_inner), **kw),
            conv_B=torch.zeros((L, batch, k1, cfg.ssm_state), **kw),
            conv_C=torch.zeros((L, batch, k1, cfg.ssm_state), **kw),
            ssm=torch.zeros((L, batch, cfg.ssm_heads, cfg.ssm_state,
                             cfg.ssm_head_dim), **kw))

    def slice_layers(self, lo: int, hi: int) -> "MambaCache":
        return MambaCache(conv_x=self.conv_x[lo:hi],
                          conv_B=self.conv_B[lo:hi],
                          conv_C=self.conv_C[lo:hi], ssm=self.ssm[lo:hi])


def init_ssm_params(gen: torch.Generator, cfg: ArchConfig,
                    dtype: torch.dtype = torch.bfloat16) -> SsmLM:
    embed = _norm_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype)
    layers = stack_layers(cfg.n_layers,
                          lambda: init_mamba_layer(gen, cfg, dtype))
    return SsmLM(embed=embed, layers=layers, ln_final=torch.zeros(
        (cfg.d_model,), dtype=dtype, device=gen.device))


def mamba_residual(x: torch.Tensor, p: MambaLayer, cfg: ArchConfig,
                   chunk: int) -> torch.Tensor:
    """One residual Mamba2 layer (the reference's scan body)."""
    return x + mamba_block(x, p, cfg, chunk=chunk)


def ssm_forward(params: SsmLM, tokens: torch.Tensor, cfg: ArchConfig, *,
                chunk: int = 64, embeddings: Optional[torch.Tensor] = None,
                remat: bool = False,
                last_logits: bool = False) -> torch.Tensor:
    """``remat`` recomputes each layer in the backward."""
    x = embeddings if embeddings is not None \
        else F.embedding(tokens.long(), params.embed)
    for p in params.layers:
        x = remat_call(remat, mamba_residual, x, p, cfg, chunk)
    if last_logits:
        x = x[:, -1:]
    return _logits(params, x, cfg)


def mamba_decode_layers(h: torch.Tensor, layers, cfg: ArchConfig,
                        cache: MambaCache, new: Dict[str, list]
                        ) -> torch.Tensor:
    """``h`` through ``layers`` (each a residual Mamba2 block, one token),
    layer ``i`` reading ``cache``'s row ``i``; each layer's new state is
    appended to ``new``'s lists (``conv_x``, ``conv_B``, ``conv_C``,
    ``ssm``)."""
    for i, p in enumerate(layers):
        out, cx, cb, cc, ss = mamba_decode_block(
            h, p, cfg, cache.conv_x[i], cache.conv_B[i], cache.conv_C[i],
            cache.ssm[i])
        h = h + out
        for key, t in zip(("conv_x", "conv_B", "conv_C", "ssm"),
                          (cx, cb, cc, ss)):
            new[key].append(t)
    return h


def stacked_cache(new: Dict[str, list]) -> MambaCache:
    return MambaCache(**{k: torch.stack(v) for k, v in new.items()})


def ssm_decode_step(params: SsmLM, cache: MambaCache, token: torch.Tensor,
                    pos: int, cfg: ArchConfig
                    ) -> Tuple[torch.Tensor, MambaCache]:
    del pos  # the state carries all history: O(1) decode, no position
    new: Dict[str, list] = {"conv_x": [], "conv_B": [], "conv_C": [],
                            "ssm": []}
    h = mamba_decode_layers(F.embedding(token.long(), params.embed),
                            params.layers, cfg, cache, new)
    return _logits(params, h, cfg), stacked_cache(new)
