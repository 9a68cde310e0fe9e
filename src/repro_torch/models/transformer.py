"""Dense decoder-only transformer — GQA + RoPE + RMSNorm + SwiGLU (port of
:mod:`repro.models.transformer`), and the pieces the other LM families
build on (:class:`LayerParams`, :class:`LMParams`, the attention and FFN
inits, :class:`KVCache`).

Serves the reference's dense archs (llama3.2-1b, stablelm-3b, yi-6b,
chameleon-34b, gemma3-27b with its 5:1 sliding-window layers).  Weights
keep the reference's ``x @ w`` layout, one :class:`LayerParams` module per
layer in an ``nn.ModuleList`` (the reference scans stacked leaves), so a
reference param tree carries over leaf for leaf
(:func:`repro_torch.models.lm.params_from_reference`).

Attention switches, as in the reference, at ``FLASH_THRESHOLD``: up to
8192 keys it materializes the masked grouped scores (:func:`attend`, plain
torch, as the reference leaves it to XLA); beyond, :func:`flash_attend`
repeats K/V to full heads, flattens ``[b, s, h, hd]`` to ``[b·h, s, hd]``
and calls :func:`repro_torch.kernels.flash_mha` (with gemma3's window on
its local layers): the hand-written CUDA kernel on the card, its plain
version on the CPU.  ``flash_mha`` is differentiable (its backward the
``flash_mha_bwd`` kernels), so training runs past the threshold too, as
the reference's ``jax.grad`` runs through its scan.

``remat=True`` recomputes each layer body in the backward
(:func:`remat_call`, ``torch.utils.checkpoint`` without reentrancy), where
the reference wraps its scan body in ``jax.checkpoint``: only each layer's
input is kept, and every kernel of the layer runs again in the backward
(``flash_mha`` twice a layer and step).

Under a current :class:`~repro_torch.distributed.tensor_parallel.Split`
(the mesh steps of ``launch/steps.py``), each block the split's plan
splits runs on this rank's part of its leaves, as GSPMD runs the
reference's from its placement rules: the attention on the rank's
``n_heads / W`` heads (``wq``/``wk``/``wv`` column blocks, ``wo`` a row
block; where ``n_kv_heads`` does not split, K and V from the whole
``wk``/``wv``, each rank keeping the KV heads its query heads read), the
SwiGLU on ``d_ff / W`` columns, the embedding and the head on the rank's
vocab rows and columns: f before each column / row pair, g after it
(:func:`~repro_torch.distributed.tensor_parallel.enter` /
:func:`~repro_torch.distributed.tensor_parallel.leave`).  Outside one,
every block computes whole.  The head count of every reshape is read
from the weights, so the same code runs either way.

Not ported: the reference's GSPMD constraints (``_maybe_head_shard``,
``maybe_sp``, ``_rep_spec``), which have no counterpart on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import flash_mha

from .config import ArchConfig

FLASH_THRESHOLD = 8192     # max KV length for the materialized-mask path
Q_BLOCK = 512
K_BLOCK = 1024
NEG = torch.finfo(torch.float32).min

LAYER_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "ln_attn", "ln_ffn")


class LayerParams(nn.Module):
    """One layer's weights as parameters named after the reference's
    leaves (``LEAVES``, set by each kind of layer)."""

    LEAVES: Tuple[str, ...] = ()

    def __init__(self, leaves: Dict[str, torch.Tensor]):
        super().__init__()
        for name in self.LEAVES:
            setattr(self, name, nn.Parameter(leaves[name]))


class DenseLayer(LayerParams):
    """One layer's weights, named and laid out as the reference's leaves:
    ``wq [d, h·hd]``, ``wk``/``wv [d, kv·hd]``, ``wo [h·hd, d]``,
    ``w_gate``/``w_up [d, f]``, ``w_down [f, d]``, ``ln_attn``/``ln_ffn
    [d]`` (RMSNorm gains stored as ``g``, applied as ``1 + g``)."""

    LEAVES = LAYER_LEAVES


class LMParams(nn.Module):
    """A whole model's weights under the reference tree's top-level keys:
    each part a tensor (a parameter), a list of layer modules (an
    ``nn.ModuleList``, the reference's stacked leaves), one layer module
    (hybrid's shared block) or ``None`` (an untied head that is absent)."""

    def __init__(self, **parts):
        super().__init__()
        for key, part in parts.items():
            if part is None or isinstance(part, nn.Module):
                setattr(self, key, part)
            elif isinstance(part, torch.Tensor):
                setattr(self, key, nn.Parameter(part))
            else:
                setattr(self, key, nn.ModuleList(part))

    def head(self) -> torch.Tensor:
        """The output projection ``[d, vocab]``: ``lm_head``, or ``embed.T``
        when the embeddings are tied."""
        head = getattr(self, "lm_head", None)
        return self.embed.t() if head is None else head


class DenseLM(LMParams):
    """``embed [vocab, d]``, ``layers`` (:class:`DenseLayer` each),
    ``ln_final [d]`` and ``lm_head [d, vocab]`` (``None`` when the
    embeddings are tied: the head is then ``embed.T``)."""

    def __init__(self, embed: torch.Tensor, layers: List[DenseLayer],
                 ln_final: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__(embed=embed, layers=layers, ln_final=ln_final,
                         lm_head=lm_head)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32 for the parts the reference computes in f32 (norms,
    rope, scores, logits, the SSM's inputs), or as it is in float64: a
    float64 model is the port's yardstick and keeps its precision
    throughout, as :func:`repro_torch.models.mamba2.ssd_scan` does."""
    return t if t.dtype == torch.float64 else t.float()


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = upcast(x)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + g)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [b, s, h, hd]; positions: [b, s] (or [s]); computed in f32 on
    split halves."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = positions[..., None].float() * freqs               # [b, s, hd/2]
    cos = torch.cos(ang)[..., None, :]                       # [b, s, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = upcast(x).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_mask(s: int, device=None) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return j <= i                                            # [s, s] bool


def sliding_mask(s: int, window: int, device=None) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    return (j <= i) & (i - j < window)


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, h: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V heads repeated to ``h``: query head ``i`` reads KV head
    ``i // (h // kv)`` (``jnp.repeat``'s order)."""
    kv = k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    return k, v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Materialized-score GQA attention. q: [b, sq, h, hd]; k/v:
    [b, sk, kv, hd]; mask broadcastable to [b, h, sq, sk] (True = attend).
    Grouped: each KV head's ``g = h // kv`` query heads contract against it
    directly, with no repeat of K/V."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    if h % kv:
        k, v = _repeat_kv(k, v, h)
        kv = h
    g = h // kv
    scale = float(hd) ** 0.5
    if g == 1:
        logits = torch.einsum("bqhd,bkhd->bhqk", upcast(q),
                              upcast(k)) / scale
        if mask is not None:
            logits = logits.masked_fill(~mask, NEG)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    q5 = q.reshape(b, sq, kv, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", upcast(q5),
                          upcast(k)) / scale
    if mask is not None:
        m = mask[:, :, None] if mask.dim() == 4 else mask
        logits = logits.masked_fill(~m, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, hd)


def remat_call(remat: bool, fn: Callable, *args):
    """``fn(*args)``; with ``remat`` and autograd recording, its
    activations are dropped and recomputed in the backward
    (``jax.checkpoint``'s counterpart)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def heads_first(t: torch.Tensor) -> torch.Tensor:
    """``[b, s, h, hd]`` → ``[b·h, s, hd]``, contiguous: ``flash_mha``'s
    layout (heads flattened into the leading dimension)."""
    b, s, h, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, hd).contiguous()


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, w_eff: Optional[int] = None,
                 q_block: int = Q_BLOCK, k_block: int = K_BLOCK
                 ) -> torch.Tensor:
    """Blocked online-softmax attention through ``flash_mha`` (never
    materializes [sq, sk]).  q: [b, sq, h, hd]; k/v: [b, sk, kv, hd].
    ``w_eff``: the sliding window (keys with ``i - j >= w_eff`` masked,
    rows counted from 0 on both axes), or None.  A window of at least
    ``sq`` masks nothing (``i - j <= sq - 1``), so it goes to the kernel as
    no window: gemma3's global layers (``w_eff = s``) are plain causal
    calls."""
    b, sq, h, hd = q.shape
    window = None if w_eff is None or int(w_eff) >= sq else int(w_eff)
    k, v = _repeat_kv(k, v, h)
    o = flash_mha(heads_first(q), heads_first(k), heads_first(v),
                  causal=causal, q_block=q_block, k_block=k_block,
                  window=window)
    return o.reshape(b, h, sq, hd).permute(0, 2, 1, 3)


def flash_attend_causal_pairs(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, q_block: int = Q_BLOCK,
                              k_block: int = K_BLOCK) -> torch.Tensor:
    """Causal flash attention over the lower-triangle block pairs only (the
    reference's pair enumeration, which no path of either package calls).
    ``flash_mha``'s causal kernel already never loads a key tile above a
    query tile's last row, so this is the causal :func:`flash_attend`, with
    the reference's self-attention and divisibility checks."""
    sq, sk = q.shape[1], k.shape[1]
    if sq != sk:
        raise ValueError("pairs path is for self-attention prefill")
    if sq % q_block or sk % k_block:
        raise ValueError(f"seq ({sq},{sk}) not divisible by blocks "
                         f"({q_block},{k_block})")
    return flash_attend(q, k, v, causal=True, q_block=q_block,
                        k_block=k_block)


def attend_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, w_eff: Optional[int] = None) -> torch.Tensor:
    """Dispatch: materialized mask for short KV, flash blocking beyond."""
    sq, sk = q.shape[1], k.shape[1]
    if sk <= FLASH_THRESHOLD:
        mask = None
        if causal or w_eff is not None:
            i = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
            j = torch.arange(sk, device=q.device)[None, :]
            ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
            if causal:
                ok = ok & (j <= i)
            if w_eff is not None:
                ok = ok & (i - j < w_eff)
            mask = ok[None, None]
        return attend(q, k, v, mask)
    return flash_attend(q, k, v, causal=causal, w_eff=w_eff)


def gqa_project(x: torch.Tensor, p: DenseLayer, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return project_qkv(x, x, p.wq, p.wk, p.wv, cfg)


def project_qkv(x: torch.Tensor, src: torch.Tensor, wq: torch.Tensor,
                wk: torch.Tensor, wv: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Queries ``[b, s, h, hd]`` of ``x`` and keys / values ``[b, sk, kv,
    hd]`` of ``src`` (``x`` itself for self-attention), ``h`` and ``kv``
    the heads of the weights given.  Where the current split splits the
    attention, ``x`` (and ``src``) enter through f, and ``h`` is this
    rank's ``n_heads / W``; where it does not split the KV heads, K and V
    come from the whole ``wk`` / ``wv`` and enter through f themselves
    (each rank's gradient reaches only the heads it reads), and each rank
    keeps, per query head, the KV head it reads (``_repeat_kv``'s order):
    ``kv = h``."""
    b, s, _ = x.shape
    xf = tp.enter(x, "attn")
    q = (xf @ wq).reshape(b, s, -1, cfg.hd)
    bk, sk, _ = src.shape
    split = tp.split_for("attn")
    if split is not None and not split.splits("kv"):
        k = tp.replicate((src @ wk).reshape(bk, sk, -1, cfg.hd),
                         split.group, split.size)
        v = tp.replicate((src @ wv).reshape(bk, sk, -1, cfg.hd),
                         split.group, split.size)
        h = q.shape[2]
        heads = torch.arange(split.rank * h, (split.rank + 1) * h,
                             device=x.device) // (cfg.n_heads
                                                  // cfg.n_kv_heads)
        return q, k.index_select(2, heads), v.index_select(2, heads)
    sf = xf if src is x else tp.enter(src, "attn")
    k = (sf @ wk).reshape(bk, sk, -1, cfg.hd)
    v = (sf @ wv).reshape(bk, sk, -1, cfg.hd)
    return q, k, v


def attn_block(x: torch.Tensor, p: DenseLayer, cfg: ArchConfig,
               w_eff: Optional[int], positions: torch.Tensor
               ) -> torch.Tensor:
    """Full-sequence causal attention (train / prefill).  ``w_eff``: the
    sliding-window length, or None for dense causal."""
    b, s, _ = x.shape
    q, k, v = gqa_project(x, p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attend_auto(q, k, v, causal=True, w_eff=w_eff)
    return tp.leave(o.reshape(b, s, -1) @ p.wo, "attn")


def swiglu(x: torch.Tensor, p: LayerParams) -> torch.Tensor:
    """The SwiGLU FFN: on the ``w_gate`` / ``w_up`` column blocks and the
    ``w_down`` row block where the current split splits ``"ffn"``."""
    x = tp.enter(x, "ffn")
    return tp.leave((F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down, "ffn")


def dense_block(x: torch.Tensor, p: DenseLayer, cfg: ArchConfig,
                w_eff: Optional[int], positions: torch.Tensor
                ) -> torch.Tensor:
    h = x + attn_block(rmsnorm(x, p.ln_attn, cfg.norm_eps), p, cfg, w_eff,
                       positions)
    return h + swiglu(rmsnorm(h, p.ln_ffn, cfg.norm_eps), p)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _norm_init(gen: torch.Generator, shape, scale: float,
               dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def init_attn_params(gen: torch.Generator, cfg: ArchConfig,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """``wq``, ``wk``, ``wv``, ``wo`` at the reference's shapes and scales."""
    d, hd = cfg.d_model, cfg.hd
    s = d ** -0.5
    return {
        "wq": _norm_init(gen, (d, cfg.n_heads * hd), s, dtype),
        "wk": _norm_init(gen, (d, cfg.n_kv_heads * hd), s, dtype),
        "wv": _norm_init(gen, (d, cfg.n_kv_heads * hd), s, dtype),
        "wo": _norm_init(gen, (cfg.n_heads * hd, d),
                         (cfg.n_heads * hd) ** -0.5, dtype),
    }


def init_ffn_params(gen: torch.Generator, cfg: ArchConfig,
                    dtype: torch.dtype = torch.bfloat16,
                    d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``w_gate``, ``w_up``, ``w_down`` (SwiGLU) at the reference's shapes
    and scales."""
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": _norm_init(gen, (d, f), d ** -0.5, dtype),
        "w_up": _norm_init(gen, (d, f), d ** -0.5, dtype),
        "w_down": _norm_init(gen, (f, d), f ** -0.5, dtype),
    }


def zero_gains(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
               *names: str) -> Dict[str, torch.Tensor]:
    """Zero RMSNorm gains ``[d]`` under ``names`` (applied as ``1 + g``)."""
    return {n: torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
            for n in names}


def init_dense_layer(gen: torch.Generator, cfg: ArchConfig,
                     dtype: torch.dtype = torch.bfloat16) -> DenseLayer:
    return DenseLayer({**init_attn_params(gen, cfg, dtype),
                       **init_ffn_params(gen, cfg, dtype),
                       **zero_gains(gen, cfg, dtype, "ln_attn", "ln_ffn")})


def stack_layers(n: int, init_fn: Callable[[], LayerParams]
                 ) -> List[LayerParams]:
    """``n`` layers from ``init_fn`` (the reference stacks their leaves on
    a new leading axis; the port keeps one module per layer)."""
    return [init_fn() for _ in range(n)]


def init_dense_params(gen: torch.Generator, cfg: ArchConfig,
                      dtype: torch.dtype = torch.bfloat16) -> DenseLM:
    """The reference's init (same shapes and scales: N(0, 1) · 0.02 for the
    embeddings, · fan_in^-½ for the projections, zero norm gains) drawn
    from ``gen``, on ``gen``'s device.  ``jax.random`` streams cannot be
    reproduced without JAX: runs that must match the reference carry its
    weights over (``lm.params_from_reference``)."""
    embed = _norm_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype)
    layers = stack_layers(cfg.n_layers,
                          lambda: init_dense_layer(gen, cfg, dtype))
    head = None
    if not cfg.tie_embeddings:
        head = _norm_init(gen, (cfg.d_model, cfg.vocab),
                          cfg.d_model ** -0.5, dtype)
    ln_final = torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
    return DenseLM(embed, layers, ln_final, head)


def global_flags(cfg: ArchConfig) -> torch.Tensor:
    """[L] bool — layer uses the FULL causal mask (gemma3: every k-th)."""
    return torch.tensor(global_layers(cfg), dtype=torch.bool)


def global_layers(cfg: ArchConfig) -> List[bool]:
    """:func:`global_flags` as Python bools, computed without a tensor: the
    forwards read them on the host, which a shape-only (fake) trace cannot
    do with a tensor's values."""
    n = cfg.n_layers
    if cfg.global_every:
        return [(i + 1) % cfg.global_every == 0 for i in range(n)]
    return [not cfg.sliding_window] * n


def layer_window(cfg: ArchConfig, s: int, is_global: bool) -> Optional[int]:
    """Per-layer effective window: s when global, else the sliding window;
    None when the arch has no sliding layers at all."""
    if not cfg.sliding_window:
        return None
    return s if bool(is_global) else cfg.sliding_window


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def _logits(params: LMParams, x: torch.Tensor, cfg: ArchConfig
            ) -> torch.Tensor:
    """The final norm and the head: f32 logits over the whole vocab, or
    over this rank's block of it where the current split splits
    ``"head"`` (``tensor_parallel.vocab_nll`` takes them so)."""
    x = rmsnorm(x, params.ln_final, cfg.norm_eps)
    return torch.matmul(tp.enter(upcast(x), "head"), upcast(params.head()))


def embed_tokens(tokens: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """The embedding lookup: vocab-parallel where the current split splits
    ``"embed"`` (``embed`` this rank's block of rows)."""
    return tp.vocab_embed(tokens, embed, tp.split_for("embed"))


def dense_forward(params: DenseLM, tokens: torch.Tensor, cfg: ArchConfig,
                  *, embeddings: Optional[torch.Tensor] = None,
                  remat: bool = False,
                  last_logits: bool = False) -> torch.Tensor:
    """tokens [b, s] → logits [b, s, vocab] f32 (or [b, 1, vocab] when
    ``last_logits``, the serving-prefill contract).  ``remat`` recomputes
    each layer in the backward."""
    s = tokens.shape[1]
    x = embeddings if embeddings is not None \
        else embed_tokens(tokens, params.embed)
    positions = torch.arange(s, device=x.device)[None, :]
    for p, is_global in zip(params.layers, global_layers(cfg)):
        x = remat_call(remat, dense_block, x, p, cfg,
                       layer_window(cfg, s, is_global), positions)
    if last_logits:
        x = x[:, -1:]
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor   # [L, b, S, kv, hd]
    v: torch.Tensor   # [L, b, S, kv, hd]

    @classmethod
    def zeros(cls, cfg: ArchConfig, batch: int, max_seq: int,
              dtype: torch.dtype = torch.bfloat16, device=None,
              n_layers: Optional[int] = None) -> "KVCache":
        shape = (n_layers or cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                 cfg.hd)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def decode_attn_block(x: torch.Tensor, p: DenseLayer, cfg: ArchConfig,
                      k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                      is_global: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against the cache.

    x: [b, 1, d]; k_cache/v_cache: [b, S, kv, hd]; pos: index of the new
    token.  Returns (out [b, 1, d], new k/v caches).  Like the reference it
    leaves its inputs untouched: the new caches are copies with column
    ``pos`` written for every batch row.
    """
    b, _, d = x.shape
    S = k_cache.shape[1]
    q, k, v = gqa_project(x, p, cfg)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    k_cache = k_cache.clone()
    v_cache = v_cache.clone()
    k_cache[:, pos] = k[:, 0]
    v_cache[:, pos] = v[:, 0]
    j = torch.arange(S, device=x.device)
    valid = j <= pos
    if cfg.sliding_window and not bool(is_global):
        valid = valid & (pos - j < cfg.sliding_window)
    o = attend(q, k_cache, v_cache, valid[None, None, None, :])
    return o.reshape(b, 1, cfg.n_heads * cfg.hd) @ p.wo, k_cache, v_cache


def dense_decode_step(params: DenseLM, cache: KVCache, token: torch.Tensor,
                      pos: int, cfg: ArchConfig
                      ) -> Tuple[torch.Tensor, KVCache]:
    """token [b, 1] int, pos → (logits [b, 1, vocab] f32, new cache)."""
    h = F.embedding(token.long(), params.embed)
    ks, vs = [], []
    for i, (p, is_global) in enumerate(zip(params.layers,
                                           global_layers(cfg))):
        xin = rmsnorm(h, p.ln_attn, cfg.norm_eps)
        att, kc, vc = decode_attn_block(xin, p, cfg, cache.k[i], cache.v[i],
                                        pos, is_global)
        h = h + att
        h = h + swiglu(rmsnorm(h, p.ln_ffn, cfg.norm_eps), p)
        ks.append(kc)
        vs.append(vc)
    return _logits(params, h, cfg), KVCache(k=torch.stack(ks),
                                            v=torch.stack(vs))
