"""Unified LM wrapper (port of :mod:`repro.models.lm`): one interface over
all five stack families.

``init_params`` / ``forward`` / ``lm_loss`` / ``train_step_fn`` /
``prefill_fn`` / ``init_cache`` / ``decode_fn`` dispatch on ``cfg.family``
(dense, moe, ssm, hybrid, encdec) as in the reference.

Training takes its gradients from ``torch.autograd`` through the forward
(``prefill_fn`` and ``decode_fn`` wrap the same forward in ``no_grad``;
the training step does not), past ``FLASH_THRESHOLD`` keys too, through
``flash_mha``'s backward kernel; ``remat`` recomputes each layer in the
backward, as the reference's ``jax.checkpoint`` does (``train_step_fn``
turns it on by default, as the reference's).  ``ep_spec`` reaches the MoE
layers, which then run expert-parallel over the current mesh's ``model``
axis (``moe.moe_ffn_ep``).  The steps here know no mesh: the steps across
a mesh's ranks are :mod:`repro_torch.launch.steps`', which run
:func:`forward` and :func:`nll_sum` under a ``tensor_parallel.Split``:
then the logits are each rank's block of the vocab.  The reference's
``sp_spec`` (GSPMD constraints) is not ported.  The optimizers see the
model as :func:`param_tree`, a tree in the reference's leaf order, and
:func:`params_to_reference` / :func:`params_from_reference` (and their
``opt_state`` counterparts for AdamW) convert to and from the reference's
stacked layout, which is also the checkpoint layout: either package
resumes the other's LM checkpoints.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple, Type, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.optim.optimizers import (AdamWState, apply_updates,
                                          clip_by_global_norm, tree_leaves,
                                          tree_map)

from . import encdec as _encdec
from . import hybrid as _hybrid
from . import mamba2 as _mamba2
from . import moe as _moe
from . import transformer as _dense
from .config import ArchConfig

Params = _dense.LMParams
Cache = Union[_dense.KVCache, _mamba2.MambaCache, _hybrid.HybridCache,
              _encdec.EncDecCache]

# each family's model: its container and, per top-level key of the
# reference's tree, a layer class (a stack of them, or hybrid's one shared
# block) or None (a tensor)
_LAYOUTS: Dict[str, Tuple[Type[_dense.LMParams], Dict[str, Any]]] = {
    "dense": (_dense.DenseLM, {"embed": None, "layers": _dense.DenseLayer,
                               "lm_head": None, "ln_final": None}),
    "moe": (_moe.MoeLM, {"dense_layers": _dense.DenseLayer, "embed": None,
                         "lm_head": None, "ln_final": None,
                         "moe_layers": _moe.MoELayer}),
    "ssm": (_mamba2.SsmLM, {"embed": None, "layers": _mamba2.MambaLayer,
                            "ln_final": None}),
    "hybrid": (_hybrid.HybridLM, {"embed": None, "ln_final": None,
                                  "mamba_layers": _mamba2.MambaLayer,
                                  "shared": _dense.DenseLayer}),
    "encdec": (_encdec.EncDecLM, {"dec_layers": _encdec.DecLayer,
                                  "embed": None,
                                  "enc_layers": _dense.DenseLayer,
                                  "ln_enc": None, "ln_final": None}),
}
_SINGLE = {("hybrid", "shared")}            # one layer, not a stack


def _family_of(params: _dense.LMParams) -> str:
    for family, (cls, _) in _LAYOUTS.items():
        if type(params) is cls:
            return family
    raise TypeError(f"not a port LM: {type(params).__name__}")


def _family_of_tree(tree: Mapping[str, Any]) -> str:
    """The family of a reference-layout (or :func:`param_tree`) tree, from
    its top-level keys and the leaves of its layers."""
    if "moe_layers" in tree:
        return "moe"
    if "mamba_layers" in tree:
        return "hybrid"
    if "enc_layers" in tree:
        return "encdec"
    return "ssm" if "w_z" in tree["layers"] else "dense"


def _stack_lengths(cfg: ArchConfig) -> Dict[str, int]:
    """Layers in each stacked key of ``cfg``'s reference tree."""
    if cfg.family == "moe":
        if cfg.moe_interleave == 2:
            n = cfg.n_layers // 2
            return {"dense_layers": n, "moe_layers": n}
        return {"moe_layers": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"mamba_layers": cfg.n_layers}
    if cfg.family == "encdec":
        return {"enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers}
    return {"layers": cfg.n_layers}


# ---------------------------------------------------------------------------
# init / forward dispatch
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random weights from ``gen``, on ``gen``'s device (the reference's
    shapes, scales and leaf types, not its random stream)."""
    if cfg.family == "dense":
        return _dense.init_dense_params(gen, cfg, dtype)
    if cfg.family == "moe":
        return _moe.init_moe_stack_params(gen, cfg, dtype)
    if cfg.family == "ssm":
        return _mamba2.init_ssm_params(gen, cfg, dtype)
    if cfg.family == "hybrid":
        return _hybrid.init_hybrid_params(gen, cfg, dtype)
    if cfg.family == "encdec":
        return _encdec.init_encdec_params(gen, cfg, dtype)
    raise ValueError(cfg.family)


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, chunk: int = 64, remat: bool = False, ep_spec=None,
            last_logits: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits f32, aux_loss scalar).  ``batch['embeddings']`` (modality
    stub) substitutes the embedding lookup when present; encdec reads
    ``batch['frames']``.  ``chunk`` is the SSM families' scan chunk;
    ``remat`` recomputes each layer body in the backward; ``ep_spec``
    goes to the MoE layers."""
    emb = batch.get("embeddings")
    tokens = batch["tokens"]
    kw = dict(remat=remat, last_logits=last_logits)
    if cfg.family == "moe":
        return _moe.moe_forward(params, tokens, cfg, embeddings=emb,
                                ep_spec=ep_spec, **kw)
    if cfg.family == "dense":
        logits = _dense.dense_forward(params, tokens, cfg, embeddings=emb,
                                      **kw)
    elif cfg.family == "ssm":
        logits = _mamba2.ssm_forward(params, tokens, cfg, chunk=chunk,
                                     embeddings=emb, **kw)
    elif cfg.family == "hybrid":
        logits = _hybrid.hybrid_forward(params, tokens, cfg, chunk=chunk,
                                        embeddings=emb, **kw)
    elif cfg.family == "encdec":
        logits = _encdec.encdec_forward(params, batch["frames"], tokens, cfg,
                                        **kw)
    else:
        raise ValueError(cfg.family)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


AUX_COEF = 0.01          # lm_loss's default weight of the MoE aux loss


def nll_sum(logits: torch.Tensor, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """The summed next-token negative log-likelihood of ``batch['labels']``
    (times ``batch['mask']`` when present).  Where the current
    ``tensor_parallel.Split`` splits the head, ``logits`` are this rank's
    block of the vocab and the log-sum-exp runs over the blocks
    (``tensor_parallel.vocab_nll``)."""
    nll = tp.vocab_nll(logits, batch["labels"], tp.split_for("head"))
    mask = batch.get("mask")
    if mask is not None:
        nll = nll * mask
    return nll.sum()


def token_count(batch: Dict[str, torch.Tensor]):
    """:func:`lm_loss`'s denominator: the mask's sum (at least 1), else
    the number of labels."""
    mask = batch.get("mask")
    if mask is not None:
        return torch.clamp(mask.sum(), min=1.0)
    return batch["labels"].numel()


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, aux_coef: float = AUX_COEF, chunk: int = 64,
            remat: bool = False, ep_spec=None) -> torch.Tensor:
    """Next-token cross-entropy (labels = tokens shifted by the pipeline)
    plus ``aux_coef`` × the MoE aux loss."""
    logits, aux = forward(params, batch, cfg, chunk=chunk, remat=remat,
                          ep_spec=ep_spec)
    return nll_sum(logits, batch) / token_count(batch) + aux_coef * aux


def train_step_fn(cfg: ArchConfig, optimizer, *, clip: float = 1.0,
                  chunk: int = 64, remat: bool = True,
                  ep_spec=None) -> Callable:
    """The training step ``(params, opt_state, batch) → (params, opt_state,
    {"loss", "grad_norm"})``: loss → autograd gradients of every leaf of
    :func:`param_tree` → global-norm clip → ``optimizer``'s update →
    new params (a new module; the given one is left untouched).
    ``optimizer`` is an ``(init_fn, update_fn)`` pair from
    :mod:`repro_torch.optim`, initialized on :func:`param_tree`.
    ``remat`` (on by default, as in the reference) recomputes each layer
    in the backward."""
    _, update = optimizer

    def step(params: Params, opt_state, batch: Dict[str, torch.Tensor]):
        tree = param_tree(params)
        with torch.enable_grad():
            loss = lm_loss(params, batch, cfg, chunk=chunk, remat=remat,
                           ep_spec=ep_spec)
            grads = iter(torch.autograd.grad(loss, tree_leaves(tree)))
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(
                tree_map(lambda _: next(grads), tree), clip)
            updates, opt_state = update(grads, opt_state, tree)
            del grads
            new = params_from_tree(apply_updates(tree, updates))
        return new, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def prefill_fn(cfg: ArchConfig, *, chunk: int = 64, ep_spec=None,
               last_logits: bool = True) -> Callable:
    """Serving prefill: by default only the LAST position's logits are
    computed (generation needs one row).  Runs without autograd."""
    def prefill(params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = forward(params, batch, cfg, chunk=chunk,
                                ep_spec=ep_spec, last_logits=last_logits)
        return logits

    return prefill


# ---------------------------------------------------------------------------
# serve: cache init + one-token decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, *, enc_frames: int = 0,
               params: Params = None, device: DeviceLike = None) -> Cache:
    """A zero cache on ``device`` (``None`` → the card).  encdec's cache
    holds the cross K/V of an encoder memory: zeros of ``enc_frames`` (or
    ``max_seq``) frames projected through ``params``, which it needs, as
    the reference's does."""
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe"):
        return _dense.KVCache.zeros(cfg, batch, max_seq, dtype, device=dev)
    if cfg.family == "ssm":
        return _mamba2.MambaCache.zeros(cfg, batch, device=dev)
    if cfg.family == "hybrid":
        return _hybrid.HybridCache.zeros(cfg, batch, max_seq, dtype,
                                         device=dev)
    if cfg.family == "encdec":
        if params is None:
            raise ValueError("encdec cache needs params (cross K/V "
                             "projection)")
        memory = torch.zeros((batch, enc_frames or max_seq, cfg.d_model),
                             dtype=dtype, device=dev)
        with torch.no_grad():
            return _encdec.prefill_cross(params, memory, cfg, batch, max_seq,
                                         dtype)
    raise ValueError(cfg.family)


def decode_fn(cfg: ArchConfig) -> Callable:
    """One-token serve step ``(params, cache, token [b, 1], pos) →
    (logits [b, 1, vocab] f32, new cache)``, without autograd."""
    steps = {"dense": _dense.dense_decode_step,
             "moe": _moe.moe_decode_step,
             "ssm": _mamba2.ssm_decode_step,
             "hybrid": _hybrid.hybrid_decode_step,
             "encdec": _encdec.encdec_decode_step}
    if cfg.family not in steps:
        raise ValueError(cfg.family)
    one = steps[cfg.family]

    def step(params: Params, cache: Cache, token: torch.Tensor, pos: int
             ) -> Tuple[torch.Tensor, Cache]:
        with torch.no_grad():
            return one(params, cache, token, int(pos), cfg)

    return step


# ---------------------------------------------------------------------------
# the reference's tree layout
# ---------------------------------------------------------------------------
def param_tree(params: Params) -> Dict[str, Any]:
    """The module's parameters as a tree in the reference's leaf order:
    top-level keys sorted (dense: ``embed``, ``layers``, ``lm_head`` when
    untied, ``ln_final``; the other families their own keys), each stack a
    dict of its sorted leaf names, each a list of the per-layer tensors
    (the reference's stacked ``[L, ...]`` leaf, layer by layer), hybrid's
    ``shared`` block a dict of its sorted leaves.  The tensors are the
    module's own."""
    family = _family_of(params)
    _, layout = _LAYOUTS[family]
    tree: Dict[str, Any] = {}
    for key in sorted(layout):
        part = getattr(params, key, None)
        if part is None:
            continue
        cls = layout[key]
        if cls is None:
            tree[key] = part
        elif (family, key) in _SINGLE:
            tree[key] = {name: getattr(part, name)
                         for name in sorted(cls.LEAVES)}
        else:
            tree[key] = {name: [getattr(layer, name) for layer in part]
                         for name in sorted(cls.LEAVES)}
    return tree


def params_from_tree(tree: Mapping[str, Any]) -> Params:
    """A :func:`param_tree`-shaped tree of tensors as the port's modules
    (the tensors are wrapped, not copied)."""
    family = _family_of_tree(tree)
    cls, layout = _LAYOUTS[family]
    parts: Dict[str, Any] = {}
    for key, layer_cls in layout.items():
        part = tree.get(key)
        if part is None or layer_cls is None:
            parts[key] = part
        elif (family, key) in _SINGLE:
            parts[key] = layer_cls(part)
        else:
            n = len(part[layer_cls.LEAVES[0]])
            parts[key] = [layer_cls({name: part[name][i]
                                     for name in layer_cls.LEAVES})
                          for i in range(n)]
    if family == "dense":
        return cls(parts["embed"], parts["layers"], parts["ln_final"],
                   parts["lm_head"])
    return cls(**parts)


def _tree_from_reference(tree: Mapping[str, Any], cfg: ArchConfig,
                         dev: torch.device) -> Dict[str, Any]:
    """A reference-layout tree (stacked layer leaves) as a
    :func:`param_tree`-shaped tree of tensors on ``dev``."""
    def tensor(a) -> torch.Tensor:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":      # ml_dtypes: exact via f32
            return torch.from_numpy(arr.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(arr, copy=True)).to(dev)

    if _family_of_tree(tree) != cfg.family:
        raise ValueError(f"the tree is not a {cfg.family!r} model "
                         f"({cfg.name})")
    stacks = _stack_lengths(cfg)
    out: Dict[str, Any] = {}
    for key in sorted(tree):
        value = tree[key]
        if value is None:
            continue
        if key in stacks:
            n = int(np.shape(next(iter(value.values())))[0])
            if n != stacks[key]:
                raise ValueError(f"the tree's {key} has {n} layers, "
                                 f"{cfg.name} has {stacks[key]}")
            out[key] = {name: [tensor(layer) for layer in np.asarray(a)]
                        for name, a in sorted(value.items())}
        elif isinstance(value, Mapping):
            out[key] = {name: tensor(a) for name, a in sorted(value.items())}
        else:
            out[key] = tensor(value)
    return out


def _tree_to_reference(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A :func:`param_tree`-shaped tree as the reference's layout: host
    numpy leaves, each list of per-layer tensors stacked ``[L, ...]``."""
    def host(t):
        if isinstance(t, list):
            return np.stack([host(x) for x in t])
        if isinstance(t, Mapping):
            return {k: host(v) for k, v in t.items()}
        return t.detach().cpu().numpy()

    return {k: host(v) for k, v in tree.items() if v is not None}


def params_from_reference(tree: Mapping[str, Any], cfg: ArchConfig,
                          device: DeviceLike = None) -> Params:
    """The reference's param tree of ``cfg``'s family (numpy arrays, or
    anything ``np.asarray`` takes; every stacked leaf ``[L, ...]``) as the
    port's modules on ``device`` (``None`` → the card), value for value in
    the same ``x @ w`` layout and type."""
    return params_from_tree(_tree_from_reference(tree, cfg,
                                                 resolve_device(device)))


def params_to_reference(params: Params) -> Dict[str, Any]:
    """The inverse of :func:`params_from_reference`: the reference's tree
    of host numpy arrays."""
    return _tree_to_reference(param_tree(params))


def opt_state_from_reference(state: Any, cfg: ArchConfig,
                             device: DeviceLike = None) -> AdamWState:
    """The reference's ``AdamWState`` (``mu``, ``nu``, ``step``: numpy, or
    anything ``np.asarray`` takes) as the port's, its moments
    :func:`param_tree`-shaped on ``device`` and its step an int32
    tensor."""
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
