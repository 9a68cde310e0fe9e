"""Step builders (port of :mod:`repro.launch.steps`'s mesh-free part).

:func:`build_step` returns the callable of one cell's kind, with the
reference's defaults: ``"train"`` an AdamW training step with remat on,
``"prefill"`` the serving prefill, ``"decode"`` the one-token serve step.
The reference also assigns shardings to every input of a step (its
divisibility sanitizer, ``param_spec``, ``zero1_spec``, ``abstract_inputs``,
``sp_spec_for`` / ``ep_spec_for``); that half needs a device mesh, which
the multi-GPU backend brings (ROADMAP Queue 1 item 10).  The GSPMD
constraint ``sp_spec`` is not ported (one card has no sequence shards).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw

KINDS = ("train", "prefill", "decode")


def build_step(cfg: ArchConfig, kind: str, *, chunk: int = 128,
               lr: float = 3e-4, remat: bool = True,
               ep_spec=None) -> Callable:
    """The step of ``kind`` for ``cfg``: ``"train"`` →
    ``(params, opt_state, batch) → (params, opt_state, metrics)`` with
    AdamW at ``lr`` (its state from ``adamw(lr)[0](lm.param_tree(params))``)
    and ``remat``; ``"prefill"`` → ``(params, batch) → last-position
    logits``; ``"decode"`` → ``(params, cache, token, pos) → (logits,
    cache)``.  ``ValueError`` on any other kind; ``ep_spec`` other than
    ``None`` raises (the expert-parallel MoE, ROADMAP Queue 1 item 10)."""
    if ep_spec is not None:
        raise NotImplementedError(
            "build_step with ep_spec (the expert-parallel MoE) needs the "
            "multi-GPU backend, ROADMAP Queue 1 item 10")
    if kind == "train":
        return lm.train_step_fn(cfg, adamw(lr), chunk=chunk, remat=remat)
    if kind == "prefill":
        return lm.prefill_fn(cfg, chunk=chunk)
    if kind == "decode":
        return lm.decode_fn(cfg)
    raise ValueError(f"build_step kind {kind!r} is none of {KINDS}")
