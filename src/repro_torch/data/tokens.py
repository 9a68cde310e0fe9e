"""Synthetic token pipeline for the LM trainer (port of
:mod:`repro.data.tokens`; numpy, so its tokens are the reference's).

Training data is a deterministic PRNG stream with Zipfian token marginals
(real-vocab-like frequency skew, so embedding-gradient sparsity is
representative).  The pipeline is steppable and restartable: ``state =
(seed, step)`` checkpoints beside the model, so a restore resumes the
exact stream position.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ArchConfig


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int,
                 alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed token ids clipped to the vocab."""
    raw = rng.zipf(alpha, size=shape)
    return np.minimum(raw - 1, vocab - 1).astype(np.int32)


def make_lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                  *, enc_frames: int = 0, d_model: int = 0
                  ) -> Dict[str, np.ndarray]:
    """One deterministic batch: tokens + next-token labels (+frames stub)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = _zipf_tokens(rng, (batch, seq + 1), vocab)
    out: Dict[str, np.ndarray] = {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:].astype(np.int32),
    }
    if enc_frames:
        out["frames"] = rng.standard_normal(
            (batch, enc_frames, d_model)).astype(np.float32) * 0.02
    return out


def synthetic_frames(seed: int, batch: int, frames: int, d_model: int
                     ) -> np.ndarray:
    """Modality-frontend stub output (audio frames / vision patches)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, frames, d_model)).astype(np.float32) * 0.02


@dataclasses.dataclass
class TokenPipeline:
    """Restartable synthetic stream; ``state()``/``restore()`` give the
    checkpoint contract."""

    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    step: int = 0
    enc_frames: int = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = make_lm_batch(self.seed, self.step, self.batch, self.seq,
                          self.cfg.vocab, enc_frames=self.enc_frames,
                          d_model=self.cfg.d_model)
        self.step += 1
        return b

    def state(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: Dict[str, int]) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])


def lm_batch_specs(cfg: ArchConfig, batch: int, seq: int, *,
                   enc_frames: int = 0, device="meta"
                   ) -> Dict[str, torch.Tensor]:
    """Shape-only stand-ins for a batch (the reference's
    ``ShapeDtypeStruct`` s; nothing allocated): ``tokens`` and ``labels``
    int32 ``[batch, seq]``, and ``frames`` f32 ``[batch, enc_frames,
    d_model]`` when ``enc_frames`` is given.  On ``device="meta"`` (the
    default) they are meta tensors; under a ``FakeTensorMode`` they are
    fake tensors on ``device``, as the dry run traces a step
    (:mod:`repro_torch.launch.dryrun`)."""
    specs = {
        "tokens": torch.empty((batch, seq), dtype=torch.int32, device=device),
        "labels": torch.empty((batch, seq), dtype=torch.int32, device=device),
    }
    if enc_frames:
        specs["frames"] = torch.empty((batch, enc_frames, cfg.d_model),
                                      dtype=torch.float32, device=device)
    return specs
