"""Batched LM serving loop — continuous-batching decode over the LM API
(port of :mod:`repro.launch.lm_serve`).

A deque-backed request queue feeds a fixed-slot batch (continuous batching:
a finished request's slot is refilled at once); each admitted request's
prompt is fed token by token through single-slot decode steps, then the
whole batch decodes against the shared KV cache.

Slots decode at their OWN positions: the decode step takes one ``pos`` and
writes the new state at that position for every batch row, so the step
groups active slots by position and masks the cache merge per group — only
a group's own rows take the freshly written cache, every other slot keeps
its history.  The merge masks every leaf of the cache on its batch axis
(axis 1), whatever the family's cache: the KV cache (dense, moe), the
Mamba conv and SSM states (ssm) or both (hybrid).  Encoder-decoder models
are not served here, as in the reference.

Weights are f32, random from ``seed`` (a ``torch.Generator`` on the
serving device) unless ``params=`` passes carried ones; ``cfg=`` serves
another config of the architecture (a depth-cut one) than the smoke or
published one.  The server runs
on the card by default and raises without one; ``device="cpu"`` runs it on
the CPU:

    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch llama3.2-1b \\
        --requests 8 --max-new 16 [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [p] int32
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


def merge_cache(new: Any, old: Any, mask: torch.Tensor) -> Any:
    """``new``'s rows where ``mask`` (bool ``[b]``) is set and ``old``'s
    elsewhere, on the batch axis (axis 1) of every tensor leaf of a cache
    (a tensor or a dataclass of caches, as the reference's ``tree_map``
    merge)."""
    if dataclasses.is_dataclass(new):
        return type(new)(**{f.name: merge_cache(getattr(new, f.name),
                                                getattr(old, f.name), mask)
                            for f in dataclasses.fields(new)})
    return torch.where(mask.reshape((1, -1) + (1,) * (new.dim() - 2)), new,
                       old)


class Server:
    """Fixed-slot continuous batching server.

    The queue is FIFO (a deque: O(1) admission from the head); slots admit
    strictly in arrival order.
    """

    def __init__(self, arch: str, *, slots: int = 4, max_seq: int = 128,
                 smoke: bool = True, seed: int = 0,
                 device: DeviceLike = None,
                 params: Optional[lm.Params] = None,
                 cfg: Optional[ArchConfig] = None):
        if cfg is None:
            cfg = get_smoke(arch) if smoke else get_config(arch)
        self.cfg = cfg
        if self.cfg.family == "encdec":
            raise NotImplementedError(
                "serve loop drives decoder-only archs; seamless decodes "
                "through lm.init_cache(params=...) and lm.decode_fn")
        self.device = resolve_device(device)
        self.max_seq = max_seq
        self.slots = slots
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            params = lm.init_params(gen, self.cfg, dtype=torch.float32)
        self.params = params
        self.cache = lm.init_cache(self.cfg, slots, max_seq,
                                   dtype=torch.float32, device=self.device)
        self._decode = lm.decode_fn(self.cfg)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.slot_pos = np.zeros(slots, np.int32)
        self.queue: Deque[Request] = deque()
        self.completed: List[Request] = []
        self.decode_calls = 0

    def decode(self, tokens: np.ndarray, pos: int, mask: np.ndarray
               ) -> torch.Tensor:
        """One masked decode call: ``tokens [slots, 1]`` at ``pos``; the
        new cache is kept only in the rows where ``mask`` is set.  Returns
        the logits ``[slots, 1, vocab]`` on the device."""
        dev = self.device
        logits, new = self._decode(
            self.params, self.cache, torch.from_numpy(tokens).to(dev), pos)
        self.cache = merge_cache(new, self.cache,
                                 torch.from_numpy(mask).to(dev))
        self.decode_calls += 1
        return logits

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.popleft()
                self.slot_req[s] = req
                # per-request prefill: feed prompt tokens through decode
                # steps (slot-level prefill keeps the batch cache layout)
                for t, tok in enumerate(req.prompt):
                    self._step_slot(s, int(tok), t)
                self.slot_pos[s] = len(req.prompt)

    def _step_slot(self, s: int, token: int, pos: int) -> None:
        # single-slot step: batch with this slot's token, others masked out
        tokens = np.zeros((self.slots, 1), np.int32)
        tokens[s, 0] = token
        mask = np.zeros(self.slots, bool)
        mask[s] = True
        self.decode(tokens, pos, mask)

    def step(self) -> int:
        """One decode round over all active slots; returns #active.

        Slots at the same position share one decode call; each distinct
        position gets its own masked call, so heterogeneous prompt lengths
        decode correctly side by side."""
        self._admit()
        active = [s for s in range(self.slots) if self.slot_req[s]]
        if not active:
            return 0
        by_pos: Dict[int, List[int]] = {}
        for s in active:
            by_pos.setdefault(int(self.slot_pos[s]), []).append(s)
        nxt = np.zeros(self.slots, np.int64)
        for pos, group in sorted(by_pos.items()):
            tokens = np.zeros((self.slots, 1), np.int32)
            mask = np.zeros(self.slots, bool)
            for s in group:
                req = self.slot_req[s]
                tokens[s, 0] = req.generated[-1] if req.generated \
                    else int(req.prompt[-1])
                mask[s] = True
            logits = self.decode(tokens, pos, mask)
            picks = logits[:, 0].argmax(-1).cpu().numpy()
            for s in group:
                nxt[s] = picks[s]
        for s in active:
            req = self.slot_req[s]
            req.generated.append(int(nxt[s]))
            self.slot_pos[s] += 1
            if req.done or self.slot_pos[s] >= self.max_seq - 1:
                self.completed.append(req)
                self.slot_req[s] = None
                self.slot_pos[s] = 0
        return len(active)

    def run(self) -> Dict[str, float]:
        t0 = time.time()
        steps = 0
        tokens = 0
        while self.queue or any(self.slot_req):
            tokens += self.step()
            steps += 1
        dt = time.time() - t0
        return {"steps": steps, "tokens": tokens, "wall_s": dt,
                "tok_per_s": tokens / max(dt, 1e-9)}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke one")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    srv = Server(args.arch, slots=args.slots, smoke=not args.full,
                 device=args.device)
    for i in range(args.requests):
        prompt = rng.integers(0, srv.cfg.vocab,
                              rng.integers(4, 12)).astype(np.int32)
        srv.submit(Request(rid=i, prompt=prompt, max_new=args.max_new))
    stats = srv.run()
    print(f"served {len(srv.completed)} requests, "
          f"{stats['tokens']} tokens in {stats['steps']} steps, "
          f"{stats['tok_per_s']:.1f} tok/s on {srv.device}")


if __name__ == "__main__":
    main()
