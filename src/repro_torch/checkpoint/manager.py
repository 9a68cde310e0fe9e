"""Checkpointing — atomic, per-leaf, async (port of
:mod:`repro.checkpoint.manager`).

The on-disk layout is the reference's, so either package restores the
other's checkpoints: ``step_XXXXXXXX/manifest.json`` (step, ``extra``, and
one entry per leaf: file, shape, dtype) plus one ``.npy`` per leaf, keyed
by its tree path (``"0/w"`` → ``0__w.npy``).  A checkpoint is written to
``step_XXXXXXXX.tmp/`` and renamed into place after every leaf and the
manifest are written, so a crash never leaves a half checkpoint that
restore would pick up.  ``save_async`` snapshots the leaves to host memory
on the caller's thread and writes on a worker thread.  The newest ``keep``
checkpoints are retained.  ``extra`` carries the Trainer's progress
counters and input-pipeline state, which make restore batch-exact.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "/"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's order: dict keys sorted, named
    tuple fields by name (an optimizer state's ``momentum``, ``step``),
    list and tuple items by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, f"{prefix}{SEP}{k}" if prefix else k))
    return out


def _unflatten(like, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{SEP}{k}" if prefix
                              else str(k)) for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves, f"{prefix}{SEP}{k}"
                                       if prefix else k)
                            for k, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, f"{prefix}{SEP}{i}"
                                     if prefix else str(i))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf (never a view of live memory)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    """Saves and restores the checkpoints under ``directory`` (created by
    the first save; reading a missing directory finds no checkpoint)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._worker: Optional[threading.Thread] = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Synchronous atomic save; returns the final path."""
        self.wait()
        return self._write(step, [(k, _host(v)) for k, v in _flatten(tree)],
                           extra or {})

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot now, write in the background (joins any prior writer
        first so checkpoints land in order)."""
        self.wait()
        leaves = [(k, _host(v)) for k, v in _flatten(tree)]
        self._worker = threading.Thread(
            target=self._write, args=(step, leaves, dict(extra or {})))
        self._worker.start()

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _write(self, step: int, leaves, extra: Dict[str, Any]) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for key, arr in leaves:
            fname = key.replace(SEP, "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomicity boundary
        self._retain()
        return final

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, like: Any
                       ) -> Optional[Tuple[Any, Dict[str, Any], int]]:
        """``(tree, extra, step)`` of the newest checkpoint, or ``None``
        when there is none yet."""
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like)
        return tree, extra, step

    def read(self, step: int) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """``({path: array}, extra)`` of checkpoint ``step``: every leaf the
        manifest lists, each checked against its manifest shape and dtype."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for key, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(path, meta["file"]))
            if list(arr.shape) != list(meta["shape"]) \
                    or str(arr.dtype) != meta["dtype"]:
                raise ValueError(f"leaf {key!r}: file holds {arr.dtype} "
                                 f"{arr.shape}, manifest says "
                                 f"{meta['dtype']} {meta['shape']}")
            leaves[key] = arr
        return leaves, manifest["extra"]

    def restore(self, step: int, like: Any) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``like``: a tensor leaf of ``like``
        comes back as a tensor of its dtype on its device, any other leaf
        as the stored array."""
        stored, extra = self.read(step)
        want = _flatten(like)
        missing = [k for k, _ in want if k not in stored]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}")
        leaves = {}
        for key, proto in want:
            arr = stored[key]
            if isinstance(proto, torch.Tensor):
                arr = torch.from_numpy(arr).to(device=proto.device,
                                               dtype=proto.dtype)
            leaves[key] = arr
        return _unflatten(like, leaves), extra
