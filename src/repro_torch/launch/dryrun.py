"""One-device dry run (port of :mod:`repro.launch.dryrun`): trace every
(arch × shape) cell's step on shape-only tensors.

This is the proof that the grid is coherent without running it: each
runnable cell of :func:`repro_torch.configs.all_cells` builds its inputs
(params, AdamW state, batch, cache) as fake tensors on one device
(``torch._subclasses.FakeTensorMode``: shapes, types and a device, no
memory) and runs :func:`repro_torch.launch.steps.build_step`'s step once
on them.  Every op and every kernel wrapper checks its inputs as it would
on real ones, so a cell that reaches a shape a kernel refuses fails here.
The record counts what the step would do on one card:

* flops and bytes from :class:`~repro_torch.launch.roofline.WorkCounter`
  (the kernels report their own work, as on a real call), and the
  roofline terms under the card's peaks, never a TPU's;
* memory from :class:`PeakMemory`: the bytes of the live tensor storages,
  added when an op creates one and taken off when it is freed, at most
  (``peak_bytes``), with the step's inputs (``argument_bytes``) and what it
  returns (``output_bytes``); on CUDA each storage rounded up to the
  caching allocator's 512-byte blocks.

On ``device="cuda"`` the trace follows the card's path: the kernel
wrappers see fake CUDA tensors and return their kernels' outputs
(``flash_mha``'s ``o`` and ``lse``) without a launch, so the plain
versions' temporaries are not counted.  On ``device="cpu"`` it follows
the CPU's path, plain versions included.  (A fake CUDA tensor that
records autograd aborts a CPU-only build of torch, so ``--device cuda``
runs on the machine with the card.)

The reference lowers each cell on a 512-device TPU mesh, one pod and two.
The port places every cell's inputs on such meshes
(``launch/steps.py::abstract_inputs``), and its mesh steps compute each
block in its ``model`` split (``launch/steps.py::tp_plan``), but the
trace of one rank of a 256- or 512-rank mesh is not built yet:
``--multi-pod`` and ``--single-pod`` raise here (ROADMAP Queue 1 item
10.3).

Cells run one after another in this process, each in a fresh fake mode
(nothing of one cell reaches the next); ``--jobs N`` shares them among
``N`` worker processes.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun   # the card's path
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
        --shape prefill_32k --out build/dryrun.json
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, Shape, all_cells, get_config
from repro_torch.data.tokens import lm_batch_specs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.roofline import (WorkCounter, card_peaks,
                                         roofline_terms)
from repro_torch.launch.steps import build_step
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw

#: the caching allocator's block: every CUDA allocation is a multiple
_CUDA_BLOCK = 512
#: an H100 80GB HBM3's memory (nvidia-smi's memory.total, 81559 MiB), what
#: a trace away from the card is held to
H100_MEMORY = 81559 * 2 ** 20
_DECODE_ENC_FRAMES = 4096          # the reference's decode cache: min(s, ·)


def _round(nbytes: int, device: torch.device) -> int:
    if device.type == "cuda":
        return -(-nbytes // _CUDA_BLOCK) * _CUDA_BLOCK
    return nbytes


def tensors_in(obj: Any) -> List[torch.Tensor]:
    """Every tensor in ``obj``: a tensor, a module's parameters and
    buffers, a dataclass's fields, or any tree of tuples, lists and dicts
    of them."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return tensors_in([getattr(obj, f.name)
                           for f in dataclasses.fields(obj)])
    if isinstance(obj, dict):
        return tensors_in(list(obj.values()))
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tensors_in(x)]
    return []


class PeakMemory(TorchDispatchMode):
    """Live bytes of tensor storages while it is active, and their most.

    :meth:`hold` registers storages that exist already (the step's
    inputs); every op's outputs add the storages they bring, each once,
    and a storage's bytes come off when it is freed (a weak reference's
    callback: autograd's saved tensors and a checkpoint's recomputation
    are counted for as long as they live).  Views and in-place results
    share a storage that is held already and add nothing."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.live = 0
        self.peak = 0
        self._held: Dict[int, tuple] = {}

    def _gone(self, key: int, nbytes: int) -> None:
        if self._held.pop(key, None) is not None:
            self.live -= nbytes

    def storage_bytes(self, tensors: Iterable[torch.Tensor]) -> int:
        """Bytes of the distinct storages behind ``tensors`` (rounded as
        the device allocates them)."""
        seen = {}
        for t in tensors:
            st = t.untyped_storage()
            seen[id(st)] = _round(st.nbytes(), self.device)
        return sum(seen.values())

    def hold(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._held:
                continue
            nbytes = _round(st.nbytes(), self.device)
            ref = weakref.ref(st, lambda _, key=key, n=nbytes:
                              self._gone(key, n))
            self._held[key] = (ref, nbytes)
            self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace != "prim":   # metadata reads create nothing
            self.hold(t for t in tree_flatten(out)[0]
                      if isinstance(t, torch.Tensor))
        return out


def fake_inputs(cfg: ArchConfig, shape: Shape, device: torch.device,
                param_dtype: torch.dtype = torch.bfloat16) -> tuple:
    """The arguments of ``build_step(cfg, shape.kind)``'s step for one
    cell, under an active ``FakeTensorMode`` (the reference's
    ``abstract_inputs`` without shardings): params in ``param_dtype`` (the
    reference's leaf type, bf16, by default); train: AdamW state and a
    batch; prefill: the batch without labels; decode: a cache of
    ``seq_len`` positions (encdec's holding the cross K/V of
    ``min(seq_len, 4096)`` frames), a token and the last position.  An encdec batch is ``seq_len`` frames and ``max(seq_len //
    4, 64)`` text tokens, as the reference's."""
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init_params(gen, cfg, dtype=param_dtype)
    gb, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        frames = min(s, _DECODE_ENC_FRAMES) if cfg.family == "encdec" else 0
        cache = lm.init_cache(cfg, gb, s, enc_frames=frames, params=params,
                              device=device)
        token = torch.empty((gb, 1), dtype=torch.int32, device=device)
        return params, cache, token, s - 1
    if cfg.family == "encdec":
        batch = lm_batch_specs(cfg, gb, max(s // 4, 64), enc_frames=s,
                               device=device)
    else:
        batch = lm_batch_specs(cfg, gb, s, device=device)
    if shape.kind == "prefill":
        batch.pop("labels")
        return params, batch
    if shape.kind == "train":
        return params, adamw(1e-4)[0](lm.param_tree(params)), batch
    raise ValueError(shape.kind)


def _card(device: torch.device):
    """(peaks, memory bytes) of the card the trace is held to: the card
    itself on CUDA, an H100 SXM with 80 GB otherwise."""
    if device.type == "cuda":
        return (card_peaks(torch.cuda.get_device_name(device)),
                torch.cuda.get_device_properties(device).total_memory)
    return card_peaks("H100 SXM"), H100_MEMORY


def model_flops(cfg: ArchConfig, shape: Shape) -> float:
    """The reference's useful flops of one step: 6·N·D for training, a
    third of that (2·N·D, forward only) otherwise, D the step's tokens."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    flops = 6 * cfg.active_param_count() * tokens
    return flops if shape.kind == "train" else flops / 3


def trace_step(cfg: ArchConfig, shape: Shape, *,
               device: DeviceLike = None,
               param_dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """One step of ``shape.kind`` for ``cfg`` traced on fake tensors on
    ``device`` (``None`` → the card), weights in ``param_dtype``: the
    cell-independent part of :func:`dryrun_cell`'s record (``kind``,
    ``mesh``, ``n_chips``, ``trace_s``, the counted flops and bytes,
    ``memory``, ``roofline``, ``model_flops_global``,
    ``useful_flops_ratio``, ``fits``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = resolve_device(device)
    peaks, capacity = _card(dev)
    t0 = time.perf_counter()
    with FakeTensorMode():
        args = fake_inputs(cfg, shape, dev, param_dtype)
        step = build_step(cfg, shape.kind)
        mem = PeakMemory(dev)
        inputs = tensors_in(args)
        mem.hold(inputs)
        argument_bytes = mem.live
        with mem, WorkCounter() as work:
            out = step(*args)
        held = {id(t.untyped_storage()) for t in inputs}
        output_bytes = mem.storage_bytes(
            t for t in tensors_in(out) if id(t.untyped_storage()) not in held)
        peak = mem.peak
        del out, args, inputs, step
    trace_s = time.perf_counter() - t0
    useful = model_flops(cfg, shape)
    return {
        "kind": shape.kind, "mesh": "1", "n_chips": 1,
        "device": dev.type,
        "trace_s": round(trace_s, 2),
        "hlo_flops_per_device": work.flops,
        "hlo_bytes_per_device": work.bytes,
        "collective_wire_bytes_per_device": 0,
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": max(peak - argument_bytes - output_bytes, 0),
            "peak_bytes": peak,
        },
        "roofline": roofline_terms(work.flops, work.bytes, 0, 1,
                                   peaks=peaks),
        "model_flops_global": useful,
        "useful_flops_ratio": useful / max(work.flops, 1.0),
        "device_memory_bytes": capacity,
        "fits": peak <= capacity,
    }


def dryrun_cell(arch: str, shape_name: str, *, device: DeviceLike = None,
                verbose: bool = True) -> Dict[str, Any]:
    """Trace one cell on one device; return its roofline record (the
    reference's keys that have a meaning on one card, ``trace_s`` in
    place of ``compile_s``)."""
    rec = {"arch": arch, "shape": shape_name,
           **trace_step(get_config(arch), SHAPES[shape_name], device=device)}
    if verbose:
        t = rec["roofline"]
        m = rec["memory"]
        print(f"[{rec['device']}] {arch} × {shape_name}: trace "
              f"{rec['trace_s']:.1f}s  flops/dev="
              f"{rec['hlo_flops_per_device']:.3g} bytes/dev="
              f"{rec['hlo_bytes_per_device']:.3g}  dominant={t['dominant']}"
              f"  t=({t['t_compute'] * 1e3:.2f}, {t['t_memory'] * 1e3:.2f},"
              f" {t['t_collective'] * 1e3:.2f}) ms")
        print(f"    memory: args={m['argument_bytes']} temp="
              f"{m['temp_bytes']} peak={m['peak_bytes']} fits={rec['fits']}")
    return rec


def _cell(job) -> tuple:
    """One cell in a worker process: (record or None, the error's
    traceback or None, what it printed)."""
    import contextlib
    import io

    arch, shape, device = job
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rec = dryrun_cell(arch, shape, device=device)
        return rec, None, buf.getvalue()
    except Exception:  # noqa: BLE001
        return None, traceback.format_exc(), buf.getvalue()
    finally:
        gc.collect()


def _trace_order(job) -> Tuple[int, int]:
    """The order in which the pool starts the cells, the longest traces
    first so that none starts last: the scanned families (``ssm``,
    ``hybrid``) before the others, train before prefill before the
    rest."""
    arch, shape, _ = job
    scanned = get_config(arch).family in ("ssm", "hybrid")
    kind = {"train": 0, "prefill": 1}.get(SHAPES[shape].kind, 2)
    return (0 if scanned else 1, kind)


def _run_cells(jobs, n_workers: int):
    """(record or None, traceback or None, printed) of each cell, in
    order: here one after another, or over ``n_workers`` processes of
    their own (spawned: no CUDA state inherited; started in
    :func:`_trace_order`), each cell in a fresh ``FakeTensorMode``."""
    if n_workers <= 1:
        yield from map(_cell, jobs)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            max_workers=n_workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        started = {i: pool.submit(_cell, jobs[i]) for i in sorted(
            range(len(jobs)), key=lambda i: _trace_order(jobs[i]))}
        for i in range(len(jobs)):
            yield started[i].result()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2x16x16 mesh (not on one card)")
    ap.add_argument("--single-pod", action="store_true",
                    help="the reference's 16x16 mesh (not on one card)")
    ap.add_argument("--out", default=None, help="write records JSON here")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card's path) or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes sharing the cells (default 1: "
                         "this process, one cell after another)")
    args = ap.parse_args(argv)
    if args.multi_pod or args.single_pod:
        raise NotImplementedError(
            "the dry run's pod meshes are ROADMAP Queue 1 item 10.3 (one "
            "rank of the pod mesh traced on fake tensors); without "
            "--multi-pod / --single-pod it traces every cell on one device")
    device = resolve_device(args.device)

    records: List[Dict[str, Any]] = []
    failures = []
    t0 = time.perf_counter()
    jobs = []
    for arch, shape, ok, reason in all_cells(include_skipped=True):
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        if not ok:
            print(f"[skip] {arch} × {shape}: {reason}")
            records.append({"arch": arch, "shape": shape, "skipped": True,
                            "reason": reason})
            continue
        jobs.append((arch, shape, str(device)))
    for (arch, shape, _), (rec, error, printed) in zip(
            jobs, _run_cells(jobs, args.jobs)):
        print(printed, end="", flush=True)
        if rec is not None:
            records.append(rec)
        else:
            print(error, file=sys.stderr)
            failures.append((arch, shape, error.strip().splitlines()[-1]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {len(records)} records to {args.out}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print(" ", f_)
        raise SystemExit(1)
    print(f"\nall {len(records)} cells passed in "
          f"{time.perf_counter() - t0:.1f}s ({args.jobs} process"
          f"{'es' if args.jobs > 1 else ''})")


if __name__ == "__main__":
    main()
