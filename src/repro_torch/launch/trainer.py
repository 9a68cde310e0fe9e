"""Engine-native distributed Trainer on stacked cores (port of
:mod:`repro.launch.trainer`).

One :class:`Trainer` owns the whole loop:

  * **Engine-native** — the step is ``EngineBundle.train_step`` over P
    stacked cores on one device (the paper's P on-chip cores as a leading
    tensor axis), so ``ell+pipelined`` (the ``spmm_ell`` kernel forward,
    ``spmm_ell_t`` backward), ``block+pipelined`` (``spmm_block`` forward,
    the flat ``spmm`` backward) and the ``coo+serial`` oracle (``spmm``
    both ways) train unchanged, over any registered topology, either
    partition and either merge level.  The topology validates the core
    count when the Trainer is built.
  * **Plan report** — each batch's host-side partition/merge accounting
    (exchange wire bytes, virtual vertices, pair coverage, flop reduction)
    is kept as ``last_plan_report`` and returned by :meth:`fit` as
    ``"plan"``.
  * **Async input pipeline** — sampling and the per-batch edge-table build
    (``bundle.prepare_batch``: ELL tables, or Block-Message tiles and their
    row groupings; host work) run on a
    :class:`~repro_torch.data.Prefetcher` thread with depth-2 double
    buffering; the consuming thread places the batch on the card
    (``commit_batch``).  ``input_pipeline="sync"`` runs the same work
    inline.  Host stall per step counts the queue wait plus the placement.
  * **Out-of-core features** — with a feature store (``feature_store=``, or
    a store-backed dataset) only each batch's frontier rows leave the
    store, through an optional degree-keyed
    :class:`~repro_torch.featurestore.HotVertexCache`, and the prefetch
    pipeline becomes a :class:`~repro_torch.data.StagedPrefetcher`:
    sample → ``gather`` → ``layout`` on producer threads, each behind its
    own queue.  The reference's fourth stage, ``place``, stays on the
    consuming thread, as on the dense path: a host-to-device copy issued
    from a producer thread would run on that thread's current stream and
    the step would need an event to wait on it.  :meth:`fit` reports the
    two threaded stages' stalls (``stage_stall_s_per_step``) and the
    consuming thread's placement (``place_s_per_step``).
  * **Epoch metrics** — validation accuracy on held-out seed sets,
    wall-clock, steps/s and host stall per step.
  * **Checkpoint/resume** — params + progress counters + pipeline state
    through :class:`~repro_torch.checkpoint.CheckpointManager` in the
    reference's layout, so the port resumes the reference's checkpoints
    and a mid-epoch restore replays the in-flight batches exactly.

  * **Across processes** — ``Trainer(..., n_cores=P, mesh=mesh)`` spreads
    the P cores over the ranks of the mesh's ``model`` dimension
    (:func:`repro_torch.launch.mesh.make_topology_mesh`): every rank
    samples the same batch from the same seed and builds the same host
    plan, then places and walks only its cores' part; the engine's
    topology (any built-in) folds across ranks, the weight gradients are
    all-reduced once a step, and every rank applies the same update.
    Validation counts are all-reduced; checkpoints are written by rank 0
    alone (then a barrier) and every rank resumes from the same files.
  * **``"auto"``** — the spec resolves through
    :mod:`repro_torch.engine.planner` before anything is built, at the
    Trainer's core count on its device; ``requested_spec`` stays
    ``"auto"``, and a resume pins the checkpoint's concrete spec even when
    the planner record changed since.

CPU run (4 stacked cores, plain kernel versions)::

    PYTHONPATH=src python -m repro_torch.launch.trainer --device cpu \\
        --spec ell+pipelined+torus2d+mincom --n-cores 4 --steps 30 \\
        --ckpt-restart

Across N processes, one card each (``--device cpu``: gloo on the CPU)::

    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.trainer \\
        --mesh --spec ell+pipelined --n-cores 16 --steps 30
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.gcn_paper import FANOUTS
from repro_torch.data import (GraphBatchPipeline, Prefetcher,
                              StagedPrefetcher, assemble_batch,
                              gather_features)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import Engine, EngineConfig
from repro_torch.featurestore import FeatureStore, HotVertexCache, get_store
from repro_torch.graph import GraphDataset, NeighborSampler, make_dataset
from repro_torch.models import init_params


class Trainer:
    """One engine spec + one dataset → an epoch loop that trains it.

    Parameters
    ----------
    engine: spec string (``format+schedule[+topology[+partition]]``, e.g.
        ``"ell+pipelined+torus2d+mincom"``, or ``"auto"``),
        :class:`EngineConfig` or :class:`Engine`.
    dataset: a :class:`GraphDataset` or a dataset name for
        :func:`make_dataset` (with ``scale``/``feat_dim``).
    n_cores: stacked cores (the hypercube size, a power of two).
    mesh: a ``DeviceMesh`` whose ``model`` dimension spreads the
        ``n_cores`` over its ranks (module docstring); ``None`` stacks them
        all here.
    device: where the step runs (``None`` → the card, or the mesh's
        device; raises without one).
    input_pipeline: ``"prefetch"`` (background thread, depth
        ``prefetch_depth``) or ``"sync"`` (host work inline).
    feature_store: where node features live.  ``None`` / ``"device"``
        keeps the dense path (unless the dataset itself is store-backed);
        a registered backend name (``"host"``, ``"mmap"``, …) wraps the
        dataset's dense features into that store, which the Trainer then
        owns and closes; a
        :class:`~repro_torch.featurestore.FeatureStore` is used as it is.
    cache_capacity: rows of the degree-keyed hot-vertex cache in front of
        the store (0 disables); ``cache_pinned`` of them hold the
        top-degree vertices (default: half), the rest are an LRU.  The
        cache's ``device_rows`` live on ``device``.
    device_budget_bytes: a DENSE feature matrix over this many bytes
        refuses to train (pass a ``feature_store``); store-backed features
        are exempt, as only frontier rows ever reach the device.
    pad_multiple: sampler node-count padding; a multiple of ``n_cores``
        (default ``max(16, n_cores)``).
    ckpt_every: save (async) every N global steps when ``ckpt_dir`` is set.
    """

    def __init__(self, engine: Union[str, EngineConfig, Engine],
                 dataset: Union[str, GraphDataset] = "flickr", *,
                 n_cores: int = 1, mesh=None, scale: float = 0.01,
                 feat_dim: Optional[int] = None, hidden: int = 64,
                 batch_size: int = 64, fanouts: Sequence[int] = FANOUTS,
                 lr: Optional[float] = None, seed: int = 0,
                 input_pipeline: str = "prefetch", prefetch_depth: int = 2,
                 pad_multiple: Optional[int] = None, val_batches: int = 2,
                 feature_store: Union[None, str, FeatureStore] = None,
                 cache_capacity: int = 0,
                 cache_pinned: Optional[int] = None,
                 device_budget_bytes: Optional[int] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 log_every: int = 0, device: DeviceLike = None):
        if input_pipeline not in ("prefetch", "sync"):
            raise ValueError(f"unknown input_pipeline {input_pipeline!r}; "
                             "expected 'prefetch' or 'sync'")
        if isinstance(engine, Engine):
            if lr is not None and lr != engine.config.lr:
                raise ValueError(
                    f"lr={lr} conflicts with the prebuilt Engine's "
                    f"config.lr={engine.config.lr}; pass a spec or set the "
                    "lr on the EngineConfig")
        else:
            if isinstance(engine, str):
                engine = EngineConfig.from_spec(
                    engine, **({} if lr is None else {"lr": lr}))
            elif lr is not None:
                engine = EngineConfig(**{**engine.__dict__, "lr": lr})
            engine = Engine(engine)
        self.requested_spec = engine.spec
        if mesh is not None and device is None:
            from repro_torch.distributed.sharding import mesh_device
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.n_cores = int(n_cores)
        # a run plans once, before anything is built: resume pins this
        # resolved spec and never re-plans mid-run
        self.engine = engine.resolve(self.n_cores, device=self.device)
        if isinstance(dataset, str):
            dataset = make_dataset(dataset, scale=scale, feat_dim=feat_dim)
        self.dataset = dataset
        self._init_features(feature_store, cache_capacity, cache_pinned,
                            device_budget_bytes)
        self.bundle = self.engine.build(n_cores=self.n_cores, mesh=mesh,
                                        device=self.device)
        self.batch_size = batch_size
        self.seed = seed
        self.input_pipeline = input_pipeline
        self.log_every = log_every
        pad = pad_multiple if pad_multiple is not None \
            else max(16, self.n_cores)
        if pad % self.n_cores:
            raise ValueError(f"pad_multiple={pad} must be a multiple of "
                             f"n_cores={self.n_cores} so every hop splits "
                             "evenly across the cores")
        if dataset.graph.n_nodes < batch_size:
            raise ValueError(
                f"batch_size={batch_size} exceeds the dataset's "
                f"{dataset.graph.n_nodes} nodes; an epoch would hold no "
                "full batch")
        self.sampler = NeighborSampler(dataset.graph, fanouts=fanouts,
                                       pad_multiple=pad, seed=seed)
        self.pipeline = GraphBatchPipeline(
            dataset, self.sampler, batch_size, seed=seed,
            defer_gather=self.store is not None)
        self._nnz_pad = self.sampler.static_nnz(batch_size)
        if input_pipeline != "prefetch":
            self.fetcher = None
        elif self.store is not None:
            # batch i+2's store gather hides under batch i+1's table build,
            # which hides under batch i's step
            self.fetcher = StagedPrefetcher(
                self.pipeline, [("gather", self._gather_stage),
                                ("layout", self.bundle.prepare_batch)],
                depth=prefetch_depth)
        else:
            self.fetcher = Prefetcher(self.pipeline,
                                      prepare=self.bundle.prepare_batch,
                                      depth=prefetch_depth)
        feat = dataset.features.shape[1]
        dims = [feat] + [hidden] * (len(fanouts) - 1) \
            + [dataset.stats.n_classes]
        self.params = init_params(seed, list(zip(dims[:-1], dims[1:])),
                                  device=self.device)
        self.mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.global_step = 0
        self.epochs_done = 0
        # held-out validation seeds: derived from the seed, never from the
        # training stream — identical across resume boundaries
        val_rng = np.random.default_rng(
            np.random.SeedSequence([seed, 9001]))
        self._val_seed_sets = [
            val_rng.permutation(dataset.graph.n_nodes)[:batch_size]
            for _ in range(val_batches)]
        self._val_batches: Optional[List[Any]] = None
        self.history: List[float] = []
        self.last_plan_report: Optional[Dict[str, float]] = None
        self._stall_s = 0.0
        self._place_s = 0.0
        self._stall_steps = 0

    # -- feature residency ---------------------------------------------------
    def _init_features(self, feature_store, cache_capacity: int,
                       cache_pinned: Optional[int],
                       device_budget_bytes: Optional[int]) -> None:
        """Dense features on the device path, or an out-of-core store
        (and its hot-vertex cache) that the batches gather from."""
        self._owned_store = False
        feats = self.dataset.features
        store: Optional[FeatureStore] = None
        if isinstance(feature_store, FeatureStore):
            store = feature_store
        elif isinstance(feats, FeatureStore):
            # generated out of core: train from the dataset's store
            # whatever the flag says (densifying it defeats the point)
            store = feats
        elif feature_store not in (None, "device"):
            store = get_store(feature_store).from_array(np.asarray(feats))
            self._owned_store = True
        if device_budget_bytes is not None and store is None \
                and feats.nbytes > device_budget_bytes:
            raise ValueError(
                f"dense features are {feats.nbytes} bytes — over the "
                f"device_budget_bytes={device_budget_bytes} budget; pass "
                "feature_store='host' or 'mmap' so only each batch's "
                "frontier rows ever occupy device memory")
        self.store = store
        self.cache: Optional[HotVertexCache] = None
        if store is not None and cache_capacity > 0:
            indptr = self.dataset.graph.indptr
            self.cache = HotVertexCache(store, indptr[1:] - indptr[:-1],
                                        cache_capacity, pinned=cache_pinned,
                                        device=self.device)
        self._gather_src = self.cache if self.cache is not None else store
        self.feature_mode = "device" if store is None \
            else getattr(store, "name", "custom")

    # -- input pipeline ------------------------------------------------------
    def _gather_stage(self, mb, labels):
        """The store stage: the frontier rows out of the feature store,
        through the hot-vertex cache when there is one."""
        feats = gather_features(self._gather_src, mb.input_nodes,
                                self.dataset.graph.n_nodes)
        return mb, feats, labels

    def _next_batch(self) -> Dict[str, Any]:
        """The next batch on the device.  Host stall = what the step waited
        for: the queue pop (prefetch) or the inline sampling, gather and
        table build (sync), plus the placement on the card, which is also
        counted on its own."""
        t0 = time.perf_counter()
        if self.fetcher is not None:
            host = next(self.fetcher)
        else:
            item = next(self.pipeline)
            if self.store is not None:   # defer_gather stream: (mb, labels)
                item = self._gather_stage(*item)
            host = self.bundle.prepare_batch(*item)
        t1 = time.perf_counter()
        batch = self.bundle.commit_batch(host)
        t2 = time.perf_counter()
        self._stall_s += t2 - t0
        self._place_s += t2 - t1
        self._stall_steps += 1
        return batch

    @property
    def stall_per_step(self) -> float:
        """Host seconds per consumed batch that the step waited for."""
        return self._stall_s / max(self._stall_steps, 1)

    @property
    def place_per_step(self) -> float:
        """Host seconds per consumed batch spent placing it on the device
        (part of :attr:`stall_per_step`)."""
        return self._place_s / max(self._stall_steps, 1)

    def reset_stall_stats(self) -> None:
        if self.fetcher is not None:
            self.fetcher.reset_stats()
        self._stall_s = 0.0
        self._place_s = 0.0
        self._stall_steps = 0

    # -- checkpoint/resume ---------------------------------------------------
    def _pipeline_state(self) -> Dict[str, int]:
        return self.fetcher.state() if self.fetcher is not None \
            else self.pipeline.state()

    def _extra(self) -> Dict[str, Any]:
        return {"step": self.global_step, "epochs_done": self.epochs_done,
                "pipeline": self._pipeline_state(),
                "spec": self.engine.spec,
                "requested_spec": self.requested_spec}

    def save(self, *, sync: bool = False) -> None:
        """Checkpoint (async unless ``sync``).  On a mesh rank 0 alone
        writes, synchronously, and every rank waits at a barrier."""
        if self.mgr is None:
            return
        if self.mesh is None:
            fn = self.mgr.save if sync else self.mgr.save_async
            fn(self.global_step, self.params, extra=self._extra())
            return
        import torch.distributed as dist
        if dist.get_rank() == 0:
            self.mgr.save(self.global_step, self.params, extra=self._extra())
        dist.barrier(group=self.bundle.layout.group)

    def resume(self) -> bool:
        """Restore the newest checkpoint (params + progress + the exact
        next-batch position).  Returns False when none exists."""
        if self.mgr is None:
            return False
        hit = self.mgr.restore_latest(self.params)
        if hit is None:
            return False
        self.params, extra, _ = hit
        saved_spec = extra.get("spec")
        if self.requested_spec == "auto" and saved_spec \
                and saved_spec != self.engine.spec:
            # the checkpoint pins the concrete spec its auto run resolved
            # at launch: a resume continues bit-exactly on those wires
            self._rebind(saved_spec)
        self.global_step = int(extra["step"])
        self.epochs_done = int(extra.get("epochs_done", 0))
        if self.fetcher is not None:
            self.fetcher.restore(extra["pipeline"])
        else:
            self.pipeline.restore(extra["pipeline"])
        return True

    def _rebind(self, spec: str) -> None:
        """Swap the concrete engine and its bundle; batches prepared or
        placed through the old bundle (queued or validation) are
        dropped."""
        engine = Engine(self.engine.config.with_spec(spec))
        engine.topology.validate_cores(self.n_cores)
        self.engine = engine
        self.bundle = engine.build(n_cores=self.n_cores, mesh=self.mesh,
                                   device=self.device)
        if self.fetcher is not None:
            self.fetcher.close()
            layout = self.fetcher.stages[-1] \
                if isinstance(self.fetcher, StagedPrefetcher) \
                else self.fetcher
            layout.prepare = self.bundle.prepare_batch
        self._val_batches = None

    def close(self) -> None:
        if self.fetcher is not None:
            self.fetcher.close()
        if self._owned_store and self.store is not None:
            # only a store the Trainer wrapped itself: a dataset's or a
            # caller's store may be shared and outlives this Trainer
            self.store.close()
        if self.mgr is not None:
            self.mgr.wait()

    # -- the loop ------------------------------------------------------------
    def train_steps(self, n_steps: int) -> List[float]:
        """Run ``n_steps`` optimizer steps; returns their losses."""
        losses: List[float] = []
        for _ in range(n_steps):
            batch = self._next_batch()
            self.last_plan_report = dict(batch["report"])
            self.params, loss = self.bundle.train_step(self.params, batch)
            losses.append(float(loss))
            self.global_step += 1
            if self.log_every and self.global_step % self.log_every == 0:
                print(f"step {self.global_step:5d}  loss "
                      f"{losses[-1]:.4f}  stall/step "
                      f"{self.stall_per_step * 1e3:.1f} ms")
            if self.mgr and self.ckpt_every \
                    and self.global_step % self.ckpt_every == 0:
                self.save()
        self.history.extend(losses)
        return losses

    def _build_val_batches(self) -> List[Any]:
        """Sampled, built and placed once: the seed sets and per-batch
        generators are fixed at construction."""
        batches = []
        for seeds in self._val_seed_sets:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, 7, int(seeds[0])]))
            mb, feats, labels = assemble_batch(self.dataset, self.sampler,
                                               seeds, self._nnz_pad, rng)
            batches.append((len(seeds), self.bundle.shard_batch(
                mb, feats, labels)))
        return batches

    def evaluate(self) -> float:
        """Validation accuracy on the held-out seed sets (padded rows
        masked; multilabel datasets score the argmax proxy).  On a mesh
        each rank scores its cores' rows and the counts are all-reduced."""
        if self._val_batches is None:
            self._val_batches = self._build_val_batches()
        hits = total = 0
        for n_seeds, batch in self._val_batches:
            logits = self.bundle.forward(self.params, batch, gather=False)
            rows = self.bundle.local_rows(batch["n_rows"])
            keep = torch.arange(rows.start, rows.stop,
                                device=logits.device) < n_seeds
            hits += int(((logits.argmax(-1) == batch["labels"])
                         & keep).sum())
            total += n_seeds
        if self.mesh is not None:
            import torch.distributed as dist
            count = torch.tensor([hits], dtype=torch.int64,
                                 device=self.device)
            dist.all_reduce(count, group=self.bundle.layout.group)
            hits = int(count)
        return hits / max(total, 1)

    def fit(self, epochs: int = 1, *, steps_per_epoch: Optional[int] = None,
            max_steps: Optional[int] = None, resume: bool = False
            ) -> Dict[str, Any]:
        """Epoch loop: train → validate → record metrics (+ checkpoint).

        ``steps_per_epoch`` defaults to the dataset's full epoch;
        ``max_steps`` caps the TOTAL (global) step count, so a resumed run
        continues to the same horizon as an uninterrupted one.
        """
        if resume:
            self.resume()
        spe = steps_per_epoch if steps_per_epoch is not None \
            else self.pipeline.batches_per_epoch
        out: Dict[str, Any] = {"spec": self.engine.spec,
                               "requested_spec": self.requested_spec,
                               "n_cores": self.n_cores,
                               "device": str(self.device),
                               "input_pipeline": self.input_pipeline,
                               "feature_store": self.feature_mode,
                               "loss_history": [], "val_acc": [],
                               "epoch_s": [], "steps_per_s": [],
                               "host_stall_s_per_step": []}
        t_all = time.time()
        try:
            for _ in range(self.epochs_done, epochs):
                budget = spe
                if max_steps is not None:
                    budget = min(budget, max_steps - self.global_step)
                if budget <= 0:
                    break
                self.reset_stall_stats()
                t0 = time.time()
                losses = self.train_steps(budget)
                dt = time.time() - t0
                out["loss_history"].extend(losses)
                out["epoch_s"].append(dt)
                out["steps_per_s"].append(len(losses) / max(dt, 1e-9))
                out["host_stall_s_per_step"].append(self.stall_per_step)
                out["val_acc"].append(self.evaluate())
                self.epochs_done += 1
                if self.log_every:
                    print(f"epoch {self.epochs_done}: loss "
                          f"{losses[-1]:.4f}  val_acc "
                          f"{out['val_acc'][-1]:.3f}  "
                          f"{out['steps_per_s'][-1]:.1f} steps/s  "
                          f"stall/step "
                          f"{out['host_stall_s_per_step'][-1] * 1e3:.1f} ms")
                if self.mgr is not None:
                    self.save()
        finally:
            self.close()
        out["wall_s"] = time.time() - t_all
        out["global_step"] = self.global_step
        out["params"] = self.params
        if self.store is not None:
            out["gather_calls"] = int(self.store.gather_calls)
            out["gather_bytes"] = int(self.store.bytes_gathered)
            if self.cache is not None:
                out["cache"] = self.cache.stats()
        if self.last_plan_report:
            # the last train batch's partition/merge accounting
            out["plan"] = dict(self.last_plan_report)
        if isinstance(self.fetcher, StagedPrefetcher):
            # the last epoch's stalls of the two threaded stages (each
            # stage's wait on the one before it) and the placement on the
            # consuming thread
            out["stage_stall_s_per_step"] = self.fetcher.stage_stalls()
            out["place_s_per_step"] = self.place_per_step
        return out


# ---------------------------------------------------------------------------
# CLI — train, or checkpoint mid-run, restart and resume.
# ---------------------------------------------------------------------------
def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", default="ell+pipelined",
                    help="engine spec format+schedule[+topology[+partition]]"
                         " (repro_torch.engine.supported_specs(three_part="
                         "True), then naive or mincom), or auto (the "
                         "planner's pick)")
    ap.add_argument("--dataset", default="flickr")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--feat-dim", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--n-cores", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--input-pipeline", default="prefetch",
                    choices=["prefetch", "sync"])
    ap.add_argument("--feature-store", default="device",
                    help="'device' (dense features, the default) or a "
                         "registered feature store ('host', 'mmap') to "
                         "gather frontier rows out of core")
    ap.add_argument("--cache-capacity", type=int, default=0,
                    help="hot-vertex cache rows in front of the store "
                         "(0 disables; needs --feature-store)")
    ap.add_argument("--cache-pinned", type=int, default=None,
                    help="cache rows pinned to the top-degree vertices "
                         "(default: half the capacity)")
    ap.add_argument("--pad-multiple", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-restart", action="store_true",
                    help="checkpoint at the midpoint, rebuild the Trainer, "
                         "resume, and assert the resumed trajectory matches"
                         " an uninterrupted run")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--mesh", action="store_true",
                    help="spread the cores over the processes torchrun "
                         "started (RANK, WORLD_SIZE, LOCAL_RANK): NCCL, a "
                         "card each; gloo with --device cpu")
    args = ap.parse_args(argv)
    mesh = _mesh_from_env(args) if args.mesh else None
    say = print if mesh is None or mesh.get_rank() == 0 else _quiet
    try:
        _run(args, mesh, say)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _quiet(*_a, **_k) -> None:
    pass


def _mesh_from_env(args):
    """The process group from torchrun's environment and the spec's
    topology's mesh over it; each rank on ``cuda:LOCAL_RANK`` (or the
    CPU)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_topology_mesh

    cpu = args.device == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    # "auto" validates the mesh against the topology the planner picks
    # (pure reads: the Trainer's own resolve gives the same spec)
    engine = Engine(args.spec).resolve(args.n_cores,
                                       device="cpu" if cpu else None)
    return make_topology_mesh(args.n_cores, engine.config.topology,
                              device_type="cpu" if cpu else "cuda")


def _run(args, mesh, say) -> None:
    def build(ckpt: Optional[str]) -> Trainer:
        fs = None if args.feature_store == "device" else args.feature_store
        return Trainer(args.spec, args.dataset, n_cores=args.n_cores,
                       scale=args.scale, feat_dim=args.feat_dim,
                       hidden=args.hidden, batch_size=args.batch_size,
                       lr=args.lr, seed=args.seed,
                       input_pipeline=args.input_pipeline,
                       pad_multiple=args.pad_multiple, feature_store=fs,
                       cache_capacity=args.cache_capacity,
                       cache_pinned=args.cache_pinned, ckpt_dir=ckpt,
                       ckpt_every=0, log_every=10 if say is print else 0,
                       device=None if mesh is not None else args.device,
                       mesh=mesh)

    if args.ckpt_restart:
        import tempfile
        mid = args.steps // 2
        with tempfile.TemporaryDirectory() as own:
            ckpt = own
            if mesh is not None:    # every rank checkpoints under rank 0's
                import torch.distributed as dist
                box = [own]
                dist.broadcast_object_list(box, src=0)
                ckpt = box[0]
            full = build(None)
            ref = full.fit(1, steps_per_epoch=args.steps)
            part = build(ckpt)
            part.train_steps(mid)
            part.save(sync=True)
            part.close()
            resumed = build(ckpt)
            out = resumed.fit(1, steps_per_epoch=args.steps - mid,
                              resume=True)
            if mesh is not None:    # rank 0's directory outlives the reads
                dist.barrier()
        drift = max(abs(a - b) for a, b in
                    zip(ref["loss_history"][mid:], out["loss_history"]))
        say(f"resume drift vs uninterrupted: {drift:.2e}")
        if drift > 1e-6:
            raise SystemExit(f"resume drift {drift:.3e} > 1e-6")
        cache = out.get("cache")
        store = f"store={out['feature_store']}" + (
            f" cache_hit_rate={cache['hit_rate']:.2f}" if cache else "")
        say(f"OK spec={args.spec} (resolved {out['spec']}) "
            f"cores={args.n_cores} "
            f"ranks={1 if mesh is None else mesh.size()} "
            f"device={out['device']} steps={args.steps} (ckpt@{mid} + "
            f"resume, batch-exact)  val_acc={out['val_acc'][-1]:.3f}  "
            f"{store}")
        return

    tr = build(args.ckpt_dir)
    out = tr.fit(1, steps_per_epoch=args.steps, resume=args.resume)
    say(f"final loss {out['loss_history'][-1]:.4f}  val_acc "
        f"{out['val_acc'][-1]:.3f}  {out['steps_per_s'][-1]:.1f} steps/s "
        f"({out['wall_s']:.1f}s, stall/step "
        f"{out['host_stall_s_per_step'][-1] * 1e3:.1f} ms) on "
        f"{out['device']}, spec {out['spec']}")


if __name__ == "__main__":
    main()
