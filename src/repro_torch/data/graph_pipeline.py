"""Graph mini-batch pipeline: sampler → host batches, plus the background
:class:`Prefetcher` and the staged chain :class:`StagedPrefetcher` (port of
:mod:`repro.data.graph_pipeline`).

:class:`GraphBatchPipeline` is the restartable epoch stream: the epoch
permutation comes from ``(seed, epoch)`` and each batch's sampling
generator from ``(seed, epoch, batch_idx)``, so a restore from a
checkpoint replays the exact remaining batches.  :class:`Prefetcher` runs
a per-batch host transform on a producer thread behind a depth-``k``
bounded queue; in the port that transform is numpy work only (sampling,
the feature gather and the per-batch edge-table build), and placement on
the card happens on the consuming thread: a host-to-device copy issued
from a producer thread would run on that thread's current stream, and the
step would need an event to wait on it.  Every queue slot carries the
pipeline state that regenerates the NEXT batch, so checkpointing with
batches in flight restores batch-exact.

:class:`StagedPrefetcher` chains several such stages, each on its own
thread.  With a feature store the Trainer runs sample → ``gather`` →
``layout`` on producer threads (the reference's fourth stage, ``place``,
stays on the consuming thread, as above), so batch *i+2*'s store gather
overlaps batch *i+1*'s table build and batch *i*'s step.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.graph.datasets import GraphDataset
from repro_torch.graph.sampler import MiniBatch, NeighborSampler


def sample_batch(dataset: GraphDataset, sampler: NeighborSampler,
                 seeds: np.ndarray, nnz_pad, rng: np.random.Generator
                 ) -> Tuple[MiniBatch, np.ndarray]:
    """The feature-free half of batch assembly: ``(mb, labels)``.

    Labels are row-fancy-indexed (single-label ``[n]`` ints and multilabel
    ``[n, c]`` rows alike) with padded seed rows zero-padded — they index
    GLOBAL node 0's label, a placeholder (val accuracy scores only the
    first ``len(seeds)`` rows).  The staged store pipeline runs this
    stage alone and gathers the features in a stage of its own."""
    mb = sampler.sample(seeds, nnz_pad=nnz_pad, rng=rng)
    pad = mb.layers[0].n_dst - len(seeds)
    labels = dataset.labels[np.pad(seeds, (0, pad))]
    return mb, labels


def gather_features(features, input_nodes: np.ndarray,
                    n_nodes: int) -> np.ndarray:
    """THE frontier-gather rule: clamp-index padded frontier slots to the
    last real node, then fancy-index ``features`` — a dense ndarray, a
    :class:`~repro_torch.featurestore.FeatureStore` or a
    :class:`~repro_torch.featurestore.HotVertexCache` alike."""
    return features[np.minimum(input_nodes, n_nodes - 1)]


def assemble_batch(dataset: GraphDataset, sampler: NeighborSampler,
                   seeds: np.ndarray, nnz_pad, rng: np.random.Generator
                   ) -> Tuple[MiniBatch, np.ndarray, np.ndarray]:
    """One sampled batch: ``(mb, features, labels)`` for ``seeds``.

    THE batch-assembly rule, shared by the epoch pipeline and the
    Trainer's validation path so padding/label semantics can never
    diverge: :func:`sample_batch` + :func:`gather_features`."""
    mb, labels = sample_batch(dataset, sampler, seeds, nnz_pad, rng)
    feats = gather_features(dataset.features, mb.input_nodes,
                            dataset.graph.n_nodes)
    return mb, feats, labels


@dataclasses.dataclass
class GraphBatchPipeline:
    """Restartable epoch stream of sampled batches.

    ``defer_gather=False`` (default) yields ``(mb, feats, labels)``, the
    features gathered inline.  ``defer_gather=True`` yields ``(mb,
    labels)`` and leaves the gather to a later stage (the out-of-core store
    path: sampling need not wait on store traffic it could overlap)."""

    dataset: GraphDataset
    sampler: NeighborSampler
    batch_size: int
    seed: int = 0
    epoch: int = 0
    batch_idx: int = 0
    defer_gather: bool = False

    def _perm(self) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch]))
        return rng.permutation(self.dataset.graph.n_nodes)

    @property
    def batches_per_epoch(self) -> int:
        return self.dataset.graph.n_nodes // self.batch_size

    def __iter__(self) -> Iterator[Tuple[MiniBatch, np.ndarray, np.ndarray]]:
        return self

    def __next__(self):
        perm = self._perm()
        n_batches = len(perm) // self.batch_size
        if self.batch_idx >= n_batches:
            self.epoch += 1
            self.batch_idx = 0
            perm = self._perm()
        s = self.batch_idx * self.batch_size
        seeds = perm[s:s + self.batch_size]
        # per-batch generator keyed by (seed, epoch, batch): resume-exact
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, self.batch_idx]))
        self.batch_idx += 1
        nnz_pad = self.sampler.static_nnz(self.batch_size)
        if self.defer_gather:
            return sample_batch(self.dataset, self.sampler, seeds,
                                nnz_pad, rng)
        return assemble_batch(self.dataset, self.sampler, seeds,
                              nnz_pad, rng)

    def state(self) -> Dict[str, int]:
        return {"seed": self.seed, "epoch": self.epoch,
                "batch_idx": self.batch_idx}

    def restore(self, state: Dict[str, int]) -> None:
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self.batch_idx = int(state["batch_idx"])


class Prefetcher:
    """Depth-``k`` background producer over a restartable batch source.

    ``source`` is any iterator with the pipeline contract (``__next__`` +
    ``state()``/``restore()``); ``prepare`` is the per-batch host transform
    run ON THE PRODUCER THREAD (in the port: numpy work only, the feature
    gather or the layout build; placement on the card stays on the
    consuming thread).

    Restart contract: every queue slot carries ``source.state()`` captured
    AFTER its batch was drawn — i.e. the state that regenerates the *next*
    batch.  ``state()`` returns the snapshot belonging to the last consumed
    batch, so checkpoint-then-restore replays exactly the batches still in
    flight (queued but unconsumed work is regenerated, never skipped or
    double-consumed).

    Stall accounting: ``stall_s`` accumulates the time ``__next__`` spent
    blocked on the queue — host time the consumer could not hide.
    """

    _DONE = object()

    def __init__(self, source, prepare: Optional[Callable[..., Any]] = None,
                 depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.source = source
        self.prepare = prepare
        self.depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._consumed_state = source.state()
        self.stall_s = 0.0
        self.n_consumed = 0

    # -- producer -----------------------------------------------------------
    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                item = next(self.source)
                state_after = self.source.state()
                if self.prepare is not None:
                    item = self.prepare(*item) if isinstance(item, tuple) \
                        else self.prepare(item)
                # bounded put; poll the stop flag so close() never deadlocks
                # against a full queue
                while not self._stop.is_set():
                    try:
                        self._q.put((state_after, item), timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            self._error = e
            # deliver the sentinel with the same retry-until-stop loop as a
            # normal item: the queue is usually FULL when the producer dies
            # (device step slower than host work), and dropping the
            # sentinel there would leave the consumer blocked on get()
            # forever with the original exception lost
            while not self._stop.is_set():
                try:
                    self._q.put((None, self._DONE), timeout=0.05)
                    break
                except queue.Full:
                    continue

    def _ensure_started(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._produce,
                                            daemon=True)
            self._thread.start()

    # -- consumer -----------------------------------------------------------
    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        self._ensure_started()
        t0 = time.perf_counter()
        state_after, item = self._q.get()
        self.stall_s += time.perf_counter() - t0
        if item is self._DONE:
            err, self._error = self._error, None
            self._thread = None
            raise err if err is not None else StopIteration
        self._consumed_state = state_after
        self.n_consumed += 1
        return item

    def reset_stats(self) -> None:
        self.stall_s = 0.0
        self.n_consumed = 0

    @property
    def stall_per_step(self) -> float:
        return self.stall_s / max(self.n_consumed, 1)

    # -- restartable-stream contract ----------------------------------------
    def state(self) -> Dict[str, int]:
        """The source state as of the last CONSUMED batch — in-flight
        (prefetched but unconsumed) batches are excluded, so a restore
        regenerates them."""
        return dict(self._consumed_state)

    def restore(self, state: Dict[str, int]) -> None:
        """Drain the queue, rewind the source, restart production lazily."""
        self.close()
        self.source.restore(state)
        self._consumed_state = self.source.state()

    def close(self) -> None:
        """Stop the producer, drop any queued batches (and any pending
        producer error), and rewind the source to the last CONSUMED batch
        — dropped in-flight work is regenerated on the next ``__next__``,
        never skipped, so stop/start (or checkpoint/restore) keeps the
        stream exact.

        Idempotent and exception-safe: a double close, or a close after
        the producer died (its error is discarded — consume via
        ``__next__`` to observe it), is a no-op beyond re-asserting the
        rewound source state.  :class:`StagedPrefetcher` closes its stages
        through cascading restores, so repeated closes are its normal
        path."""
        thread, self._thread = self._thread, None
        try:
            if thread is not None:
                self._stop.set()
                while thread.is_alive():  # unblock a put-blocked producer
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass
                    thread.join(timeout=0.05)
        finally:
            # queue drain + source rewind run even if the join above blew
            # up — a half-closed prefetcher must never hold stale batches
            self._error = None
            while True:                   # leave the queue empty for restart
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self.source.restore(self._consumed_state)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StagedPrefetcher:
    """A chain of named producer stages, each a :class:`Prefetcher` on its
    own thread with its own bounded queue.

    ``stages`` is a sequence of ``(name, fn)``; stage ``k`` consumes stage
    ``k-1``'s output, so in the Trainer's ``gather → layout`` chain over
    the sampling source, batch *i+2*'s feature gather overlaps batch
    *i+1*'s table build, which overlaps batch *i*'s step.

    The restart contract survives the depth: the Prefetchers chain their
    ``state()`` / ``restore()`` verbatim, so :meth:`state` is the innermost
    source's state as of the last batch consumed from the LAST stage; all
    in-flight work in every queue is dropped and regenerated on restore.

    Stall accounting: :attr:`stall_per_step` is the last stage's stall,
    the queue wait the consumer sees; :meth:`stage_stalls` gives each
    stage's wait on the stage before it.
    """

    def __init__(self, source, stages, depth: int = 2):
        if not stages:
            raise ValueError("StagedPrefetcher needs at least one stage")
        self.source = source
        self.names: Tuple[str, ...] = tuple(name for name, _ in stages)
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate stage names: {list(self.names)}")
        self.stages: List[Prefetcher] = []
        cur = source
        for _, fn in stages:
            cur = Prefetcher(cur, prepare=fn, depth=depth)
            self.stages.append(cur)
        self._tail: Prefetcher = cur

    # -- consumer -----------------------------------------------------------
    def __iter__(self) -> "StagedPrefetcher":
        return self

    def __next__(self):
        return next(self._tail)

    @property
    def stall_s(self) -> float:
        return self._tail.stall_s

    @property
    def n_consumed(self) -> int:
        return self._tail.n_consumed

    @property
    def stall_per_step(self) -> float:
        return self._tail.stall_per_step

    def stage_stalls(self) -> Dict[str, float]:
        """Per stage, its stall seconds per consumed item: the time stage
        ``k`` waited on stage ``k-1`` (the first stage waits on its
        producer, which runs the stage's function after the source)."""
        return {name: st.stall_per_step
                for name, st in zip(self.names, self.stages)}

    def reset_stats(self) -> None:
        for st in self.stages:
            st.reset_stats()

    # -- restartable-stream contract ----------------------------------------
    def state(self) -> Dict[str, int]:
        return self._tail.state()

    def restore(self, state: Dict[str, int]) -> None:
        """Cascades down the chain: every stage drains its queue, then the
        innermost source rewinds to ``state``."""
        self._tail.restore(state)

    def close(self) -> None:
        """Close every stage, tail first: each stage's close rewinds its
        upstream, down to the source (closes are idempotent)."""
        self._tail.close()

    def __enter__(self) -> "StagedPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
