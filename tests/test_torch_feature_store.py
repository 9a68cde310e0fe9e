"""Port vs reference: out-of-core feature stores, the hot-vertex cache and
the staged input pipeline, through the Trainer, the InferenceEngine and the
serve CLI, on the CPU.

* ``host`` and ``mmap`` stores gather the reference stores' rows and count
  the same traffic; the chunked writer, ``seal``, ``MmapStore.open`` and
  the owned tempfile behave as the reference's; the registry names its
  stores, and a fresh registration reaches ``make_dataset`` and the
  Trainer;
* ``make_dataset(features="store"|"mmap")`` is bit-identical to the dense
  path and to the reference's store-backed dataset;
* ``HotVertexCache`` gives the reference cache's rows, pinned set and
  ``stats()`` after every call of one fixed frontier sequence, never
  evicts a pinned row, and keeps ``device_rows`` on its device;
* ``StagedPrefetcher`` orders, composes, restores and rewinds like the
  reference's (the reference tests' ``_CountSource``);
* the Trainer trains from a store with the dense run's losses (sync and the
  staged chain), under a device budget only from a store, resumes through
  the staged chain bit-exactly, trains every concrete spec from an mmap
  store at P = 2, and at P = 1 matches the reference Trainer's losses
  (within 1e-5) and cache statistics;
* ``InferenceEngine(feature_cache_capacity=)`` over a store gives the
  reference's logits within 1e-5, the port's dense logits bit for bit,
  and the reference's feature-cache statistics;
* ``repro_torch.launch.serve --smoke`` passes on the CPU.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.featurestore as ref_fs  # noqa: E402
from repro.data import StagedPrefetcher as RefStaged  # noqa: E402
from repro.graph import make_dataset as ref_make_dataset  # noqa: E402
from repro_torch import featurestore as fs  # noqa: E402
from repro_torch.data import (GraphBatchPipeline, StagedPrefetcher,  # noqa: E402
                              gather_features)
from repro_torch.graph import NeighborSampler, make_dataset  # noqa: E402
from repro_torch.launch.trainer import Trainer  # noqa: E402

BACKENDS = ["host", "mmap"]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Tiny tensors: one intra-op thread.  The ``coo`` layer's many small
    ``index_add_`` calls slow a hundredfold when every test worker's
    thread pool contends for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_store_gather_and_counters_match_reference(backend, rng):
    ref = rng.standard_normal((50, 8)).astype(np.float32)
    frontiers = [np.array([0, 49, 3, 3, 17]), np.arange(50)[::7],
                 np.array([], np.int64), np.array([12])]
    with fs.get_store(backend).from_array(ref, chunk_rows=16) as port, \
            ref_fs.get_store(backend).from_array(ref, chunk_rows=16) as want:
        assert type(port).name == backend
        assert port.shape == want.shape == (50, 8) and port.ndim == 2
        assert len(port) == 50 and port.nbytes == ref.nbytes
        assert port.dtype == np.float32
        for idx in frontiers:
            got = port.gather(idx)
            np.testing.assert_array_equal(got, want.gather(idx))
            np.testing.assert_array_equal(port[idx], want[idx])
            assert got.dtype == np.float32 and got.shape == (len(idx), 8)
        np.testing.assert_array_equal(port.as_array(), want.as_array())
        assert (port.gather_calls, port.bytes_gathered) \
            == (want.gather_calls, want.bytes_gathered) \
            == (8, 2 * (5 + 8 + 0 + 1) * 8 * 4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunked_writer_roundtrip_and_seal(backend, rng):
    ref = rng.standard_normal((40, 4)).astype(np.float32)
    store = fs.get_store(backend).create(40, 4)
    for s in range(0, 40, 13):
        store.write_chunk(s, ref[s:s + 13])
    assert store.seal() is store
    try:
        np.testing.assert_array_equal(store.as_array(), ref)
        with pytest.raises(ValueError, match="sealed"):
            store.write_chunk(0, ref[:1])
    finally:
        store.close()


@pytest.mark.parametrize("pkg", [ref_fs, fs], ids=["reference", "port"])
def test_writer_rejects_bad_chunks(pkg):
    store = pkg.HostStore.create(10, 4)
    with pytest.raises(ValueError, match="feat_dim"):
        store.write_chunk(0, np.zeros((2, 5), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        store.write_chunk(8, np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        store.write_chunk(-1, np.zeros((1, 4), np.float32))


def test_mmap_store_reopens_across_packages(tmp_path, rng):
    ref = rng.standard_normal((30, 6)).astype(np.float32)
    path = str(tmp_path / "feats.npy")
    fs.MmapStore.from_array(ref, path=path).close()
    assert os.path.exists(path)             # a named path is not owned
    for pkg in (fs, ref_fs):                # one self-describing file
        store = pkg.MmapStore.open(path)
        try:
            assert store.shape == (30, 6)
            np.testing.assert_array_equal(store.as_array(), ref)
            with pytest.raises(ValueError, match="sealed"):
                store.write_chunk(0, ref[:1])
        finally:
            store.close()
    assert os.path.exists(path)


def test_mmap_tempfile_unlinked_on_close(rng):
    store = fs.MmapStore.from_array(
        rng.standard_normal((8, 2)).astype(np.float32))
    path = store.path
    assert os.path.exists(path)
    store.close()
    assert not os.path.exists(path)
    store.close()                           # idempotent


def test_registry_names_its_stores():
    assert fs.available_stores() == ref_fs.available_stores() \
        == ["host", "mmap"]
    assert fs.get_store("host") is fs.HostStore
    assert fs.get_store("mmap") is fs.MmapStore
    for pkg in (fs, ref_fs):
        with pytest.raises(ValueError, match=r"unknown feature store 'ssd'"
                                             r".*'host', 'mmap'"):
            pkg.get_store("ssd")


def test_fresh_registration_reaches_make_dataset_and_trainer():
    from repro_torch.featurestore.store import _STORES

    @fs.register_store("testonly")
    class _TestStore(fs.HostStore):
        pass

    try:
        assert fs.get_store("testonly") is _TestStore
        assert "testonly" in fs.available_stores()
        ds = make_dataset("reddit", scale=0.004, feat_dim=8,
                          features="testonly")
        assert isinstance(ds.features, _TestStore)
        dense = make_dataset("reddit", scale=0.004, feat_dim=8)
        tr = Trainer("coo+serial", dense, hidden=8, batch_size=16,
                     input_pipeline="sync", val_batches=1,
                     feature_store="testonly", device="cpu")
        assert tr.feature_mode == "testonly"
        assert np.isfinite(tr.train_steps(1)[0])
        tr.close()
    finally:
        _STORES.pop("testonly", None)


# ---------------------------------------------------------------------------
# make_dataset(features=...)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("features", ["store", "mmap"])
def test_make_dataset_store_bit_identical(features):
    dense = make_dataset("flickr", scale=0.003, seed=7, feat_dim=12)
    ds = make_dataset("flickr", scale=0.003, seed=7, feat_dim=12,
                      features=features, chunk_rows=50)
    ref = ref_make_dataset("flickr", scale=0.003, seed=7, feat_dim=12,
                           features=features, chunk_rows=50)
    try:
        assert isinstance(ds.features, fs.FeatureStore)
        assert ds.features.name == ("host" if features == "store"
                                    else "mmap")
        np.testing.assert_array_equal(ds.features.as_array(), dense.features)
        np.testing.assert_array_equal(ds.features.as_array(),
                                      ref.features.as_array())
        np.testing.assert_array_equal(ds.labels, dense.labels)
        np.testing.assert_array_equal(ds.labels, ref.labels)
        np.testing.assert_array_equal(ds.graph.indptr, ref.graph.indptr)
    finally:
        ds.features.close()
        ref.features.close()


# ---------------------------------------------------------------------------
# HotVertexCache
# ---------------------------------------------------------------------------
def _caches(n=40, d=4, capacity=10, pinned=4, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    # ties in the degrees: the pinned set must break them by vertex id
    degrees = rng.integers(0, 6, n)
    port_store = fs.HostStore.from_array(feats)
    ref_store = ref_fs.HostStore.from_array(feats)
    port = fs.HotVertexCache(port_store, degrees, capacity, pinned=pinned,
                             device="cpu")
    ref = ref_fs.HotVertexCache(ref_store, degrees, capacity, pinned=pinned)
    return port, ref, feats


def test_cache_matches_reference_on_a_frontier_sequence():
    port, ref, feats = _caches()
    assert port.pinned_ids == ref.pinned_ids
    assert len(port.pinned_ids) == 4
    rng = np.random.default_rng(3)
    frontiers = [np.array([0, 0, 0, 5]),             # padded vertex 0
                 np.concatenate([sorted(port.pinned_ids), [1, 2, 3]]),
                 rng.integers(0, 40, 25), np.arange(40),
                 np.array([7, 7, 39, 0]), rng.integers(0, 40, 60),
                 np.array([], np.int64)]
    for ids in frontiers:
        got = port.gather(ids)
        np.testing.assert_array_equal(got, ref.gather(ids))
        np.testing.assert_array_equal(got, feats[ids])
        assert port.stats() == ref.stats()
        assert port.warm_bytes == ref.warm_bytes
        assert port.store.bytes_gathered == ref.store.bytes_gathered
    assert port.evictions > 0 and 0 < port.hit_rate < 1
    np.testing.assert_array_equal(port[np.array([3, 3])], feats[[3, 3]])
    assert port.shape == (40, 4) and len(port) == 40
    assert port.dtype == np.float32
    port.reset_stats()
    ref.reset_stats()
    assert port.stats() == ref.stats()
    assert port.hit_rate == 0.0


def test_cache_never_evicts_pinned_rows(rng):
    feats = rng.standard_normal((64, 4)).astype(np.float32)
    store = fs.HostStore.from_array(feats)
    cache = fs.HotVertexCache(store, np.arange(64, 0, -1), 6, pinned=3,
                              device="cpu")
    pinned = sorted(cache.pinned_ids)
    assert pinned == [0, 1, 2]
    for _ in range(20):                     # churn the 3 dynamic slots
        cache.gather(rng.integers(3, 64, size=8))
    assert cache.evictions > 0
    before = store.bytes_gathered
    np.testing.assert_array_equal(cache.gather(pinned), feats[pinned])
    assert store.bytes_gathered == before   # pure hits
    assert set(pinned) <= set(cache._slot)


@pytest.mark.parametrize("pkg", [ref_fs, fs], ids=["reference", "port"])
def test_cache_rejects_bad_shapes(pkg):
    store = pkg.HostStore.from_array(np.zeros((10, 2), np.float32))
    kw = {} if pkg is ref_fs else {"device": "cpu"}
    with pytest.raises(ValueError, match="capacity"):
        pkg.HotVertexCache(store, np.ones(10), 0, **kw)
    with pytest.raises(ValueError, match="degrees"):
        pkg.HotVertexCache(store, np.ones(9), 4, **kw)


def test_cache_device_rows_are_its_pinned_rows():
    port, ref, feats = _caches()
    rows = port.device_rows
    assert isinstance(rows, torch.Tensor) and rows.device.type == "cpu"
    assert rows is port.device_rows         # built once
    hot = np.array(sorted(port.pinned_ids, key=lambda v: port._slot[v]))
    assert torch.equal(rows, torch.from_numpy(feats[hot]))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref.device_rows))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fs.HotVertexCache(port.store, np.ones(40), 4)


# ---------------------------------------------------------------------------
# StagedPrefetcher (the reference tests' _CountSource)
# ---------------------------------------------------------------------------
class _CountSource:
    def __init__(self):
        self.idx = 0

    def __next__(self):
        out = (self.idx,)
        self.idx += 1
        return out

    def state(self):
        return {"idx": self.idx}

    def restore(self, st):
        self.idx = int(st["idx"])


def _staged(cls=StagedPrefetcher, depth=2):
    return cls(_CountSource(), [("double", lambda i: (i * 2,)),
                                ("plus1", lambda i: i + 1)], depth=depth)


@pytest.mark.parametrize("depth", [1, 2])
def test_staged_prefetcher_orders_composes_and_restores_like_reference(
        depth):
    runs = []
    for cls in (RefStaged, StagedPrefetcher):
        sp = _staged(cls, depth)
        first = [next(sp) for _ in range(4)]
        st = sp.state()
        ahead = [next(sp) for _ in range(3)]   # stages in flight
        sp.restore(st)
        again = [next(sp) for _ in range(3)]
        n = sp.n_consumed
        sp.close()
        runs.append((first, st, ahead, again, n, set(sp.stage_stalls())))
    assert runs[0] == runs[1]
    first, st, ahead, again, _, names = runs[1]
    assert first == [1, 3, 5, 7] and st == {"idx": 4}
    assert ahead == again == [9, 11, 13]       # regenerated, never skipped
    assert names == {"double", "plus1"}


def test_staged_prefetcher_close_rewinds_all_stages():
    import time
    sp = _staged()
    assert next(sp) == 1
    time.sleep(0.2)                            # every stage runs ahead
    sp.close()
    assert sp.source.idx == 1                  # rewound through the chain
    assert next(sp) == 3
    sp.close()
    sp.close()                                 # idempotent
    assert sp.stall_s >= 0 and sp.stall_per_step >= 0
    sp.reset_stats()
    assert sp.n_consumed == 0


def test_staged_prefetcher_validates_stages():
    with pytest.raises(ValueError, match="at least one stage"):
        StagedPrefetcher(_CountSource(), [])
    with pytest.raises(ValueError, match="duplicate"):
        StagedPrefetcher(_CountSource(), [("a", int), ("a", int)])


def test_deferred_gather_stream_equals_the_inline_one():
    ds = make_dataset("reddit", scale=0.004, feat_dim=8)
    store = fs.HostStore.from_array(ds.features)
    inline = GraphBatchPipeline(ds, NeighborSampler(ds.graph, (5, 10)), 32,
                                seed=2)
    deferred = GraphBatchPipeline(ds, NeighborSampler(ds.graph, (5, 10)), 32,
                                  seed=2, defer_gather=True)
    for _ in range(3):
        mb, feats, labels = next(inline)
        dmb, dlabels = next(deferred)
        np.testing.assert_array_equal(dmb.input_nodes, mb.input_nodes)
        np.testing.assert_array_equal(dlabels, labels)
        np.testing.assert_array_equal(
            gather_features(store, dmb.input_nodes, ds.graph.n_nodes), feats)
        assert deferred.state() == inline.state()


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
SMALL = dict(scale=0.005, feat_dim=16, hidden=16, batch_size=16, lr=0.2,
             seed=3, val_batches=1, ckpt_every=0, device="cpu")


def _trainer(pipeline, spec="ell+pipelined", dataset="flickr", n_cores=2,
             **kw):
    args = dict(SMALL)
    if not isinstance(dataset, str):
        args.pop("scale"), args.pop("feat_dim")
    return Trainer(spec, dataset, n_cores=n_cores, input_pipeline=pipeline,
                   **args, **kw)


def test_trainer_store_streams_match_dense_bit_exact():
    ref = _trainer("sync").fit(1, steps_per_epoch=5)
    outs = {pipe: _trainer(pipe, feature_store="mmap", cache_capacity=32,
                           cache_pinned=8).fit(1, steps_per_epoch=5)
            for pipe in ("sync", "prefetch")}
    host = _trainer("prefetch", feature_store="host").fit(
        1, steps_per_epoch=5)
    assert ref["feature_store"] == "device" and "cache" not in ref
    for out in (*outs.values(), host):
        assert out["loss_history"] == ref["loss_history"]
        assert out["val_acc"] == ref["val_acc"]
        assert out["gather_bytes"] > 0 and out["gather_calls"] > 0
    for out in outs.values():
        assert out["feature_store"] == "mmap"
        assert out["cache"]["pinned"] == 8 and out["cache"]["hit_rate"] > 0
    assert host["feature_store"] == "host" and "cache" not in host
    # the staged chain reports its threaded stages; sync has no chain
    assert set(outs["prefetch"]["stage_stall_s_per_step"]) \
        == {"gather", "layout"}
    assert outs["prefetch"]["place_s_per_step"] > 0
    assert "stage_stall_s_per_step" not in outs["sync"]


def test_trainer_trains_from_store_backed_dataset_and_keeps_it_open():
    ds = make_dataset("flickr", scale=0.005, seed=3, feat_dim=16,
                      features="mmap")
    try:
        tr = _trainer("prefetch", dataset=ds, feature_store=None,
                      cache_capacity=16)
        assert tr.store is ds.features and tr.cache.device.type == "cpu"
        out = tr.fit(1, steps_per_epoch=3)
        assert out["feature_store"] == "mmap"    # picked up with no flag
        assert out["gather_bytes"] > 0
        assert all(np.isfinite(out["loss_history"]))
        assert os.path.exists(ds.features.path)  # not the Trainer's
    finally:
        ds.features.close()
    owned = _trainer("sync", feature_store="mmap")
    path = owned.store.path
    owned.fit(1, steps_per_epoch=1)
    assert not os.path.exists(path)              # the Trainer's own


def test_trainer_device_budget_rejects_dense_but_not_store():
    with pytest.raises(ValueError, match="device_budget_bytes"):
        _trainer("sync", device_budget_bytes=1024)
    out = _trainer("sync", feature_store="mmap",
                   device_budget_bytes=1024).fit(1, steps_per_epoch=2)
    assert len(out["loss_history"]) == 2


def test_trainer_resume_through_staged_store_pipeline_is_bit_exact(tmp_path):
    def build(ckpt=None):
        return _trainer("prefetch", feature_store="mmap", cache_capacity=32,
                        ckpt_dir=ckpt)

    full = build()
    full_losses = full.train_steps(8)
    full.close()
    part = build(str(tmp_path))
    part.train_steps(3)
    part.save(sync=True)        # the gather and layout queues hold work
    part.close()
    resumed = build(str(tmp_path))
    assert resumed.resume() is True and resumed.global_step == 3
    assert resumed.train_steps(5) == full_losses[3:]
    resumed.close()


def test_every_concrete_spec_trains_from_mmap_store_at_two_cores():
    from repro_torch.engine import AUTO_SPEC, supported_specs

    dense = make_dataset("flickr", scale=0.005, seed=0, feat_dim=16)
    ds = make_dataset("flickr", scale=0.005, seed=0, feat_dim=16,
                      features="mmap")
    budget = ds.features.nbytes // 4
    specs = [s for s in supported_specs() if s != AUTO_SPEC]
    assert len(specs) >= 3, specs
    try:
        for spec in specs:
            a = _trainer("prefetch", spec, dense, cache_capacity=32)
            b = _trainer("prefetch", spec, ds, cache_capacity=32,
                         device_budget_bytes=budget)
            assert a.store is None and b.store is ds.features
            got, want = b.train_steps(3), a.train_steps(3)
            a.close()
            b.close()
            assert got == want, spec
            assert b.cache.hit_rate > 0, spec
    finally:
        ds.features.close()


def test_trainer_matches_reference_store_trainer_at_one_core(tmp_path):
    """The reference Trainer (one CPU device, in process) saves its step-0
    checkpoint and trains 5 steps from an mmap store behind a 64-row cache;
    the port's Trainer resumes that checkpoint on the same stream."""
    from repro.launch.trainer import Trainer as RefTrainer

    kw = dict(scale=0.004, feat_dim=16, hidden=16, batch_size=32, lr=0.05,
              seed=0, input_pipeline="sync", val_batches=1,
              feature_store="mmap", cache_capacity=64, ckpt_every=0,
              ckpt_dir=str(tmp_path))
    ref = RefTrainer("coo+serial", "reddit", n_cores=1, **kw)
    ref.save(sync=True)
    want = ref.train_steps(5)
    want_stats = ref.cache.stats()
    ref.close()
    port = Trainer("coo+serial", "reddit", n_cores=1, device="cpu", **kw)
    assert port.resume() and port.global_step == 0
    got = port.train_steps(5)
    got_stats = port.cache.stats()
    port.close()
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= 1e-5
    assert got_stats == want_stats


def test_trainer_cli_trains_from_a_cached_store(capsys):
    from repro_torch.launch.trainer import main

    main(["--device", "cpu", "--spec", "ell+pipelined", "--n-cores", "2",
          "--steps", "6", "--dataset", "reddit", "--scale", "0.004",
          "--feat-dim", "16", "--hidden", "16", "--batch-size", "32",
          "--feature-store", "mmap", "--cache-capacity", "64",
          "--cache-pinned", "48", "--ckpt-restart"])
    out = capsys.readouterr().out
    assert "batch-exact" in out and "store=mmap cache_hit_rate=" in out


# ---------------------------------------------------------------------------
# InferenceEngine(feature_cache_capacity=)
# ---------------------------------------------------------------------------
def _serving_params(seed=0, feat=8, hidden=8, n_classes=5):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((feat, hidden)) * 0.2)
             .astype(np.float32)},
            {"w": (rng.standard_normal((hidden, n_classes)) * 0.2)
             .astype(np.float32)}]


@pytest.mark.parametrize("spec", ["coo+serial", "ell+pipelined"])
def test_inference_engine_over_a_store_matches_reference_and_dense(spec):
    import repro.serving as ref_serving
    from repro_torch.serving import InferenceEngine

    params = _serving_params()
    pds = make_dataset("flickr", scale=0.004, feat_dim=8)
    rds = ref_make_dataset("flickr", scale=0.004, feat_dim=8)
    pstore = fs.MmapStore.from_array(pds.features)
    rstore = ref_fs.MmapStore.from_array(rds.features)
    try:
        eng = InferenceEngine(spec, pds.graph, pstore, params=params,
                              feature_cache_capacity=32, device="cpu")
        dense = InferenceEngine(spec, pds.graph, pds.features, params=params,
                                device="cpu")
        ref = ref_serving.InferenceEngine(spec, rds.graph, rstore,
                                          params=params,
                                          feature_cache_capacity=32)
        assert isinstance(eng.features, fs.HotVertexCache)
        assert eng.features.pinned_ids == ref.features.pinned_ids
        assert "feature_cache" not in dense.stats()
        rng = np.random.default_rng(5)
        n = pds.graph.n_nodes
        for rnd in range(3):
            q = rng.integers(0, n, 8)
            got = eng.query(q, use_cache=False)
            assert np.abs(got - ref.query(q, use_cache=False)).max() <= 1e-5
            assert np.array_equal(got, dense.query(q, use_cache=False))
            assert eng.stats()["feature_cache"] \
                == ref.stats()["feature_cache"]
            if rnd == 1:        # the overlay sits above the store
                ids = rng.integers(0, n, 2)
                rows = rng.standard_normal((2, 8)).astype(np.float32)
                for e in (eng, dense, ref):
                    e.update_features(ids, rows)
        assert eng.stats()["feature_cache"]["hits"] > 0
        # an engine over a cache the caller built keeps that cache
        cache = fs.HotVertexCache(pstore, np.ones(n), 16, device="cpu")
        assert InferenceEngine(spec, pds.graph, cache, params=params,
                               feature_cache_capacity=32,
                               device="cpu").features is cache
    finally:
        pstore.close()
        rstore.close()


def test_serve_cli_smoke_on_cpu(capsys):
    """The CLI end to end on a short trace.  The p99 budget is the card's
    gate (``chip_smoke.py`` phase 12 runs the CLI's defaults there); on a
    shared CPU the latency of a loaded host says nothing about the port,
    so here the smoke holds the incremental == cold match and the exit."""
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit) as hit:
        main(["--device", "cpu", "--smoke", "--feature-cache-capacity", "64",
              "--train-steps", "4", "--update-rounds", "6", "--rate", "40",
              "--duration", "0.5", "--p99-budget-ms", "60000"])
    out = capsys.readouterr().out
    assert hit.value.code == 0, out
    assert "SERVING SMOKE PASS" in out and "feature cache: 64 rows" in out


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 12, rehearsed on the CPU at a small size
# ---------------------------------------------------------------------------
def test_chip_smoke_feature_store_phase_rehearsal(tmp_path, monkeypatch,
                                                  capsys):
    """Phase 12 end to end with the kernel wrappers' plain versions made to
    report launches (as the card's kernels count them), at reddit scale
    0.004, batch 32, hidden 16, the serve CLI's smoke as a subprocess on
    the CPU: every gate passes and no store file is left behind."""
    import importlib
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from repro_torch.kernels import gemm

    spmm_mod = importlib.import_module("repro_torch.kernels.spmm")
    gemm_mod = importlib.import_module("repro_torch.kernels.gemm")
    run, walk, coo, gref = (spmm_mod._run, spmm_mod._walk,
                            spmm_mod._coo_walk, gemm_mod.gemm_ref)

    def counted_gemm(*a, **k):
        gemm.launches += 1
        return gref(*a, **k)

    monkeypatch.setattr(spmm_mod, "_run", lambda name, c, v, x, out: (
        run(name, c, v, x, out)[0], c.shape[-2] > 0))
    monkeypatch.setattr(spmm_mod, "_walk", lambda name, w, x, out: (
        walk(name, w, x, out) or bool(w.cols and len(w.items))))
    monkeypatch.setattr(spmm_mod, "_coo_walk",
                        lambda *a: (coo(*a)[0], True))
    monkeypatch.setattr(gemm_mod, "gemm_ref", counted_gemm)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "TRAIN_BATCH", 32)
    monkeypatch.setattr(cs, "HIDDEN", 16)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "SERVE_SMOKE_ARGS", cs.SERVE_SMOKE_ARGS + (
        "--device", "cpu", "--train-steps", "4", "--update-rounds", "4",
        "--duration", "0.5", "--rate", "40", "--p99-budget-ms", "60000"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cpu = torch.device("cpu")

    tds = make_dataset("reddit", scale=0.004)
    params = cs.train_params(tds)
    train = {}
    for spec in cs.TRAIN_SPECS:
        tr = cs.seeded_trainer(tds, params, spec)(
            spec, "card", input_pipeline="prefetch", device=cpu)
        losses, ms, per_step = cs.store_steps(
            torch, tr, cs.STORE_WARMUP, cs.STORE_STEPS)
        train[spec] = {"losses": losses, "launches_each_step": per_step,
                       "ms_per_step_median": float(np.median(ms)),
                       "host_stall_ms_per_step": tr.stall_per_step * 1e3}
        tr.close()
    sds = make_dataset("reddit", scale=0.004)
    ckpt = str(tmp_path / "ckpt")
    cs.write_checkpoint(ckpt, cs.seeded_params(
        0, (sds.stats.feat_dim, cs.HIDDEN, sds.stats.n_classes)))
    out, launches = cs.feature_store_phase(torch, cpu, tds, train, sds, ckpt)
    cs.print_feature_store(out)
    assert out["dataset"]["equal_to_dense"]
    assert out["ell"]["resumed_losses_6_10"] == out["ell"]["losses"][5:10]
    assert set(out["host"]) == set(cs.TRAIN_SPECS)
    assert out["serving"]["feature_cache"]["hits"] > 0
    assert out["serve_cli"]["rc"] == 0
    assert launches["store ell+pipelined trainer"]["spmm_ell_t"] > 0
    assert launches["store serving"]["gemm"] > 0
    assert not list(tmp_path.glob("*.npy"))
    assert "feature store phase" in capsys.readouterr().out
