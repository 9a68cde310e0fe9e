"""Port vs reference: the online GCN inference service on the CPU.

* ``InferenceEngine(device="cpu")`` logits are within 1e-5 of the JAX
  reference's for ``coo+serial`` and ``ell+pipelined`` on the same dataset,
  weights, update stream and queries;
* inside the port, incremental logits are BIT-equal to a cold recompute over
  a 9-round mixed update/query stream (the reference's own property);
* queue, cache, loadgen and the invalidation walk behave exactly as the
  reference's on the same inputs;
* a checkpoint the reference's ``CheckpointManager`` wrote restores through
  the port's ``load_checkpoint_params``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving as ref  # noqa: E402
from repro.graph import make_dataset as ref_make_dataset  # noqa: E402
from repro_torch import serving as port  # noqa: E402
from repro_torch.graph import make_dataset  # noqa: E402

SPECS = ["coo+serial", "ell+pipelined"]


def _params(seed=0, feat=8, hidden=8, n_classes=5):
    rng = np.random.default_rng(seed)
    return [
        {"w": (rng.standard_normal((feat, hidden)) * 0.2).astype(np.float32)},
        {"w": (rng.standard_normal((hidden, n_classes)) * 0.2)
         .astype(np.float32)},
    ]


def _engines(spec, **kw):
    """The same flickr graph, features and weights in both packages."""
    params = _params()
    rds = ref_make_dataset("flickr", scale=0.004, feat_dim=8)
    pds = make_dataset("flickr", scale=0.004, feat_dim=8)
    r = ref.InferenceEngine(spec, rds.graph, rds.features, params=params,
                            **kw)
    p = port.InferenceEngine(spec, pds.graph, pds.features, params=params,
                             device="cpu", **kw)
    return r, p


def _update(eng, rng, rnd):
    """One round of the reference test's mixed update stream."""
    n = eng.graph.n_nodes
    op = rnd % 3
    if op == 0:
        eng.update_edges(add=[(int(rng.integers(n)), int(rng.integers(n)))
                              for _ in range(3)])
    elif op == 1:
        v = int(rng.integers(n))
        nbrs = eng.graph.in_neighbors(v)
        if len(nbrs):
            eng.update_edges(remove=[(int(nbrs[0]), v)])
    else:
        nodes = rng.integers(0, n, 2)
        eng.update_features(nodes, rng.standard_normal((2, eng.feat_dim))
                            .astype(np.float32))


@pytest.mark.parametrize("spec", SPECS)
def test_logits_match_reference_under_updates(spec):
    r, p = _engines(spec)
    n = r.graph.n_nodes
    rng_q = np.random.default_rng(1)
    rng_r, rng_p = np.random.default_rng(7), np.random.default_rng(7)
    for rnd in range(4):
        q = rng_q.integers(0, n, 8)
        want = r.query(q)
        got = p.query(q)
        assert got.shape == want.shape == (8, 5)
        assert np.abs(got - want).max() <= 1e-5, f"round {rnd}"
        _update(r, rng_r, rnd)
        _update(p, rng_p, rnd)
    assert p.stats()["cache"]["hits"] == r.stats()["cache"]["hits"]
    assert p.rows_computed == r.rows_computed
    assert p.rows_from_cache == r.rows_from_cache


@pytest.mark.parametrize("spec", SPECS)
def test_incremental_bit_matches_cold_random_stream(spec):
    _, eng = _engines(spec)
    n = eng.graph.n_nodes
    rng = np.random.default_rng(7)
    eng.query(rng.integers(0, n, 16))   # warm the cache first
    for rnd in range(9):
        _update(eng, rng, rnd)
        q = rng.integers(0, n, 8)
        inc = eng.query(q, use_cache=True)
        cold = eng.query(q, use_cache=False)
        assert np.array_equal(inc, cold), f"round {rnd} diverged"
    assert eng.rows_from_cache > 0
    assert eng.cache.invalidations > 0
    assert eng.cache.stale_hits > 0


def test_bit_match_survives_eviction_pressure():
    _, eng = _engines("ell+pipelined", cache_capacity=8)
    n = eng.graph.n_nodes
    rng = np.random.default_rng(3)
    for _ in range(4):
        q = rng.integers(0, n, 8)
        assert np.array_equal(eng.query(q, use_cache=True),
                              eng.query(q, use_cache=False))
    assert eng.cache.evictions > 0
    assert len(eng.cache) <= 8


def test_invalidation_walk_matches_reference():
    """The same 3-layer engine and update sequence leave the same
    (layer, vertex) entries in both caches."""
    rng = np.random.default_rng(0)
    params = [{"w": rng.standard_normal((4, 4)).astype(np.float32)},
              {"w": rng.standard_normal((4, 4)).astype(np.float32)},
              {"w": rng.standard_normal((4, 3)).astype(np.float32)}]
    feats = rng.standard_normal((6, 4)).astype(np.float32)
    engines = []
    for pkg, kw in ((ref, {}), (port, {"device": "cpu"})):
        g = pkg.DynamicGraph(n_nodes=6)
        g.update_edges(add=[(0, 1), (1, 2), (2, 3), (4, 5)])
        engines.append(pkg.InferenceEngine("coo+serial", g, feats,
                                           params=params, **kw))
    steps = [lambda e: e.query(np.arange(6)),
             lambda e: e.update_edges(add=[(5, 0)]),
             lambda e: e.query(np.arange(6)),
             lambda e: e.update_features([1], feats[1] + 1.0)]
    for step in steps:
        outs = [step(e) for e in engines]
        if isinstance(outs[0], np.ndarray):
            assert np.abs(outs[0] - outs[1]).max() <= 1e-5
        else:
            assert outs[0] == outs[1]
        assert set(engines[0].cache._entries) == set(engines[1].cache._entries)
        assert engines[0].cache.stats() == engines[1].cache.stats()


def test_queue_matches_reference():
    trace = [(7, 0.0, None), (3, 0.0, None), (9, 0.0005, 0.02),
             (3, 0.001, None), (5, 0.004, None), (5, 0.004, 0.006),
             (1, 0.02, None)]
    queues = [pkg.RequestQueue(max_batch=3, max_wait=0.003,
                               deadline_slack=0.001) for pkg in (ref, port)]
    reqs = [pkg.InferenceRequest for pkg in (ref, port)]
    times = [0.0, 0.0005, 0.002, 0.0035, 0.0045, 0.005, 0.02, 0.03, 0.04]
    i = 0
    for now in times:
        while i < len(trace) and trace[i][1] <= now:
            node, t, dl = trace[i]
            for q, R in zip(queues, reqs):
                q.submit(R(node=node, t_arrival=t, deadline=dl))
            i += 1
        assert queues[0].next_wakeup(now) == queues[1].next_wakeup(now)
        b = [q.next_batch(now, force=now >= 0.04) for q in queues]
        assert (b[0] is None) == (b[1] is None)
        if b[0] is not None:
            np.testing.assert_array_equal(b[0].nodes, b[1].nodes)
            assert [r.node for r in b[0].requests] == \
                [r.node for r in b[1].requests]
            assert b[0].coalesce_factor == b[1].coalesce_factor
    assert queues[0].stats() == queues[1].stats()
    assert queues[1].coalesce_factor > 1.0


def test_cache_matches_reference():
    caches = [pkg.EmbeddingCache(capacity=3) for pkg in (ref, port)]
    ops = [("put", 1, 0), ("put", 1, 1), ("get", 1, 0), ("bump",),
           ("put", 1, 2), ("put", 2, 0), ("get", 1, 1), ("get", 1, 0),
           ("inv", 1, [0, 9]), ("get", 2, 0), ("bump",), ("get", 1, 2)]
    for op in ops:
        outs = []
        for c in caches:
            if op[0] == "put":
                outs.append(c.put(op[1], op[2], np.full(4, op[2], np.float32)))
            elif op[0] == "get":
                row = c.get(op[1], op[2])
                outs.append(None if row is None else row.tolist())
            elif op[0] == "inv":
                outs.append(c.invalidate(op[1], op[2]))
            else:
                outs.append(c.bump_version())
        assert outs[0] == outs[1], op
    assert caches[0].stats() == caches[1].stats()
    assert caches[1].evictions > 0 and caches[1].stale_hits > 0


def test_loadgen_matches_reference():
    a = ref.poisson_trace(rate=200.0, duration=0.5, n_nodes=50, zipf_a=1.3,
                          seed=4)
    b = port.poisson_trace(rate=200.0, duration=0.5, n_nodes=50, zipf_a=1.3,
                           seed=4)
    assert [(x.t, x.node) for x in a] == [(x.t, x.node) for x in b]
    lat = [0.01, 0.02, 0.03, 0.2, 0.004]
    assert ref.summarize(lat, 0.05, 2.0) == port.summarize(lat, 0.05, 2.0)


def test_service_coalesces_and_scatters_back():
    r, p = _engines("ell+pipelined")
    nodes = [4, 9, 4, 9, 4, 9, 4, 9]
    results = []
    for eng in (r, p):
        svc = (ref if eng is r else port).InferenceService(
            eng, max_batch=8, max_wait=0.01)
        reqs = [svc.submit(v, now=0.0) for v in nodes]
        assert svc.step(now=0.001) == 8
        assert svc.queue.coalesce_factor == 4.0
        results.append(np.stack([q.result for q in reqs]))
    assert np.abs(results[0] - results[1]).max() <= 1e-5
    for i, v in enumerate(nodes):
        np.testing.assert_array_equal(results[1][i],
                                      p.query([v], use_cache=False)[0])


def test_service_replay_open_loop():
    _, eng = _engines("ell+pipelined")
    n = eng.graph.n_nodes
    trace = port.poisson_trace(rate=100.0, duration=0.25, n_nodes=n, seed=4)
    svc = port.InferenceService(eng, max_batch=8, max_wait=0.004)
    out = svc.replay(trace, slo=0.5)
    assert out["completed"] == len(trace) == len(svc.latencies_s)
    assert out["coalesce_factor"] >= 1.0
    assert np.isfinite(out["p50_ms"]) and out["p50_ms"] <= out["p99_ms"]


def test_checkpoint_from_reference_manager(tmp_path):
    from repro.checkpoint import CheckpointManager

    params = _params(seed=2)
    CheckpointManager(str(tmp_path)).save(3, params)
    CheckpointManager(str(tmp_path)).save(7, params[::-1])
    loaded = port.load_checkpoint_params(str(tmp_path))
    assert len(loaded) == 2
    for got, want in zip(loaded, params[::-1]):     # newest step wins
        assert got["w"].dtype == want["w"].dtype
        np.testing.assert_array_equal(got["w"], want["w"])
    CheckpointManager(str(tmp_path)).save(9, params)
    pds = make_dataset("flickr", scale=0.004, feat_dim=8)
    eng = port.InferenceEngine("ell+pipelined", pds.graph, pds.features,
                               ckpt_dir=str(tmp_path), device="cpu")
    assert eng.query([0, 1, 2]).shape == (3, 5)
    with pytest.raises(FileNotFoundError):
        port.load_checkpoint_params(str(tmp_path / "empty"))


def test_params_from_reference_round_trips():
    params = _params(seed=4)
    tensors = port.params_from_reference(params, device="cpu")
    assert [list(p) for p in tensors] == [["w"], ["w"]]
    for t, want in zip(tensors, params):
        assert t["w"].dtype == torch.float32
        back = t["w"].numpy()
        np.testing.assert_array_equal(back, want["w"])
        back[0, 0] += 1.0                    # a copy, never an alias
        assert want["w"][0, 0] != back[0, 0]
    again = port.params_from_reference(tensors, device="cpu")
    for a, b in zip(again, tensors):
        assert torch.equal(a["w"], b["w"])
