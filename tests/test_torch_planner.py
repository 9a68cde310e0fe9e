"""Port vs reference: the spec planner behind ``Engine("auto")``
(:mod:`repro_torch.engine.planner`), in-process on the CPU.

* the port's mirror of ``tests/test_planner.py``: the three tiers in
  order; an exact bucket before a prefix match; corrupt, stale and
  ``entries``-less records warn and fall through; NNLS recovers and
  clamps; the fit rejects a mismatched core count or backend; the model is
  monotone; ``Topology.plan`` stamps ``predicted_seconds``; serving mode
  is latency-weighted, can invert the train ranking and skips the tier-1
  winner; ``Trainer("auto")`` at P = 2 and 4; the resume pin, bit-exact
  after the record changes; ``autotune`` persists, is idempotent, and
  ``"auto"`` follows it;
* parity with :mod:`repro.engine.planner` on the same fabricated records
  (``backend="cpu"``): ``_nnls`` and ``fit_cost_model`` coefficients
  within 1e-12 relative, ``GraphStats.bucket`` equal, ``rank_specs``
  without graph stats the same order with scores within 1e-12 relative,
  ``rank_partitions`` the same names, seconds and bytes, ``resolve_spec``
  the same spec.

Hermetic: an autouse fixture points the port's three
``REPRO_TORCH_*_PATH`` variables and the reference's two at ``tmp_path``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine import planner as ref_planner  # noqa: E402
from repro.graph import from_edges as ref_from_edges  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    Engine, EngineConfig, get_topology, planner, registry, supported_specs)
from repro_torch.graph import from_edges, make_dataset  # noqa: E402
from repro_torch.launch.trainer import Trainer  # noqa: E402
from repro_torch.topology.base import ExchangePlan, Topology  # noqa: E402

REL = 1e-12
ALPHA, BETA, CONST = 2e-3, 4e-9, 1e-3
TRAIN_KW = dict(scale=0.005, feat_dim=16, hidden=16, batch_size=16, lr=0.2,
                input_pipeline="prefetch", val_batches=1, device="cpu")


@pytest.fixture(autouse=True)
def _hermetic_stores(monkeypatch, tmp_path):
    """No test sees a real record of either package unless it writes one."""
    for var, name in (("REPRO_TORCH_PLANNER_PATH", "planner.json"),
                      ("REPRO_TORCH_TOPOLOGY_PATH", "topology.json"),
                      ("REPRO_TORCH_AUTOTUNE_PATH", "autotune.json"),
                      ("REPRO_PLANNER_PATH", "ref_planner.json"),
                      ("REPRO_TOPOLOGY_PATH", "ref_topology.json")):
        monkeypatch.setenv(var, str(tmp_path / name))
    return tmp_path


def _topology_record(n_cores=4, mid=512, feat=128, backend=None,
                     alpha=ALPHA, beta=BETA, const=CONST):
    """A topology-record-shaped sweep whose step times follow
    ``t = const + α·steps + β·bytes/link_parallelism`` exactly."""
    rec = {"n_cores": n_cores, "mid": mid, "feat": feat,
           "base_spec": "ell+pipelined",
           "topologies": registry.available_topologies()}
    if backend is not None:
        rec["backend"] = backend
    for name in rec["topologies"]:
        plan = get_topology(name).plan(mid, feat, n_cores)
        eff = plan.bytes_per_core / plan.link_parallelism
        rec[f"exchange_steps_{name}"] = plan.steps
        rec[f"exchange_bytes_per_core_{name}"] = plan.bytes_per_core
        rec[f"link_parallelism_{name}"] = plan.link_parallelism
        rec[f"s_per_step_{name}"] = const + alpha * plan.steps + beta * eff
    return rec


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _write_both(tmp_path, name, obj):
    """The same record for the port (``name``) and the reference
    (``ref_<name>``)."""
    _write(tmp_path / name, obj)
    _write(tmp_path / f"ref_{name}", obj)


def _close(a, b, rel=REL):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


# ---------------------------------------------------------------------------
# Tier 3 and tier 1.
# ---------------------------------------------------------------------------
def test_no_records_resolves_to_static_default():
    spec = planner.resolve_spec(n_cores=4, device="cpu")
    assert spec == planner.DEFAULT_SPEC
    assert not EngineConfig.from_spec(spec).is_auto
    assert planner.PLANNER_STORE.load() is None     # a pure read


def test_resolve_needs_the_card_unless_the_cpu_is_asked_for():
    # no fallback that hides the card: the default device is CUDA
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        planner.resolve_spec(n_cores=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine("auto").resolve(4)
    # an explicit backend key is a pure read and needs no device
    assert planner.resolve_spec(n_cores=4, backend="cpu") == \
        planner.DEFAULT_SPEC


def test_persisted_winner_beats_everything(tmp_path):
    entry = {"spec": "block+pipelined+ring", "backend": "cpu",
             "n_cores": 4, "bucket": "default"}
    _write(tmp_path / "planner.json",
           {"entries": {planner._entry_key("cpu", 4, "default"): entry}})
    _write(tmp_path / "topology.json", _topology_record(n_cores=4))
    assert planner.resolve_spec(n_cores=4, device="cpu") == \
        "block+pipelined+ring"
    # keyed per core count: a 4-core entry says nothing at 2
    assert planner.resolve_spec(n_cores=2, device="cpu") == \
        planner.DEFAULT_SPEC
    # keyed per backend: a card's entry says nothing on the CPU
    _write(tmp_path / "planner.json", {"entries": {planner._entry_key(
        "cuda:NVIDIA H100 80GB HBM3", 4, "default"): entry}})
    assert planner.resolve_spec(n_cores=4, device="cpu") != \
        "block+pipelined+ring"


def test_exact_bucket_beats_prefix_match(tmp_path):
    stats = planner.GraphStats(n_dst=500, n_src=1000, avg_deg=7.0,
                               feat_dim=100)
    exact = planner._entry_key("cpu", 4, stats.bucket())
    other = planner._entry_key("cpu", 4, "n64_s128_d4_f16")
    _write(tmp_path / "planner.json", {"entries": {
        other: {"spec": "coo+serial+allpairs"},
        exact: {"spec": "ell+pipelined+torus2d"}}})
    assert planner.resolve_spec(n_cores=4, graph_stats=stats,
                                device="cpu") == "ell+pipelined+torus2d"
    # without stats the sorted-prefix fallback still finds SOME entry
    assert planner.resolve_spec(n_cores=4, device="cpu") in (
        "coo+serial+allpairs", "ell+pipelined+torus2d")


@pytest.mark.parametrize("content,match", [
    ("{not json", "unreadable"),
    (json.dumps({"entries": {"cpu|P4|default":
                             {"spec": "csr+magic+wormhole"}}}),
     "stale/unregistered"),
    (json.dumps({"spec": "ell+pipelined"}), "entries"),
    (json.dumps([1, 2]), "non-object")])
def test_bad_planner_records_warn_and_fall_back(tmp_path, content, match):
    (tmp_path / "planner.json").write_text(content)
    with pytest.warns(RuntimeWarning, match=match):
        assert planner.resolve_spec(n_cores=4, device="cpu") == \
            planner.DEFAULT_SPEC


# ---------------------------------------------------------------------------
# Tier 2: the fitted cost model (and its parity with the reference).
# ---------------------------------------------------------------------------
def test_nnls_recovers_clamps_and_matches_reference():
    rng = np.random.default_rng(0)
    A = rng.uniform(0.5, 2.0, (12, 3))
    true = np.array([0.3, 1.7, 0.0])
    coef = planner._nnls(A, A @ true)
    assert np.allclose(coef, true, atol=1e-8) and (coef >= 0).all()
    y = A @ np.array([1.0, 0.0, 0.0]) - 0.5 * A[:, 2]
    clamped = planner._nnls(A, y)
    assert clamped[2] == 0.0
    for rows, target in ((A, A @ true), (A, y),
                         (rng.uniform(0, 1, (7, 3)), rng.uniform(0, 1, 7))):
        got, want = planner._nnls(rows, target), ref_planner._nnls(rows,
                                                                   target)
        assert all(_close(g, w) for g, w in zip(got, want)), (got, want)


@pytest.mark.parametrize("planted", [
    dict(), dict(alpha=1e-6, beta=1e-7, const=1e-4),
    dict(alpha=1e-3, beta=0.0, const=1e-4), dict(n_cores=16, mid=10368,
                                                 feat=602)])
def test_fit_cost_model_recovers_and_matches_reference(tmp_path, planted):
    rec = _topology_record(**planted)
    _write_both(tmp_path, "topology.json", rec)
    n_cores = planted.get("n_cores", 4)
    model = planner.fit_cost_model(n_cores=n_cores)
    ref = ref_planner.fit_cost_model(n_cores=n_cores)
    assert model is not None and ref is not None
    for key in ("alpha", "beta", "const"):
        assert _close(getattr(model, key), getattr(ref, key)), key
        assert getattr(model, key) == pytest.approx(
            planted.get(key, {"alpha": ALPHA, "beta": BETA,
                              "const": CONST}[key]), rel=1e-6, abs=1e-15)
    assert (model.n_cores, model.n_rows, model.d, model.base_spec) == \
        (ref.n_cores, ref.n_rows, ref.d, ref.base_spec)


def test_fit_cost_model_rejects_mismatched_records(tmp_path):
    _write(tmp_path / "topology.json",
           _topology_record(n_cores=4, backend="tpu"))
    assert planner.fit_cost_model(n_cores=2) is None
    assert planner.fit_cost_model(n_cores=4, backend="cpu") is None
    assert planner.fit_cost_model(n_cores=4, backend="tpu") is not None
    rec = _topology_record(n_cores=4)
    rec["topologies"] = rec["topologies"][:2]
    assert planner.fit_cost_model(record=rec) is None
    (tmp_path / "topology.json").write_text("][")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert planner.fit_cost_model(n_cores=4) is None


def test_cost_model_is_monotone():
    model = planner.fit_cost_model(record=_topology_record(n_cores=4))
    base = ExchangePlan(topology="hypercube", n_cores=4, steps=2,
                        bytes_per_core=1 << 20, max_step_rows=256)
    for field, worse in (("steps", 5), ("bytes_per_core", 1 << 24)):
        bigger = dataclasses.replace(base, **{field: worse})
        assert model.predict(bigger) >= model.predict(base)
    wide = dataclasses.replace(base, link_parallelism=2.0)
    assert model.predict(wide) <= model.predict(base)


def test_plan_stamps_predicted_seconds():
    model = planner.fit_cost_model(record=_topology_record(n_cores=4))
    topo = get_topology("hypercube")
    plain = topo.plan(512, 128, 4)
    assert plain.predicted_seconds is None
    plan = topo.plan(512, 128, 4, cost_model=model)
    assert plan.predicted_seconds == pytest.approx(model.predict(plain))
    assert plan.predicted_seconds > 0
    # the measured-cut plan is stamped too
    cut = topo.plan(512, 128, 4, cost_model=model, wire_rows=100)
    assert cut.predicted_seconds == pytest.approx(model.predict(cut))


def test_analytic_tier_ranks_and_resolves(tmp_path):
    _write(tmp_path / "topology.json",
           _topology_record(n_cores=4, alpha=1e-6, beta=1e-7, const=1e-4))
    model = planner.fit_cost_model(n_cores=4)
    ranked = planner.rank_specs(model, 4)
    assert ranked[0][0] == "ell+pipelined+torus2d"
    assert all(a[1] <= b[1] for a, b in zip(ranked, ranked[1:]))
    spec = planner.resolve_spec(n_cores=4, device="cpu")
    assert spec == "ell+pipelined+torus2d"
    _write(tmp_path / "topology.json",
           _topology_record(n_cores=4, alpha=1e-3, beta=0.0, const=1e-4))
    assert planner.resolve_spec(n_cores=4, device="cpu") in (
        "ell+pipelined+hypercube", "ell+pipelined+torus2d")


@pytest.mark.parametrize("stats", [
    (500, 1000, 7.2, 100), (512, 1024, 8.0, 128), (513, 1024, 8.0, 128),
    (10368, 151234, 24.9, 602), (1, 1, 0.0, 1)])
def test_graph_stats_bucket_matches_reference(stats):
    got = planner.GraphStats(*stats).bucket()
    assert got == ref_planner.GraphStats(*stats).bucket()
    assert planner._roofline_dims(planner.GraphStats(*stats)) == \
        ref_planner._roofline_dims(ref_planner.GraphStats(*stats))


def test_graph_stats_bucketing_and_from_layers():
    a = planner.GraphStats(n_dst=500, n_src=1000, avg_deg=7.2, feat_dim=100)
    b = planner.GraphStats(n_dst=512, n_src=1024, avg_deg=8.0, feat_dim=128)
    assert a.bucket() == b.bucket() == "n512_s1024_d8_f128"
    rng = np.random.default_rng(0)
    layers = []
    for n_dst, n_src, e in ((8, 40, 30), (40, 200, 170)):
        r, c = rng.integers(0, n_dst, e), rng.integers(0, n_src, e)
        v = rng.uniform(0.1, 1, e).astype(np.float32)
        layers.append((from_edges(r, c, v, n_dst, n_src),
                       ref_from_edges(r, c, v, n_dst, n_src)))
    got = planner.GraphStats.from_layers([p for p, _ in layers], 602)
    want = ref_planner.GraphStats.from_layers([q for _, q in layers], 602)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_dst, got.n_src) == (40, 200)


# ---------------------------------------------------------------------------
# Rankings and resolution: parity with the reference on the same records.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,max_batch", [("train", 8), ("serving", 8),
                                            ("serving", 1), ("serving", 6)])
@pytest.mark.parametrize("planted", [
    dict(), dict(alpha=1e-6, beta=1e-7, const=1e-4),
    dict(n_cores=16, mid=10368, feat=602)])
def test_rank_specs_matches_reference(planted, mode, max_batch):
    rec = _topology_record(**planted)
    n_cores = rec["n_cores"]
    got = planner.rank_specs(planner.fit_cost_model(record=rec), n_cores,
                             mode=mode, max_batch=max_batch)
    want = ref_planner.rank_specs(ref_planner.fit_cost_model(record=rec),
                                  n_cores, mode=mode, max_batch=max_batch)
    assert [s for s, _ in got] == [s for s, _ in want]
    assert all(_close(a, b) for (_, a), (_, b) in zip(got, want))
    assert {s for s, _ in got} == set(supported_specs(three_part=True))


@pytest.mark.parametrize("n_cores,topology", [(2, "hypercube"),
                                              (4, "ring"), (4, "torus2d"),
                                              (8, "allpairs")])
def test_rank_partitions_matches_reference(n_cores, topology):
    rng = np.random.default_rng(n_cores)
    n, e = 64, 400
    # two planted communities, so mincom has a cut to find
    r = rng.integers(0, n, e)
    c = np.where(rng.random(e) < 0.85, (r + rng.integers(-3, 4, e)) % n,
                 rng.integers(0, n, e))
    v = rng.uniform(0.1, 1, e).astype(np.float32)
    rec = _topology_record(n_cores=n_cores, mid=n, feat=16)
    got = planner.rank_partitions(planner.fit_cost_model(record=rec),
                                  from_edges(r, c, v, n, n), n_cores,
                                  topology=topology)
    want = ref_planner.rank_partitions(
        ref_planner.fit_cost_model(record=rec), ref_from_edges(r, c, v, n, n),
        n_cores, topology=topology)
    assert [(a, b) for a, _, b in got] == [(a, b) for a, _, b in want]
    assert all(_close(a, b) for (_, a, _), (_, b, _) in zip(got, want))


@pytest.mark.parametrize("case", ["none", "topology", "planner", "bucket",
                                  "stale", "serving"])
def test_resolve_spec_matches_reference(tmp_path, case):
    stats = planner.GraphStats(n_dst=500, n_src=1000, avg_deg=7.0,
                               feat_dim=100)
    if case in ("topology", "serving"):
        _write_both(tmp_path, "topology.json", _topology_record(
            n_cores=4, alpha=1e-6, beta=1e-7, const=1e-4))
    if case in ("planner", "serving"):
        _write_both(tmp_path, "planner.json", {"entries": {
            "cpu|P4|default": {"spec": "block+pipelined+ring"}}})
    if case == "bucket":
        _write_both(tmp_path, "planner.json", {"entries": {
            f"cpu|P4|{stats.bucket()}": {"spec": "coo+serial+torus2d"},
            "cpu|P4|n8_s8_d8_f8": {"spec": "ell+pipelined+allpairs"}}})
    if case == "stale":
        _write_both(tmp_path, "planner.json", {"entries": {
            "cpu|P4|default": {"spec": "csr+magic+wormhole"}}})
    mode = "serving" if case == "serving" else "train"
    with_stats = case == "bucket"
    got, want = (
        _resolve_warned(case, pl.resolve_spec, n_cores=4, backend="cpu",
                        mode=mode, graph_stats=pl.GraphStats(
                            **dataclasses.asdict(stats)) if with_stats
                        else None)
        for pl in (planner, ref_planner))
    assert got == want


def _resolve_warned(case, fn, **kw):
    """``fn(**kw)``; a stale record must warn."""
    if case != "stale":
        return fn(**kw)
    with pytest.warns(RuntimeWarning, match="stale/unregistered"):
        return fn(**kw)


# ---------------------------------------------------------------------------
# Serving mode.
# ---------------------------------------------------------------------------
def test_serving_mode_scores_are_latency_weighted():
    model = planner.CostModel(alpha=1e-4, beta=1e-9, const=1e-3, n_cores=4)
    cands = ["ell+pipelined+hypercube", "ell+pipelined+ring"]
    ranked = dict(planner.rank_specs(model, 4, candidates=cands,
                                     mode="serving", max_batch=8))
    for spec in cands:
        topo = get_topology(spec.split("+")[2])
        plans = [topo.plan(b, model.d, 4) for b in (1, 2, 4, 8)]
        want = sum(model.predict(p) for p in plans) / len(plans)
        assert ranked[spec] == pytest.approx(want)
    one = dict(planner.rank_specs(model, 4, candidates=cands,
                                  mode="serving", max_batch=1))
    for spec in cands:
        topo = get_topology(spec.split("+")[2])
        assert one[spec] == pytest.approx(
            model.predict(topo.plan(1, model.d, 4)))
    with pytest.raises(ValueError, match="rank mode"):
        planner.rank_specs(model, 4, mode="batch")


def test_serving_and_train_rankings_can_invert(monkeypatch):
    class FatPipe(Topology):
        """One hop, but 6× the wire bytes."""

        def steps(self, n_cores):
            return 1

        def bytes_per_core(self, n_rows, d, n_cores, dtype_bytes=4):
            return 6 * super().bytes_per_core(n_rows, d, n_cores,
                                              dtype_bytes)

    inst = FatPipe()
    inst.name = "fatpipe"
    registry._ensure_topologies()
    monkeypatch.setitem(registry._TOPOLOGIES, "fatpipe", inst)
    model = planner.CostModel(alpha=1e-4, beta=1e-9, const=1e-3, n_cores=4)
    cands = ["ell+pipelined+hypercube", "ell+pipelined+fatpipe"]
    train = planner.rank_specs(model, 4, candidates=cands)
    serving = planner.rank_specs(model, 4, candidates=cands,
                                 mode="serving", max_batch=8)
    assert train[0][0] == "ell+pipelined+hypercube"
    assert serving[0][0] == "ell+pipelined+fatpipe"


def test_serving_mode_skips_persisted_train_winner(tmp_path):
    _write(tmp_path / "planner.json", {"entries": {
        planner._entry_key("cpu", 4, "default"):
            {"spec": "block+pipelined+ring"}}})
    _write(tmp_path / "topology.json",
           _topology_record(n_cores=4, alpha=1e-6, beta=1e-7, const=1e-4))
    assert planner.resolve_spec(n_cores=4, device="cpu") == \
        "block+pipelined+ring"
    assert planner.resolve_spec(n_cores=4, device="cpu",
                                mode="serving") == "ell+pipelined+torus2d"
    (tmp_path / "topology.json").unlink()
    assert planner.resolve_spec(n_cores=4, device="cpu",
                                mode="serving") == planner.DEFAULT_SPEC


def test_inference_engine_auto_resolves_in_serving_mode(tmp_path):
    from repro_torch.serving import InferenceEngine

    ds = make_dataset("reddit", scale=0.004, feat_dim=16, seed=0)
    params = [{"w": np.eye(16, dtype=np.float32)},
              {"w": np.ones((16, ds.stats.n_classes), np.float32)}]
    # a train-mode winner at P = 1 must not apply to serving
    _write(tmp_path / "planner.json", {"entries": {
        planner._entry_key("cpu", 1, "default"): {"spec": "coo+serial"}}})
    eng = InferenceEngine("auto", ds.graph, ds.features, params=params,
                          device="cpu", max_batch=4)
    want = planner.resolve_spec(n_cores=1, mode="serving", max_batch=4,
                                device="cpu")
    assert eng.spec == EngineConfig.from_spec(want).spec == "ell+pipelined"
    ref = InferenceEngine(want, ds.graph, ds.features, params=params,
                          device="cpu")
    nodes = np.arange(0, 40, 5)
    assert np.array_equal(eng.query(nodes), ref.query(nodes))


# ---------------------------------------------------------------------------
# Engine("auto"), the Trainer and the measured tier.
# ---------------------------------------------------------------------------
def test_auto_config_rules():
    cfg = EngineConfig.from_spec("auto", lr=0.3, caps="single")
    assert cfg.is_auto and cfg.spec == "auto"
    for bad in ("auto+pipelined", "auto+pipelined+ring"):
        with pytest.raises(ValueError, match="complete spec"):
            EngineConfig.from_spec(bad)
    concrete = cfg.with_spec("block+pipelined+ring")
    assert concrete.spec == "block+pipelined+ring" and not concrete.is_auto
    assert (concrete.lr, concrete.caps) == (0.3, "single")
    assert "auto" in supported_specs()
    assert "auto" not in supported_specs(three_part=True)
    assert not registry._FORMATS.get("auto")


def test_auto_engine_layer_and_build_resolve(tmp_path):
    rng = np.random.default_rng(0)
    r, c = rng.integers(0, 16, 60), rng.integers(0, 32, 60)
    coo = from_edges(r, c, rng.uniform(0.1, 1, 60).astype(np.float32),
                     16, 32)
    x, w = torch.randn(32, 8), torch.randn(8, 4)
    eng = Engine("auto")
    got = eng.layer(coo, x, w, device="cpu")
    want = Engine(planner.DEFAULT_SPEC).layer(coo, x, w, device="cpu")
    assert torch.equal(got, want)
    _write(tmp_path / "planner.json", {"entries": {
        planner._entry_key("cpu", 4, "default"):
            {"spec": "coo+serial+torus2d"}}})
    bundle = Engine("auto").build(4, device="cpu")
    assert bundle.spec == "coo+serial+torus2d" and bundle.spec != "auto"
    # cached per (cores, bucket, backend): a second resolve reuses it
    assert eng.resolve(4, device="cpu") is eng.resolve(4, device="cpu")


@pytest.mark.parametrize("n_cores", [2, 4])
def test_auto_resolves_and_trains(n_cores):
    eng = Engine("auto")
    resolved = eng.resolve(n_cores, device="cpu")
    assert not resolved.is_auto
    assert resolved.config.with_spec(resolved.spec).spec == resolved.spec
    tr = Trainer("auto", "flickr", n_cores=n_cores, seed=0, **TRAIN_KW)
    assert tr.requested_spec == "auto" and not tr.engine.is_auto
    out = tr.fit(1, steps_per_epoch=3)
    assert out["requested_spec"] == "auto" and out["spec"] != "auto"
    assert out["spec"] == EngineConfig.from_spec(planner.resolve_spec(
        n_cores=n_cores, device="cpu")).spec
    assert len(out["loss_history"]) == 3
    assert np.all(np.isfinite(out["loss_history"]))


def test_auto_resume_pins_resolved_spec_bit_exact(tmp_path):
    """Checkpoint an auto run mid-stream, then change the planner record
    under it: the resumed run pins the checkpoint's concrete spec and
    replays the loss trajectory bit-exactly."""
    kw = dict(TRAIN_KW, seed=3)
    ckpt = str(tmp_path / "ckpt")
    full = Trainer("auto", "flickr", n_cores=2, **kw)
    pinned = full.engine.spec
    full_losses = [full.train_steps(1)[0] for _ in range(8)]
    full.close()
    part = Trainer("auto", "flickr", n_cores=2, ckpt_dir=ckpt, ckpt_every=0,
                   **kw)
    assert part.engine.spec == pinned
    part.train_steps(4)
    part.save(sync=True)
    part.close()
    divergent = "coo+serial+allpairs"
    assert divergent != pinned
    _write(tmp_path / "planner.json", {"entries": {
        planner._entry_key("cpu", 2, "default"): {"spec": divergent}}})
    fresh = Trainer("auto", "flickr", n_cores=2, ckpt_dir=ckpt,
                    ckpt_every=0, **kw)
    assert fresh.engine.spec == divergent        # pre-resume: re-planned
    assert fresh.resume() is True
    assert fresh.engine.spec == pinned           # the checkpoint wins
    assert fresh.bundle.spec == pinned and fresh.requested_spec == "auto"
    res = [fresh.train_steps(1)[0] for _ in range(4)]
    fresh.close()
    assert res == full_losses[4:], (res, full_losses[4:])


def test_autotune_persists_and_auto_follows_winner(tmp_path):
    stats = planner.GraphStats(n_dst=32, n_src=64, avg_deg=4.0, feat_dim=16)
    cands = ["ell+pipelined+hypercube", "coo+serial+allpairs"]
    entry = planner.autotune(stats, n_cores=2, candidates=cands, n_steps=1,
                             n_trials=2, device="cpu")
    assert entry["spec"] in cands and entry["loss_match"] is True
    assert set(entry["s_per_step"]) == set(cands)
    assert entry["backend"] == "cpu"
    rec = json.loads((tmp_path / "planner.json").read_text())
    key = planner._entry_key("cpu", 2, stats.bucket())
    assert key == f"cpu|P2|{stats.bucket()}"
    assert rec["entries"][key]["spec"] == entry["spec"]
    again = planner.autotune(stats, n_cores=2, candidates=cands, n_steps=1,
                             n_trials=2, device="cpu")
    assert again == entry
    resolved = Engine("auto").resolve(2, graph_stats=stats, device="cpu")
    assert resolved.spec == EngineConfig.from_spec(entry["spec"]).spec
    # a forced re-run measures again and merges under the same key
    planner.autotune(stats, n_cores=4, candidates=cands, n_steps=1,
                     n_trials=1, device="cpu")
    rec = json.loads((tmp_path / "planner.json").read_text())
    assert sorted(rec["entries"]) == sorted(
        [key, planner._entry_key("cpu", 4, stats.bucket())])


def test_rank_specs_with_graph_stats_scales_by_format_roofline():
    """With graph stats the compute term of each format is scaled by its
    counted roofline seconds relative to the base format."""
    stats = planner.GraphStats(n_dst=500, n_src=1000, avg_deg=7.0,
                               feat_dim=100)
    dims = planner._roofline_dims(stats)
    secs = {f: planner._format_roofline_seconds("cpu", f, dims)
            for f in ("ell+pipelined", "block+pipelined", "coo+serial")}
    assert all(s is not None and s > 0 for s in secs.values()), secs
    model = planner.CostModel(alpha=0.0, beta=0.0, const=1e-3, n_cores=4)
    ranked = dict(planner.rank_specs(model, 4, graph_stats=stats,
                                     backend="cpu"))
    for spec, score in ranked.items():
        fmt = "+".join(spec.split("+")[:2])
        assert score == pytest.approx(
            1e-3 * secs[fmt] / secs["ell+pipelined"], rel=1e-12)


def test_trainer_cli_accepts_spec_auto(capsys):
    from repro_torch.launch.trainer import main

    main(["--spec", "auto", "--device", "cpu", "--dataset", "reddit",
          "--scale", "0.004", "--feat-dim", "16", "--hidden", "16",
          "--batch-size", "32", "--n-cores", "2", "--steps", "4",
          "--ckpt-restart"])
    out = capsys.readouterr().out
    assert "OK spec=auto (resolved ell+pipelined) cores=2" in out, out
