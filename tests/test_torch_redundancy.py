"""Port vs reference: ``merge="redundancy"`` (GraphACT virtual vertices and
the ``vv`` pre-pass walk) and ``partition="mincom"`` (with the wire-byte
report), on the same numpy inputs.

* ``mine_pair_redundancy``'s arrays and stats are ``np.array_equal`` to the
  reference's on the planted-pair graph, a zipf/GCN random graph and (a
  Hypothesis property) any graph, GCN-normalized or not;
* ``build_plan(merge="redundancy")`` and ``shard_edges_ell(merge=
  "redundancy")`` tables are array-equal to the reference's;
* ``ell_aggregate`` over a merged plan: forward and gradient within 1e-5
  of the reference's (its XLA path);
* the stacked pre-pass at P = 4 with one core mining nothing: pad rows walk
  nothing, and forward and gradient match the dense product within 1e-5;
* the ``mincom`` functions, ``partition_permutation``, ``exchange_rows``
  and the rest of ``graph/partition.py`` equal the reference's;
* the spec sweep: every concrete spec × {naive, mincom} with
  ``merge="redundancy"`` at P = 2 and 4 on the reference's planted sweep
  graph (``tests/test_redundancy.py``'s ``_SWEEP``) is within 1e-5 of the
  port's ``coo+serial`` over 5 steps at lr 0.3, and the batch report
  equals the reference's (``wire_bytes`` and ``virtual_vertices`` exact,
  the ratios within 1e-12);
* the Trainer on ``ell+pipelined+ring`` (P = 2) checkpoints mid-run and
  resumes with drift exactly 0.0, and ``fit()["plan"]`` has the
  reference's keys.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.distributed import aggregate as ref_agg  # noqa: E402
from repro.engine import Engine as RefEngine  # noqa: E402
from repro.engine import EngineConfig as RefConfig  # noqa: E402
from repro.graph import from_edges as ref_from_edges  # noqa: E402
from repro.graph import partition as ref_part  # noqa: E402
from repro.kernels import edgeplan as ref_edgeplan  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.distributed import aggregate as agg  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.engine import supported_specs  # noqa: E402
from repro_torch.graph import from_edges  # noqa: E402
from repro_torch.graph import partition as part  # noqa: E402
from repro_torch.kernels import edgeplan, ell_aggregate  # noqa: E402
from repro_torch.launch.trainer import Trainer  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

CAPS = "pow2"


# ---------------------------------------------------------------------------
# graphs (numpy; each package builds its own COO from them)
# ---------------------------------------------------------------------------
def _gcn_normalize(rows, cols, n_dst, n_src):
    d_dst = np.bincount(rows, minlength=n_dst).astype(np.float64)
    d_src = np.bincount(cols, minlength=n_src).astype(np.float64)
    return (1.0 / np.sqrt(np.maximum(d_dst[rows] * d_src[cols], 1.0))
            ).astype(np.float32)


def _gcn_random(n_dst, n_src, deg, seed=0):
    """Zipf-skewed columns + GCN weights: shared hub pairs always mine."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_dst, dtype=np.int64), deg)
    w = 1.0 / np.arange(1.0, n_src + 1.0) ** 1.2
    cols = rng.permutation(n_src)[rng.choice(n_src, rows.size,
                                             p=w / w.sum())]
    keep = np.unique(rows * n_src + cols)
    rows, cols = keep // n_src, keep % n_src
    return rows, cols, _gcn_normalize(rows, cols, n_dst, n_src), n_dst, n_src


def _planted(k=4, m=5):
    """k groups of m rows, each group sharing one hub pair (2g, 2g+1) and
    one private filler column per row."""
    n_rows = k * m
    n_cols = 2 * k + n_rows
    rows, cols = [], []
    for g in range(k):
        for i in range(m):
            r = g * m + i
            rows += [r, r, r]
            cols += [2 * g, 2 * g + 1, 2 * k + r]
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    return rows, cols, _gcn_normalize(rows, cols, n_rows, n_cols), n_rows, \
        n_cols


def _both(args):
    return ref_from_edges(*args), from_edges(*args)


def _assert_mines_equal(got, want):
    for a in ("rows", "cols", "vals", "vv_src", "vv_coef"):
        g, w = getattr(got, a), np.asarray(getattr(want, a))
        assert g.dtype == w.dtype, a
        np.testing.assert_array_equal(g, w, err_msg=a)
    assert got.stats == want.stats
    assert (got.n_rows, got.n_cols, got.n_virtual) == \
        (want.n_rows, want.n_cols, want.n_virtual)
    for g, w in zip(got.vv_flat(), want.vv_flat()):
        np.testing.assert_array_equal(g, w)


def _assert_tables_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, tuple):
            assert len(g) == len(w), key
            for a, b in zip(g, w):
                assert a.dtype == b.dtype, key
                np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


# ---------------------------------------------------------------------------
# mining, plans, shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("graph", ["planted", "gcn_random", "ratios"])
def test_mining_equals_the_reference(graph):
    if graph == "planted":
        args = _planted()
    elif graph == "gcn_random":
        args = _gcn_random(96, 64, deg=10, seed=3)
    else:      # a shared pair in two ratio classes + a non-proportional one
        args = (np.array([0, 0, 1, 1, 2, 2, 3, 3]),
                np.array([0, 1, 0, 1, 0, 1, 0, 1]),
                np.array([1, 2, 3, 6, 1, 5, 2, 10], np.float32), 4, 2)
    got = edgeplan.mine_pair_redundancy(*args)
    want = ref_edgeplan.mine_pair_redundancy(*args)
    _assert_mines_equal(got, want)
    if graph == "planted":
        assert got.n_virtual == 4 and got.stats["pair_uses"] == 20


@settings(max_examples=25, deadline=None)
@given(n_dst=st.integers(4, 48), n_src=st.integers(4, 48),
       deg=st.integers(1, 8), seed=st.integers(0, 10_000),
       gcn=st.booleans())
def test_property_mining_equals_the_reference_on_any_graph(n_dst, n_src, deg,
                                                           seed, gcn):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_dst, dtype=np.int64), deg)
    cols = rng.integers(0, n_src, rows.size)
    keep = np.unique(rows * n_src + cols)
    rows, cols = keep // n_src, keep % n_src
    vals = _gcn_normalize(rows, cols, n_dst, n_src) if gcn \
        else rng.standard_normal(rows.size).astype(np.float32)
    args = (rows, cols, vals, n_dst, n_src)
    _assert_mines_equal(edgeplan.mine_pair_redundancy(*args),
                        ref_edgeplan.mine_pair_redundancy(*args))


@pytest.mark.parametrize("seed", [3, 5])
def test_merged_plan_and_aggregate_equal_the_reference(seed):
    args = _gcn_random(96, 64, deg=10, seed=seed)
    ref_coo, coo = _both(args)
    rp = ref_edgeplan.build_plan(ref_coo, caps=CAPS, merge="redundancy")
    pp = edgeplan.build_plan(coo, caps=CAPS, merge="redundancy")
    assert pp.n_virtual == rp.n_virtual > 0
    assert pp.merge_stats == rp.merge_stats
    assert (pp.pair_coverage, pp.flop_reduction) == \
        (rp.pair_coverage, rp.flop_reduction)
    for name in ("fwd", "bwd", "vv", "vv_t"):
        g, w = getattr(pp, name), getattr(rp, name)
        assert g.caps == w.caps and g.n_rows == w.n_rows
        np.testing.assert_array_equal(g.inv_perm, w.inv_perm)
        for a, b in zip(g.cols + g.vals, w.cols + w.vals):
            np.testing.assert_array_equal(a, b)
    rt = rp.device_tables()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    gy = rng.standard_normal((96, 16)).astype(np.float32)
    want_y = np.asarray(ref_ops.ell_aggregate(rt, jnp.asarray(x)))
    want_dx = np.asarray(jax.grad(lambda v: jnp.sum(
        ref_ops.ell_aggregate(rt, v) * gy))(jnp.asarray(x)))
    tables = pp.device_tables("cpu")
    assert {"vv_walk", "vvt_walk"} <= set(tables)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ell_aggregate(tables, xt)
    (y * torch.from_numpy(gy)).sum().backward()
    assert np.abs(y.detach().numpy() - want_y).max() <= 1e-5
    assert np.abs(xt.grad.numpy() - want_dx).max() <= 1e-5


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("graph", ["gcn_random", "sweep_hop1"])
def test_redundancy_shards_equal_the_reference(graph, P):
    args = _gcn_random(64, 128, deg=8, seed=P) if graph == "gcn_random" \
        else _sweep_layers(P)[1]
    ref_coo, coo = _both(args)
    re_ = ref_agg.shard_edges_ell(ref_coo, P, caps=CAPS, merge="redundancy")
    pe = agg.shard_edges_ell(coo, P, caps=CAPS, merge="redundancy")
    assert pe.n_virtual == re_.n_virtual > 0
    assert pe.merge_stats == re_.merge_stats
    assert (pe.pair_coverage, pe.flop_reduction) == \
        (re_.pair_coverage, re_.flop_reduction)
    _assert_tables_equal(pe.tables, re_.tables)
    assert sorted(pe.items) == ["items", "t_items", "vv_items", "vvt_items"]


def test_stacked_prepass_with_a_core_that_mines_nothing():
    """P = 4: core 3's sources sit one per row, so it mines no pair; its
    ``vv`` rows are all pad and walk nothing.  The aggregate's forward and
    gradient hold the dense product within 1e-5, and the walks launch the
    pre-pass only when a sender mined (CPU: counted by the tables)."""
    P, n_dst, n_src = 4, 64, 128
    spc = n_src // P
    rows, cols, _, _, _ = _gcn_random(n_dst, n_src, deg=10, seed=7)
    on3 = cols // spc == 3
    # per row, only its first stripe-3 source survives
    seen = set()
    keep = np.ones(rows.size, bool)
    for i in np.flatnonzero(on3):
        keep[i] = rows[i] not in seen
        seen.add(rows[i])
    rows, cols = rows[keep], cols[keep]
    vals = _gcn_normalize(rows, cols, n_dst, n_src)
    args = (rows, cols, vals, n_dst, n_src)
    ref_coo, coo = _both(args)
    re_ = ref_agg.shard_edges_ell(ref_coo, P, caps=CAPS, merge="redundancy")
    ee = agg.shard_edges_ell(coo, P, caps=CAPS, merge="redundancy")
    _assert_tables_equal(ee.tables, re_.tables)
    vv_cols = ee.tables["vv_cols"]
    n_vv_pad = ee.tables["vv_inv"].shape[-1]
    assert n_vv_pad > 0 and all((c[3] == spc).all() for c in vv_cols)
    assert all((c[:3] < spc).any() for c in vv_cols)
    bundle = Engine(EngineConfig.from_spec("ell+pipelined",
                                           merge="redundancy")).build(
        n_cores=P, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n_src, 9)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n_dst, 9)).astype(np.float32))
    xt = x.clone().requires_grad_(True)
    y = bundle.aggregate(xt, coo)
    (y * g).sum().backward()
    dense = coo.todense().double()
    assert (y.detach().double() - dense @ x.double()).abs().max() <= 1e-5
    assert (xt.grad.double() - dense.T @ g.double()).abs().max() <= 1e-5


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------
def _communities(n, n_cores, deg=6, seed=0):
    """A square graph of planted communities under a scrambled numbering."""
    rng = np.random.default_rng(seed)
    comm = rng.permutation(np.arange(n) % n_cores)
    rows = np.repeat(np.arange(n), deg)
    cols = np.empty_like(rows)
    for i, r in enumerate(rows):
        pool = np.flatnonzero(comm == comm[r]) if rng.random() < 0.9 \
            else np.arange(n)
        cols[i] = rng.choice(pool)
    return rows, cols


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_partition_functions_equal_the_reference(P):
    rows, cols = _communities(64, P, seed=P)
    a = part.mincom_assignment(rows, cols, 64, P)
    np.testing.assert_array_equal(
        a, ref_part.mincom_assignment(rows, cols, 64, P))
    np.testing.assert_array_equal(part.partition_permutation(a, P),
                                  ref_part.partition_permutation(a, P))
    assert np.bincount(a, minlength=P).tolist() == [64 // P] * P
    rng = np.random.default_rng(P)
    dst_assign = rng.integers(0, P, 32)
    np.testing.assert_array_equal(
        part.mincom_bipartite(dst_assign, rows[:200] % 32, cols[:200], 64, P),
        ref_part.mincom_bipartite(dst_assign, rows[:200] % 32, cols[:200],
                                  64, P))
    vals = np.where(rng.random(rows.size) < 0.1, 0.0, 1.0).astype(np.float32)
    assert part.exchange_rows(rows, cols, vals, 64, 64, P) == \
        ref_part.exchange_rows(rows, cols, vals, 64, 64, P)
    assert part.anti_diagonal_stages(P) == ref_part.anti_diagonal_stages(P)
    np.testing.assert_array_equal(part.diagonal_storage_mask(P),
                                  ref_part.diagonal_storage_mask(P))
    np.testing.assert_array_equal(part.partition_features(64, P),
                                  ref_part.partition_features(64, P))
    np.testing.assert_array_equal(part.local_addr(np.arange(64), 64 // P),
                                  ref_part.local_addr(np.arange(64), 64 // P))
    if P > 1:
        layers = [from_edges(*a) for a in _sweep_layers(P)]
        ref_layers = [ref_from_edges(*a) for a in _sweep_layers(P)]
        for g, w in zip(part.mincom_layer_perms(layers, P),
                        ref_part.mincom_layer_perms(ref_layers, P)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="partition"):
        part.validate_partition("metis")
    with pytest.raises(ValueError, match="pad nodes"):
        part.mincom_assignment(rows, cols, 63, 2)


# ---------------------------------------------------------------------------
# the spec sweep on the reference's planted sweep graph
# ---------------------------------------------------------------------------
def _sweep_layers(PC):
    """``tests/test_redundancy.py``'s ``_SWEEP`` batch: per-core
    communities with zipf-skewed sources and GCN weights, two hops."""
    n_cores = PC
    batch, mid, frontier, deg = 16 * PC, 32 * PC, 64 * PC, 6
    rng = np.random.default_rng(0)
    comm = [np.minimum(np.arange(batch) // (batch // n_cores), n_cores - 1),
            rng.permutation(np.arange(mid) % n_cores),
            rng.permutation(np.arange(frontier) % n_cores)]

    def layer(n_dst, n_src, cd, cs):
        rows = np.repeat(np.arange(n_dst, dtype=np.int64), deg)
        cols = np.empty(rows.size, np.int64)
        for c in range(n_cores):
            pool = rng.permutation(np.flatnonzero(cs == c))
            m = cd[rows] == c
            w = 1.0 / np.arange(1.0, pool.size + 1.0) ** 1.2
            cols[m] = pool[rng.choice(pool.size, int(m.sum()),
                                      p=w / w.sum())]
        keep = np.unique(rows * n_src + cols)
        rows, cols = keep // n_src, keep % n_src
        return rows, cols, _gcn_normalize(rows, cols, n_dst, n_src), \
            n_dst, n_src

    return [layer(batch, mid, comm[0], comm[1]),
            layer(mid, frontier, comm[1], comm[2])]


class _MB:
    def __init__(self, layers):
        self.layers = layers


def _sweep_batch(PC, ref=False):
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((64 * PC, 12)).astype(np.float32)
    labels = rng.integers(0, 4, 16 * PC).astype(np.int32)
    make = ref_from_edges if ref else from_edges
    return _MB([make(*a) for a in _sweep_layers(PC)]), feats, labels


_ORACLE = {}


def _trajectory(cfg, PC):
    mb, feats, labels = _sweep_batch(PC)
    bundle = Engine(cfg).build(n_cores=PC, device="cpu")
    bb = bundle.shard_batch(mb, feats, labels)
    p, traj = init_params(0, [(12, 8), (8, 4)], device="cpu"), []
    for _ in range(5):
        p, loss = bundle.train_step(p, bb)
        traj.append(float(loss))
    return traj, bb["report"]


@pytest.mark.parametrize("partition", ["naive", "mincom"])
@pytest.mark.parametrize("spec", supported_specs(three_part=True))
@pytest.mark.parametrize("PC", [2, 4])
def test_redundancy_mincom_spec_sweep_matches_the_oracle(PC, spec,
                                                          partition):
    if PC not in _ORACLE:
        _ORACLE[PC] = _trajectory(EngineConfig.from_spec("coo+serial",
                                                         lr=0.3), PC)
    ref_traj, naive_report = _ORACLE[PC]
    cfg = EngineConfig.from_spec(spec, lr=0.3, partition=partition,
                                 merge="redundancy")
    traj, report = _trajectory(cfg, PC)
    assert np.all(np.isfinite(traj))
    assert max(abs(a - b) for a, b in zip(ref_traj, traj)) <= 1e-5, \
        (cfg.spec, ref_traj, traj)
    if spec.startswith("ell"):
        assert report["virtual_vertices"] > 0
        assert report["flop_reduction"] > 1.0
    if partition == "mincom":
        assert report["wire_bytes"] < naive_report["wire_bytes"]
    if cfg.spec in ("ell+pipelined+torus2d+mincom", "coo+serial+ring"):
        mb, feats, labels = _sweep_batch(PC, ref=True)
        want = RefEngine(RefConfig.from_spec(
            spec, partition=partition, merge="redundancy")).build(
            n_cores=PC).prepare_batch(mb, feats, labels)["report"]
        assert sorted(report) == sorted(want)
        assert report["wire_bytes"] == want["wire_bytes"]
        assert report["virtual_vertices"] == want["virtual_vertices"]
        for k in ("pair_coverage", "flop_reduction"):
            assert abs(report[k] - want[k]) <= 1e-12


# ---------------------------------------------------------------------------
# the Trainer on a non-default topology: checkpoint + resume, bit-exact
# ---------------------------------------------------------------------------
def test_trainer_rides_ring_topology_ckpt_resume_bit_exact(tmp_path):
    def build(ckpt):
        return Trainer("ell+pipelined+ring", "flickr", n_cores=2,
                       scale=0.005, feat_dim=16, hidden=16, batch_size=16,
                       lr=0.1, seed=0, pad_multiple=32, val_batches=1,
                       ckpt_dir=ckpt, ckpt_every=0, device="cpu")

    steps, mid = 6, 3
    full = build(None)
    assert full.engine.spec == "ell+pipelined+ring"
    assert full.bundle.topology.name == "ring"
    ref = full.fit(1, steps_per_epoch=steps)
    part_ = build(str(tmp_path))
    part_.train_steps(mid)
    part_.save(sync=True)
    part_.close()
    resumed = build(str(tmp_path))
    out = resumed.fit(1, steps_per_epoch=steps - mid, resume=True)
    drift = max(abs(a - b) for a, b in
                zip(ref["loss_history"][mid:], out["loss_history"]))
    assert drift == 0.0, drift
    assert out["val_acc"]
    mb, feats, labels = _sweep_batch(2, ref=True)
    want = RefEngine("ell+pipelined+ring").build(n_cores=2).prepare_batch(
        mb, feats, labels)["report"]
    assert sorted(out["plan"]) == sorted(want)
    assert out["plan"]["wire_bytes"] > 0
