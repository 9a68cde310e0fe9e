"""Port vs reference: the paper's network layer — Algorithm 1 routing, its
dimension-ordered collective schedule, the Block-Message multicast waves
and the analytic wire bytes — on the same numpy inputs.

Everything here is host numpy in both packages, so the contract is
equality: routing tables, positions, cycle counts and per-message arrival
cycles array-equal (the port draws from ``np.random.default_rng(seed)`` in
the reference's order), schedules, wave statistics and dicts equal, and
``validate_routing`` raising in both on the same corrupted tables.  The
last test runs ``examples/torch_routing_playground.py`` beside the
reference's example and compares what they print.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import blockmsg as ref_bm  # noqa: E402
from repro.core import routing as ref_rt  # noqa: E402
from repro.core import schedule as ref_sc  # noqa: E402
from repro.distributed.aggregate import \
    schedule_bytes as ref_schedule_bytes  # noqa: E402
from repro.graph.coo import from_edges as ref_from_edges  # noqa: E402
from repro.graph.partition import \
    block_partition as ref_block_partition  # noqa: E402
from repro_torch.core import blockmsg as bm  # noqa: E402
from repro_torch.core import routing as rt  # noqa: E402
from repro_torch.core import schedule as sc  # noqa: E402
from repro_torch.distributed import schedule_bytes  # noqa: E402
from repro_torch.graph.coo import from_edges  # noqa: E402
from repro_torch.graph.partition import block_partition  # noqa: E402

from conftest import REPO, SRC  # noqa: E402


def _same_result(got, want):
    assert got.cycles == want.cycles
    assert got.n_messages == want.n_messages
    for f in ("table", "positions", "per_message_cycles"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ndim", [2, 3, 4, 5])
@pytest.mark.parametrize("fuse", [1, 2, 3, 4])
def test_route_messages_equals_reference_on_fuse_waves(ndim, fuse):
    for seed in range(6):
        w_rng, r_rng = (np.random.default_rng(seed) for _ in range(2))
        src, dst = rt.make_fuse_wave(fuse, w_rng, ndim)
        r_src, r_dst = ref_rt.make_fuse_wave(fuse, r_rng, ndim)
        assert np.array_equal(src, r_src) and np.array_equal(dst, r_dst)
        got = rt.route_messages(src, dst, ndim=ndim, seed=seed)
        _same_result(got, ref_rt.route_messages(src, dst, ndim=ndim,
                                                seed=seed))
        rt.validate_routing(got, src, dst, ndim)


@pytest.mark.parametrize("ndim", [3, 4])
def test_route_messages_equals_reference_on_arbitrary_destinations(ndim):
    """Non-permutation destinations (repeats, messages already home) and
    waves of any length, 4 messages per sender at most."""
    n = 1 << ndim
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        m = int(rng.integers(1, 4 * n + 1))
        src = rng.permutation(np.repeat(np.arange(n), 4))[:m]
        dst = rng.integers(0, n, m)
        got = rt.route_messages(src, dst, ndim=ndim, seed=seed,
                                max_cycles=512)
        _same_result(got, ref_rt.route_messages(src, dst, ndim=ndim,
                                                seed=seed, max_cycles=512))
        rt.validate_routing(got, src, dst, ndim)
    home = rt.route_messages([3, 5], [3, 5])          # nothing to route
    _same_result(home, ref_rt.route_messages([3, 5], [3, 5]))
    assert home.cycles == 0 and home.table.shape == (0, 2)


def test_route_messages_rejects_what_the_reference_rejects():
    for pkg in (rt, ref_rt):
        with pytest.raises(ValueError, match="mismatch"):
            pkg.route_messages([0, 1], [1])
        with pytest.raises(ValueError, match="core ids"):
            pkg.route_messages([0, 16], [1, 2])
        with pytest.raises(RuntimeError, match="converge"):
            pkg.route_messages(np.arange(16), np.arange(16)[::-1],
                               max_cycles=1)


def _corruptions(res, src, dst):
    """Tables that break one §4.3.2 invariant each."""
    t = res.table
    moved = np.argwhere(t >= 0)
    c, i = moved[0]
    out = []
    bad = t.copy()
    bad[c, i] = src[i] if c == 0 else res.positions[c, i]  # a zero hop
    out.append(bad)
    bad = t.copy()
    bad[c, i] = res.positions[c, i] ^ 3                    # two bits
    out.append(bad)
    bad = t.copy()
    bad[-1] = rt.DONE                                      # never arrives
    out.append(bad)
    # a channel used twice: two messages of one sender take one edge
    for cc in range(t.shape[0]):
        hops = [(res.positions[cc, j], t[cc, j]) for j in range(len(src))
                if t[cc, j] >= 0]
        senders = [h[0] for h in hops]
        dup = [s for s in set(senders) if senders.count(s) > 1]
        if dup:
            idx = [j for j in range(len(src)) if t[cc, j] >= 0
                   and res.positions[cc, j] == dup[0]]
            bad = t.copy()
            bad[cc, idx[1]] = bad[cc, idx[0]]
            out.append(bad)
            break
    return out


def test_validate_routing_raises_in_both_on_the_same_corruptions():
    rng = np.random.default_rng(7)
    src, dst = rt.make_fuse_wave(4, rng)
    res = rt.route_messages(src, dst, seed=3)
    rt.validate_routing(res, src, dst)
    ref_rt.validate_routing(ref_rt.RoutingResult(
        res.table, res.positions, res.cycles, res.per_message_cycles),
        src, dst)
    bads = _corruptions(res, src, dst)
    assert len(bads) == 4
    for bad in bads:
        for pkg in (rt, ref_rt):
            with pytest.raises(AssertionError):
                pkg.validate_routing(pkg.RoutingResult(
                    bad, res.positions, res.cycles, res.per_message_cycles),
                    src, dst)
    # Constraint 1: five messages into one core in one cycle (five
    # single-bit hops, the fifth over bit 4, checked as a 4-D cube)
    src5 = np.array([1, 2, 4, 8, 16])
    table = np.array([[0, 0, 0, 0, 0]])
    for pkg in (rt, ref_rt):
        with pytest.raises(AssertionError):
            pkg.validate_routing(pkg.RoutingResult(
                table, np.stack([src5, np.zeros(5, np.int64)]), 1,
                np.ones(5, np.int64)), src5, np.zeros(5, np.int64))


def test_helpers_equal_reference():
    for cur in range(32):
        for dst in range(32):
            assert rt.xor_path_set(cur, dst, 5) == \
                ref_rt.xor_path_set(cur, dst, 5)
    x = np.random.default_rng(0).integers(0, 1 << 12, 100)
    assert np.array_equal(rt.popcount(x), ref_rt.popcount(x))


@pytest.mark.parametrize("fuse", [1, 2, 3, 4])
def test_fuse_experiment_and_bandwidth_model_equal_reference(fuse):
    got = rt.fuse_experiment(fuse, n_trials=20, seed=fuse)
    assert got == ref_rt.fuse_experiment(fuse, n_trials=20, seed=fuse)
    period_ns = got["avg_cycles"] * 4.0
    assert rt.aggregate_bandwidth_model(period_ns) == \
        ref_rt.aggregate_bandwidth_model(period_ns)
    kw = dict(line_bytes=32, n_cores=8, fan_in=3, compression=2.5)
    assert rt.aggregate_bandwidth_model(period_ns, **kw) == \
        ref_rt.aggregate_bandwidth_model(period_ns, **kw)


# ---------------------------------------------------------------------------
# the collective schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ndim", [1, 2, 4, 5])
def test_schedule_functions_equal_reference(ndim):
    def rounds(rs):
        return [(r.dim, r.mask, r.partner(5)) for r in rs]

    assert rounds(sc.reduce_scatter_rounds(ndim)) == \
        rounds(ref_sc.reduce_scatter_rounds(ndim))
    assert rounds(sc.allgather_rounds(ndim)) == \
        rounds(ref_sc.allgather_rounds(ndim))
    plan, ref_plan = sc.make_plan(1 << ndim), ref_sc.make_plan(1 << ndim)
    assert (plan.ndim, plan.n_cores, rounds(plan.rounds)) == \
        (ref_plan.ndim, ref_plan.n_cores, rounds(ref_plan.rounds))
    rng = np.random.default_rng(ndim)
    n = 1 << ndim
    for fuse in (1, 3):
        src = np.concatenate([rng.permutation(n) for _ in range(fuse)])
        dst = rng.integers(0, n, len(src))
        assert np.array_equal(sc.dimension_ordered_table(src, dst, ndim),
                              ref_sc.dimension_ordered_table(src, dst, ndim))
        assert np.array_equal(sc.round_bytes(src, dst, 256, ndim),
                              ref_sc.round_bytes(src, dst, 256, ndim))
        assert sc.compare_schedules(src, dst, ndim=ndim, seed=fuse) == \
            ref_sc.compare_schedules(src, dst, ndim=ndim, seed=fuse)
    assert sc.compare_schedules([], [], ndim=ndim) == \
        ref_sc.compare_schedules([], [], ndim=ndim)
    for pkg in (sc, ref_sc):
        with pytest.raises(ValueError, match="power of two"):
            pkg.make_plan(12)


@pytest.mark.parametrize("n_cores", [2, 4, 16])
def test_schedule_bytes_equals_reference(n_cores):
    for n_dst, n_src, d in ((1024, 4096, 256), (10368, 103680, 41),
                            (17, 33, 5)):
        assert schedule_bytes(n_dst, n_src, d, n_cores) == \
            ref_schedule_bytes(n_dst, n_src, d, n_cores)
        assert schedule_bytes(n_dst, n_src, d, n_cores, 2) == \
            ref_schedule_bytes(n_dst, n_src, d, n_cores, 2)


# ---------------------------------------------------------------------------
# Block-Message multicast waves
# ---------------------------------------------------------------------------
def _blocked_pair(seed, n, e, P):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, e), rng.integers(0, n, e)
    v = rng.standard_normal(e).astype(np.float32)
    return (block_partition(from_edges(r, c, v, n, n), P),
            ref_block_partition(ref_from_edges(r, c, v, n, n), P))


@pytest.mark.parametrize("P,group_size", [(4, 4), (16, 4), (16, 3)])
def test_waves_equal_reference(P, group_size):
    blocked, ref_blocked = _blocked_pair(P, 256 * P // 4, 900 * P // 4, P)
    waves = bm.build_waves(blocked, group_size)
    ref_waves = ref_bm.build_waves(ref_blocked, group_size)
    assert len(waves) == len(ref_waves) > 0
    for w, rw in zip(waves, ref_waves):
        assert w.stage == rw.stage
        assert np.array_equal(w.src, rw.src) and np.array_equal(w.dst, rw.dst)
        assert (w.total_msgs, w.total_nnz) == (rw.total_msgs, rw.total_nnz)
        assert len(w.messages) == len(rw.messages)
        for m, rm in zip(w.messages, rw.messages):
            for f in dataclasses.fields(rm):
                a, b = getattr(m, f.name), getattr(rm, f.name)
                assert np.array_equal(a, b), f.name
            rows = list(bm.message_rowlists(m))
            ref_rows = list(ref_bm.message_rowlists(rm))
            assert len(rows) == len(ref_rows) == m.n_msgs
            for (b1, d1, w1), (b2, d2, w2) in zip(rows, ref_rows):
                assert b1 == b2 and np.array_equal(d1, d2) \
                    and np.array_equal(w1, w2)
        # every wave routes under Algorithm 1's constraints
        res = rt.route_messages(w.src, w.dst, seed=w.stage)
        _same_result(res, ref_rt.route_messages(rw.src, rw.dst,
                                                seed=rw.stage))
        rt.validate_routing(res, w.src, w.dst)
    stats = bm.wave_statistics(waves)
    assert stats == ref_bm.wave_statistics(ref_waves)
    off_diag = sum(len(e[0]) for (i, j), e in blocked.block_edges.items()
                   if i != j)
    assert stats["raw_edges"] == off_diag
    assert bm.wave_statistics([]) == ref_bm.wave_statistics([])


def test_routing_example_prints_what_the_reference_example_prints():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    outs = []
    for script in ("torch_routing_playground.py", "routing_playground.py"):
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "examples", script)],
            env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout)
    assert "block messages" in outs[0] and "Fuse4 wave" in outs[0]
    assert outs[0] == outs[1]


class _HostEvent:
    """``torch.cuda.Event`` on the host clock (the rehearsals' stand-in)."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_chip_smoke_network_phase_rehearsal(monkeypatch, capsys):
    """Phase 13 end to end on the CPU at reddit scale 0.01, batch 64,
    hidden 32, 20 Fig. 9 trials, with the ELL walk's plain version made to
    report launches (as the card's kernel counts them) and host-clock
    events: every gate passes and the per-core gradients walk the ELL
    kernels."""
    import importlib

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from repro_torch.graph import make_dataset

    spmm_mod = importlib.import_module("repro_torch.kernels.spmm")
    walk = spmm_mod._walk
    monkeypatch.setattr(spmm_mod, "_walk", lambda name, w, x, out: (
        walk(name, w, x, out) or bool(w.cols and len(w.items))))
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for name, value in (("TRAIN_BATCH", 64), ("HIDDEN", 32), ("REPS", 2),
                        ("FIG9_TRIALS", 20)):
        monkeypatch.setattr(cs, name, value)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ds = make_dataset("reddit", scale=0.01)
        out, launches = cs.network_phase(torch, torch.device("cpu"), ds,
                                         cs.first_train_batch(ds))
    finally:
        torch.set_num_threads(n_threads)
    cs.print_network(out, "a host, no card")
    assert [s["fuse"] for s in out["fig9"]["series"]] == [1.0, 2.0, 3.0, 4.0]
    assert set(out["waves"]) == {"hop0", "hop1"}
    for rec in out["waves"].values():
        assert rec["stats"]["waves"] == len(rec["waves"]) == 4
        assert rec["stats"]["wire_messages"] == rec["off_diagonal_rows"]
    sync = out["sync"]
    assert sync["card_equals_cpu"] and sync["psum_rel_err"] < 0.05
    assert sync["wire_bytes_per_core"]["f32"] == 8 * (
        sync["n_params"] - sync["n_params"] // 16)
    got = launches["network weight-bank sync"]
    assert got["spmm_ell"] > 0 and got["spmm_ell_t"] > 0
    assert "network weight-bank sync" in capsys.readouterr().out
