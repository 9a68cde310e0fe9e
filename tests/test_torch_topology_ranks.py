"""Ring, allpairs and torus2d (and the hypercube, as the control) across
``torch.distributed`` ranks, and the int8 ``compressed_psum`` across ranks,
on the CPU with gloo: P cores over W ranks, ``c = P / W`` stacked on each.

* For (P, W) in (4, 2), (4, 4), (8, 2): every topology's
  ``reduce_scatter``, ``allgather``, the 2-wave ``allgather_pipelined`` and
  ``fold_pipelined``, and the autograd mirrors (``topology.reduce_scatter``
  / ``allgather``'s gradients) on each rank ``torch.equal`` to that rank's
  rows of the stacked call; so are ``compressed_psum`` and two
  ``ef_compress_grads`` steps with their error state, and
  ``EngineBundle.aggregate``'s ``y`` and ``dx`` for every spec of
  ``supported_topology_specs()``.
* The messages each rank sends per reduce-scatter, counted where they are
  posted (``torch.distributed.batch_isend_irecv``), against each schedule
  reckoned here for ``[c, P, t, d]`` f32 partials; no all-gather, all-to-all
  or all-reduce runs inside a reduce-scatter.  The int8 sync ships
  ``torch.int8`` codes and one f32 scale a core per rank round, and gathers
  codes and scales.
* With c = 1 (P = W = 4) the mesh aggregate of every spec against the
  reference's ``Engine(spec).build(mesh, graph=coo)`` on 4 forced host
  devices (``AxisType.Auto``, one ``conftest.run_subprocess`` call, run on a
  thread beside the spawns): ``y`` within 1e-5, ``x``'s gradient within
  2e-3, and the four ``ell+pipelined+<topology>`` specs' 5-step
  trajectories within 1e-5.
* The reference's ring-trainer test on 2 ranks: ``Trainer(
  "ell+pipelined+ring", "flickr", n_cores=2, mesh=)`` trains 6 steps,
  saves at 3 and resumes with drift 0.0, and its losses match the stacked
  Trainer's.

One ``torch.multiprocessing.spawn`` per (P, W) (a ``file://`` store under
``tmp_path``; one intra-op thread a rank); rank 0 writes what the ranks
saw.  This module imports no JAX: the spawned ranks import it.
"""
import json
import os
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402

CASES = ((4, 2), (4, 4), (8, 2))         # (P cores, W ranks)
TOPOLOGIES = ("ring", "allpairs", "torus2d", "hypercube")
T, D = 3, 7                              # rows per block; odd width
N_CHUNKS = 2
PSUM_PER_CORE = 24                       # compressed_psum's n / P
EF_SHAPES = {"w": (11, 5), "b": (3,)}    # both padded at P = 4 and 8
REF_P = 4                                # c = 1: P = W = 4
TRAJ_STEPS = 5
RING_TRAINER = dict(scale=0.005, feat_dim=16, hidden=16, batch_size=16,
                    lr=0.1, seed=0, pad_multiple=32, val_batches=1,
                    input_pipeline="sync")
RING_STEPS, RING_MID = 6, 3


def _inputs(P):
    """The collectives' inputs at P cores, from one seed."""
    rng = np.random.default_rng(1000 + P)
    f = np.float32
    return {
        "part": rng.standard_normal((P, P, T, D)).astype(f),
        "x": rng.standard_normal((P, T, D)).astype(f),
        "fold_x": rng.standard_normal((P, P * T, D)).astype(f),
        "ct_rs": rng.standard_normal((P, T, D)).astype(f),
        "ct_ag": rng.standard_normal((P, P, T, D)).astype(f),
        "psum": (rng.standard_normal((P, P * PSUM_PER_CORE))
                 * rng.uniform(0.1, 10, (P, 1))).astype(f),
        "grads": [{k: rng.standard_normal((P,) + s).astype(f)
                   for k, s in EF_SHAPES.items()} for _ in range(2)]}


def _graph(P):
    """The engine aggregate's rectangular COO (the reference sweep's
    shape at P cores), its ``x`` and, at ``REF_P``, the 5-step training
    batch and weights."""
    rng = np.random.default_rng(P)
    n_dst, n_src, e = 16 * P, 32 * P, 2000
    g = {"rows": rng.integers(0, n_dst, e), "cols": rng.integers(0, n_src, e),
         "vals": rng.standard_normal(e).astype(np.float32),
         "n_dst": n_dst, "n_src": n_src,
         "x": rng.standard_normal((n_src, 20)).astype(np.float32)}
    n_mid = 8 * P
    g.update(mb_rows=rng.integers(0, n_mid, 300),
             mb_cols=rng.integers(0, n_src, 300),
             mb_vals=np.abs(rng.standard_normal(300)).astype(np.float32)
             + 0.1, n_mid=n_mid,
             feats=rng.standard_normal((n_src, 8)).astype(np.float32),
             labels=rng.integers(0, 4, n_mid).astype(np.int32),
             w0=(rng.standard_normal((8, 4)) * 8 ** -0.5).astype(np.float32))
    return g


def _traj_specs():
    return [f"ell+pipelined+{t}" for t in TOPOLOGIES]


class _Wire:
    """Records, while active, every message posted through
    ``batch_isend_irecv`` (``(dtype, bytes)`` of each send, one list per
    call) and every collective call."""

    COLLECTIVES = ("all_gather_into_tensor", "all_gather_single",
                   "all_gather", "all_to_all_single", "all_reduce",
                   "reduce_scatter_tensor")

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self.collectives = [], []
        self._saved = {n: getattr(dist, n) for n in
                       ("batch_isend_irecv",) + self.COLLECTIVES
                       if hasattr(dist, n)}
        batch = self._saved["batch_isend_irecv"]

        def post(ops):
            self.calls.append([(str(op.tensor.dtype),
                                op.tensor.numel() * op.tensor.element_size())
                               for op in ops if op.op is dist.isend])
            return batch(ops)

        def logged(name, fn):
            def call(*args, **kwargs):
                t = args[1] if name != "all_reduce" else args[0]
                self.collectives.append((name, str(t.dtype)))
                return fn(*args, **kwargs)
            return call

        dist.batch_isend_irecv = post
        for name in self.COLLECTIVES:
            if name in self._saved:
                setattr(dist, name, logged(name, self._saved[name]))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def _collectives(P, lay, rank_rows, res):
    """Every topology's collectives, the mirrors and the int8 sync on this
    rank, against the stacked calls' rows."""
    from repro_torch.distributed.compress import (compressed_psum,
                                                  ef_compress_grads,
                                                  init_error_state)
    from repro_torch.engine import get_topology
    from repro_torch.topology import allgather, reduce_scatter

    inp = {k: v for k, v in _inputs(P).items() if k != "grads"}
    full = {k: torch.from_numpy(v) for k, v in inp.items()}
    mine = {k: v[rank_rows].contiguous() for k, v in full.items()}

    def partials(xc):
        return (xc * 1.5 - 0.25).reshape(xc.shape[0], P, T, -1)

    for name in TOPOLOGIES:
        topo = get_topology(name)
        with _Wire() as wire:
            rs = topo.reduce_scatter(mine["part"], P, layout=lay)
        checks = {
            "reduce_scatter": (rs, topo.reduce_scatter(full["part"], P)),
            "allgather": (topo.allgather(mine["x"], P, layout=lay),
                          topo.allgather(full["x"], P)),
            "allgather_pipelined": (
                topo.allgather_pipelined(mine["x"], P, N_CHUNKS, layout=lay),
                topo.allgather_pipelined(full["x"], P, N_CHUNKS)),
            "fold_pipelined": (
                topo.fold_pipelined(P, N_CHUNKS, partials, mine["fold_x"],
                                    layout=lay),
                topo.fold_pipelined(P, N_CHUNKS, partials, full["fold_x"])),
        }
        grads = []
        for src, lay_ in ((mine, lay), (full, None)):
            part = src["part"].clone().requires_grad_(True)
            x = src["x"].clone().requires_grad_(True)
            (g_rs,) = torch.autograd.grad(
                reduce_scatter(name, P, part, lay_), part, src["ct_rs"])
            (g_ag,) = torch.autograd.grad(
                allgather(name, P, x, lay_), x, src["ct_ag"])
            grads.append((g_rs, g_ag))
        checks["reduce_scatter_grad"] = (grads[0][0], grads[1][0])
        checks["allgather_grad"] = (grads[0][1], grads[1][1])
        for what, (got, want) in checks.items():
            res[("equal", name, what)] = bool(torch.equal(
                got, want[rank_rows]))
        res[("wire", name)] = (wire.calls, wire.collectives)

    with _Wire() as wire:
        got = compressed_psum(mine["psum"], n_cores=P, layout=lay)
    res[("equal", "int8", "compressed_psum")] = bool(torch.equal(
        got, compressed_psum(full["psum"], n_cores=P)[rank_rows]))
    res[("wire", "int8")] = (wire.calls, wire.collectives)
    grads = _inputs(P)["grads"]
    like = {k: torch.zeros(s) for k, s in EF_SHAPES.items()}
    errs = [init_error_state(like, P)]
    errs.append({k: e[rank_rows] for k, e in errs[0].items()})
    same = True
    for step, g in enumerate(grads):
        mean_s, errs[0] = ef_compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, errs[0],
            n_cores=P)
        mean_m, errs[1] = ef_compress_grads(
            {k: torch.from_numpy(v[rank_rows]) for k, v in g.items()},
            errs[1], n_cores=P, layout=lay)
        same &= all(torch.equal(mean_m[k], mean_s[k][rank_rows])
                    and torch.equal(errs[1][k], errs[0][k][rank_rows])
                    for k in EF_SHAPES)
    res[("equal", "int8", "ef_compress_grads")] = bool(same)


def _engine(P, mesh, res):
    """Every spec's ``EngineBundle.aggregate`` on the mesh against the
    stacked bundle's bits; at ``REF_P`` the outputs, gradients and
    trajectories for the reference."""
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.engine import supported_topology_specs
    from repro_torch.graph import from_edges

    g = _graph(P)
    coo = from_edges(g["rows"], g["cols"], g["vals"], g["n_dst"],
                     g["n_src"])
    for spec in supported_topology_specs():
        got = []
        for bundle in (Engine(spec).build(P, mesh=mesh),
                       Engine(spec).build(P, device="cpu")):
            x = torch.from_numpy(g["x"]).requires_grad_(True)
            y = bundle.aggregate(x, coo)
            (dx,) = torch.autograd.grad((y * y).sum(), x)
            got.append((y.detach(), dx))
        res[("agg", spec)] = (bool(torch.equal(got[0][0], got[1][0])),
                              bool(torch.equal(got[0][1], got[1][1])))
        if P == REF_P:
            res[("agg_out", spec)] = (got[0][0].numpy(), got[0][1].numpy())
    if P != REF_P:
        return

    class _MB:
        layers = [from_edges(g["mb_rows"], g["mb_cols"], g["mb_vals"],
                             g["n_mid"], g["n_src"])]

    for spec in _traj_specs():
        bundle = Engine(EngineConfig.from_spec(spec, lr=0.3)).build(
            P, mesh=mesh)
        batch = bundle.shard_batch(_MB(), g["feats"], g["labels"])
        params, traj = [{"w": torch.from_numpy(g["w0"])}], []
        for _ in range(TRAJ_STEPS):
            params, loss = bundle.train_step(params, batch)
            traj.append(float(loss))
        res[("traj", spec)] = traj


def _ring_trainer(out, res):
    """The reference's ring-trainer test on 2 ranks: 6 steps, then 3 +
    a checkpoint + a resume for 3."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_topology_mesh
    from repro_torch.launch.trainer import Trainer

    mesh = make_topology_mesh(2, "ring", device_type="cpu")
    ckpt = os.path.join(out, "ring_ckpt")

    def build(ckpt_dir):
        return Trainer("ell+pipelined+ring", "flickr", n_cores=2, mesh=mesh,
                       ckpt_dir=ckpt_dir, ckpt_every=0, **RING_TRAINER)

    full = build(None)
    ref = full.fit(1, steps_per_epoch=RING_STEPS)
    full.close()
    part = build(ckpt)
    part.train_steps(RING_MID)
    part.save(sync=True)
    part.close()
    resumed = build(ckpt)
    again = resumed.fit(1, steps_per_epoch=RING_STEPS - RING_MID,
                        resume=True)
    resumed.close()
    dist.barrier()
    res["ring_trainer"] = {
        "topology": full.bundle.topology.name,
        "losses": ref["loss_history"], "resumed": again["loss_history"],
        "val_acc": again["val_acc"]}


def _worker(rank, world, P, store, out):
    import torch.distributed as dist

    from repro_torch.engine.engine import core_layout
    from repro_torch.launch.mesh import make_topology_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = {}
    try:
        mesh = make_topology_mesh(P, "torus2d", device_type="cpu")
        lay = core_layout(mesh, P)
        _collectives(P, lay, slice(lay.first, lay.first + lay.count), res)
        _engine(P, mesh, res)
        if (P, world) == CASES[0]:
            _ring_trainer(out, res)
        if rank == 0:
            with open(os.path.join(out, "ranks.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_REF = """
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.engine import Engine, EngineConfig, supported_topology_specs
from repro.graph.coo import from_edges

g = dict(np.load({path!r}))
mesh = jax.make_mesh(({P},), ("model",), axis_types=(AxisType.Auto,))
coo = from_edges(g["rows"], g["cols"], g["vals"], int(g["n_dst"]),
                 int(g["n_src"]))
x = jnp.asarray(g["x"])
out = {{}}
for spec in supported_topology_specs():
    b = Engine(spec).build(mesh, graph=coo)
    out["y " + spec] = np.asarray(b.aggregate(x))
    out["dx " + spec] = np.asarray(jax.grad(
        lambda xx: jnp.sum(b.aggregator()(xx) ** 2))(x))

class _MB:
    layers = [from_edges(g["mb_rows"], g["mb_cols"], g["mb_vals"],
                         int(g["n_mid"]), int(g["n_src"]))]

traj = {{}}
for spec in {specs!r}:
    bundle = Engine(EngineConfig.from_spec(spec, lr=0.3)).build(mesh)
    bb = bundle.shard_batch(_MB(), g["feats"], g["labels"])
    p, t = [{{"w": jnp.asarray(g["w0"])}}], []
    for _ in range({steps}):
        p, loss = bundle.train_step(p, bb)
        t.append(float(loss))
    traj[spec] = t
np.savez({out!r}, **out)
print("REF" + json.dumps(traj))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess on a thread, one spawn per case, then the
    stacked ring Trainer."""
    import torch.multiprocessing as mp

    ref_dir = str(tmp_path_factory.mktemp("ranks_ref"))
    path = os.path.join(ref_dir, "graph.npz")
    np.savez(path, **_graph(REF_P))
    ref_out = os.path.join(ref_dir, "ref.npz")
    ref = {}

    def reference():
        try:
            ref["stdout"] = run_subprocess(_REF.format(
                path=path, P=REF_P, specs=_traj_specs(), steps=TRAJ_STEPS,
                out=ref_out), n_devices=REF_P)
        except Exception as e:     # re-raised on the main thread
            ref["error"] = e

    thread = threading.Thread(target=reference)
    thread.start()
    got = {}
    try:
        for P, world in CASES:
            out = str(tmp_path_factory.mktemp(f"ranks_p{P}_w{world}"))
            mp.spawn(_worker, args=(world, P, os.path.join(out, "store"),
                                    out), nprocs=world, join=True)
            with open(os.path.join(out, "ranks.pkl"), "rb") as f:
                got[(P, world)] = pickle.load(f)
        from repro_torch.launch.trainer import Trainer
        tr = Trainer("ell+pipelined+ring", "flickr", n_cores=2,
                     device="cpu", ckpt_every=0, **RING_TRAINER)
        stacked = tr.fit(1, steps_per_epoch=RING_STEPS)["loss_history"]
        tr.close()
    finally:
        thread.join()
    if "error" in ref:
        raise ref["error"]
    line = [ln for ln in ref["stdout"].splitlines() if ln.startswith("REF")]
    return {"ranks": got, "ref_traj": json.loads(line[-1][3:]),
            "ref": dict(np.load(ref_out)), "stacked_ring": stacked}


def _case_id(case):
    return f"P{case[0]}-W{case[1]}"


WHATS = ("reduce_scatter", "allgather", "allgather_pipelined",
         "fold_pipelined", "reduce_scatter_grad", "allgather_grad")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("what", WHATS)
def test_collective_equals_the_stacked_rows(runs, case, topology, what):
    assert runs["ranks"][case][("equal", topology, what)]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("what", ["compressed_psum", "ef_compress_grads"])
def test_int8_sync_equals_the_stacked_rows(runs, case, what):
    assert runs["ranks"][case][("equal", "int8", what)]


def _schedule(topology, P, W):
    """Each reduce-scatter call's sends, in bytes, that rank 0's schedule
    posts for ``[c, P, T, D]`` f32 partials (one list per
    ``batch_isend_irecv`` call)."""
    from repro_torch.topology.torus2d import _bit_orders

    c, block = P // W, T * 4
    low = c.bit_length() - 1
    if topology == "ring":
        return [[block * D]] * (P - 1)
    if topology == "hypercube":
        return [[c * P // 2 ** (i + 1) * block * D]
                for i in range(W.bit_length() - 1)]
    if topology == "torus2d":
        order_a, order_b = _bit_orders(P)
        return [[c * P // 2 ** (j + 1) * block * dh]
                for dh, order in ((D // 2, order_a), (D - D // 2, order_b))
                for j, b in enumerate(order) if b >= low]
    raise ValueError(topology)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_reduce_scatter_ships_its_schedule(runs, case, topology):
    P, W = case
    c = P // W
    calls, collectives = runs["ranks"][case][("wire", topology)]
    assert collectives == []
    assert all(dtype == "torch.float32" for call in calls
               for dtype, _ in call)
    sizes = [[n for _, n in call] for call in calls]
    if topology != "allpairs":
        assert sizes == _schedule(topology, P, W)
        return
    # allpairs: c·(P − c) blocks, at most two messages a rotation
    block = T * D * 4
    assert len(calls) <= P - 1 and all(1 <= len(s) <= 2 for s in sizes)
    assert all(n % block == 0 for s in sizes for n in s)
    assert sum(n for s in sizes for n in s) == c * (P - c) * block


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_int8_sync_ships_int8_codes(runs, case):
    P, W = case
    c = P // W
    calls, collectives = runs["ranks"][case][("wire", "int8")]
    codes = [[c * P // 2 ** (i + 1) * PSUM_PER_CORE]
             for i in range(W.bit_length() - 1)]
    want = [call for code in codes
            for call in ([("torch.int8", code[0])], [("torch.float32",
                                                      4 * c)])]
    assert calls == want
    assert sorted(dtype for _, dtype in collectives) == ["torch.float32",
                                                         "torch.int8"]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("part", ["y", "dx"])
def test_mesh_aggregate_equals_the_stacked_bits(runs, case, part):
    from repro_torch.engine import supported_topology_specs

    got = runs["ranks"][case]
    which = 0 if part == "y" else 1
    assert [s for s in supported_topology_specs()
            if not got[("agg", s)][which]] == []


@pytest.mark.parametrize("part", ["y", "dx"])
def test_mesh_aggregate_matches_the_reference_engine(runs, part):
    from repro_torch.engine import supported_topology_specs

    got, ref = runs["ranks"][(REF_P, REF_P)], runs["ref"]
    for spec in supported_topology_specs():
        y, dx = got[("agg_out", spec)]
        if part == "y":
            assert np.abs(y - ref["y " + spec]).max() <= 1e-5, spec
        else:
            np.testing.assert_allclose(dx, ref["dx " + spec], rtol=2e-3,
                                       atol=2e-3, err_msg=spec)


@pytest.mark.parametrize("spec", _traj_specs())
def test_mesh_trajectory_matches_the_reference(runs, spec):
    got = runs["ranks"][(REF_P, REF_P)][("traj", spec)]
    want = runs["ref_traj"][spec]
    assert np.all(np.isfinite(got))
    assert np.abs(np.subtract(got, want)).max() <= 1e-5, (got, want)


def test_ring_trainer_on_two_ranks_resumes_without_drift(runs):
    got = runs["ranks"][CASES[0]]["ring_trainer"]
    assert got["topology"] == "ring"
    drift = max(abs(a - b) for a, b in
                zip(got["losses"][RING_MID:], got["resumed"]))
    assert drift == 0.0, drift
    assert got["val_acc"], "no validation ran"
    assert np.abs(np.subtract(got["losses"], runs["stacked_ring"])).max() \
        <= 1e-6, (got["losses"], runs["stacked_ring"])
