"""The hypercube's cores over a ``torch.distributed`` mesh, on the CPU with
gloo: P = 4 cores over W ∈ {2, 4} ranks (``repro_torch.launch.mesh.
make_topology_mesh(device_type="cpu")``), each rank stacking ``P / W``.

* ``EngineBundle.aggregate`` on the mesh: ``y`` and ``dx`` ``torch.equal``
  to the stacked bundle's, for ``ell+pipelined`` (dedup and
  ``merge="redundancy"``), ``block+pipelined`` and ``coo+serial`` over the
  hypercube (the fold's rank rounds add ``mine + recv`` in the stacked
  order);
* ``Trainer(mesh=)`` for 3 steps from the reference's step-0 checkpoint:
  within 1e-6 of the stacked Trainer's losses and parameters, and at
  W = 4 within the reference tolerances (1e-5 on losses, 2e-3 rtol/atol on
  parameters) of the reference ``Trainer(mesh=)`` on a 4-device
  ``AxisType.Auto`` mesh; on the mesh Trainer's parameters, its validation
  accuracy equal to the stacked Trainer's (at batch 32, and at batch 30,
  whose padded rows the last rank masks), and ``EngineBundle.forward``'s
  logits of one host batch ``torch.equal`` to the stacked bundle's,
  gathered and, on every rank, its own rows;
* a checkpoint at step 2 (rank 0 writes, every rank resumes) replays step
  3 within 1e-6 at W = 2;
* ``grad_accum(axis_names=("data",), bucketed=False|True)`` over 2 ranks
  within 1e-6 of the reference's ``grad_accum`` inside ``shard_map`` over
  a 2-device ``("data",)`` mesh;
* a topology registered with ``crosses_ranks = False`` is refused by
  ``make_topology_mesh`` and ``Engine.build(mesh=)`` on 2 and 4 ranks.

One ``torch.multiprocessing.spawn`` per world size (a ``file://`` store
under ``tmp_path``, so xdist workers never share a port; one intra-op
thread per rank), after one reference subprocess; rank 0 writes what the
ranks saw, and the tests read it.  This module imports no JAX: the
spawned ranks import it.
"""
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402

P = 4
WORLDS = (2, 4)
SPEC = "ell+pipelined"
TRAIN = dict(scale=0.004, feat_dim=16, hidden=16, batch_size=32, lr=0.05,
             seed=0, input_pipeline="sync")
STEPS = 3
AGG_CASES = [("ell+pipelined", "dedup"), ("ell+pipelined", "redundancy"),
             ("block+pipelined", "dedup"), ("coo+serial", "dedup")]
# grad_accum: a linear least-squares loss, 8 rows a rank, 2 microbatches
GA_SHAPES = dict(rows=16, d=6, k=3, n_micro=2)


def _agg_graph(seed=7, n=64, nnz=420):
    """A square COO with duplicate edges, a hub row and zero-weight
    padding (``mincom``-free, so every format shards it), its input ``x``
    and a cotangent ``g``."""
    from repro_torch.graph import from_edges

    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n - 6, nnz), np.full(40, 5),
                           np.zeros(8, np.int64)])
    cols = np.concatenate([rng.integers(0, n - 4, nnz),
                           rng.integers(0, n, 40), np.zeros(8, np.int64)])
    vals = np.concatenate([rng.uniform(0.05, 1.0, nnz + 40),
                           np.zeros(8)]).astype(np.float32)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    g = rng.standard_normal((n, 8)).astype(np.float32)
    return from_edges(rows, cols, vals, n, n), x, g


def _ga_data():
    rng = np.random.default_rng(11)
    s = GA_SHAPES
    return {"w": rng.standard_normal((s["d"], s["k"])).astype(np.float32),
            "b": rng.standard_normal(s["k"]).astype(np.float32),
            "x": rng.standard_normal((s["rows"], s["d"])).astype(np.float32),
            "y": rng.standard_normal((s["rows"], s["k"])).astype(np.float32)}


def _ga_loss(params, batch):
    err = batch["x"] @ params["w"] + params["b"] - batch["y"]
    return (err * err).mean()


def _spec(spec, merge):
    from repro_torch.engine import EngineConfig
    return EngineConfig.from_spec(spec, merge=merge)


def _params(tr):
    return [p["w"].detach().cpu().numpy() for p in tr.params]


def _plain_accuracy(tr):
    """``tr``'s validation accuracy from its stacked logits' first
    ``n_seeds`` rows of each batch (no mask, no collective)."""
    hits = total = 0
    for n_seeds, batch in tr._val_batches:
        logits = tr.bundle.forward(tr.params, batch)
        hits += int((logits[:n_seeds].argmax(-1)
                     == batch["labels"][:n_seeds]).sum())
        total += n_seeds
    return hits / total


def _stacked_only_refused(mesh):
    """Whether a topology registered with ``crosses_ranks = False`` (the
    ring's rounds, none across ranks) is refused on this many ranks by
    ``make_topology_mesh`` and by ``Engine.build(mesh=)``."""
    from repro_torch.engine import Engine, register_topology
    from repro_torch.engine.registry import _TOPOLOGIES
    from repro_torch.launch.mesh import make_topology_mesh
    from repro_torch.topology import RingTopology

    @register_topology("ring-without-rank-rounds")
    class _StackedOnly(RingTopology):
        crosses_ranks = False

    refused = []
    try:
        for attempt in (
                lambda: make_topology_mesh(P, "ring-without-rank-rounds",
                                           device_type="cpu"),
                lambda: Engine("ell+pipelined+ring-without-rank-rounds"
                               ).build(P, mesh=mesh)):
            try:
                attempt()
                refused.append(False)
            except NotImplementedError as e:
                refused.append("crosses_ranks" in str(e))
    finally:
        _TOPOLOGIES.pop("ring-without-rank-rounds")
    return all(refused) and len(refused) == 2


def _worker(rank, world, store, out, ckpt):
    """One rank: every check's numbers, written by rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import grad_accum
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.engine import Engine
    from repro_torch.launch.mesh import make_topology_mesh
    from repro_torch.launch.trainer import Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    res = {}
    try:
        mesh = make_topology_mesh(P, "hypercube", device_type="cpu")
        coo, x, g = _agg_graph()
        for spec, merge in AGG_CASES:
            cfg = _spec(spec, merge)
            got = []
            for bundle in (Engine(cfg).build(P, device="cpu"),
                           Engine(cfg).build(P, mesh=mesh)):
                xt = torch.from_numpy(x).requires_grad_(True)
                y = bundle.aggregate(xt, coo)
                (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
                got.append((y.detach(), dx))
            res[("agg", spec, merge)] = (
                torch.equal(got[0][0], got[1][0]),
                torch.equal(got[0][1], got[1][1]),
                float((got[0][0] - got[1][0]).abs().max()),
                float((got[0][1] - got[1][1]).abs().max()))
        res["stacked_only_refused"] = _stacked_only_refused(mesh)
        tr = Trainer(SPEC, "reddit", n_cores=P, mesh=mesh, ckpt_dir=ckpt,
                     ckpt_every=0, **TRAIN)
        assert tr.resume() and tr.global_step == 0
        res["losses"] = tr.train_steps(STEPS)
        res["params"] = _params(tr)
        res["val_acc"] = tr.evaluate()
        # the stacked bundle on the mesh Trainer's params: the same hit
        # count (also at batch 30, whose 2 padded rows the last rank masks),
        # and one committed host batch's logits, gathered in core order on
        # the mesh and this rank's rows (local_rows) without the gather
        for batch_size in (TRAIN["batch_size"], 30):
            kw = {**TRAIN, "batch_size": batch_size}
            st = Trainer(SPEC, "reddit", n_cores=P, device="cpu",
                         ckpt_every=0, **kw)
            st.params = tr.params
            if batch_size != TRAIN["batch_size"]:
                mt = Trainer(SPEC, "reddit", n_cores=P, mesh=mesh,
                             ckpt_every=0, **kw)
                mt.params = tr.params
                res[("val_acc", batch_size)] = (
                    mt.evaluate(), st.evaluate(), _plain_accuracy(st))
                mt.close()
                st.close()
                continue
            res[("val_acc", batch_size)] = (res["val_acc"], st.evaluate(),
                                            _plain_accuracy(st))
            host = st.bundle.prepare_batch(*next(st.pipeline))
            want = st.bundle.forward(tr.params, st.bundle.commit_batch(host))
            batch = tr.bundle.commit_batch(host)
            got = tr.bundle.forward(tr.params, batch)
            local = tr.bundle.forward(tr.params, batch, gather=False)
            mine = torch.tensor([int(torch.equal(
                local, want[tr.bundle.local_rows(batch["n_rows"])]))])
            dist.all_reduce(mine, op=dist.ReduceOp.MIN)
            res["forward"] = (torch.equal(got, want), bool(mine),
                              tuple(got.shape), tuple(want.shape))
            st.close()
        tr.close()
        if world == 2:
            own = os.path.join(out, "resume_ckpt")
            part = Trainer(SPEC, "reddit", n_cores=P, mesh=mesh,
                           ckpt_dir=ckpt, ckpt_every=0, **TRAIN)
            assert part.resume()
            part.mgr = type(part.mgr)(own)
            part.train_steps(2)
            part.save(sync=True)
            part.close()
            again = Trainer(SPEC, "reddit", n_cores=P, mesh=mesh,
                            ckpt_dir=own, ckpt_every=0, **TRAIN)
            assert again.resume() and again.global_step == 2
            res["resumed"] = again.train_steps(1)
            again.close()
            data = _ga_data()
            dmesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
            half = GA_SHAPES["rows"] // world
            params = {k: torch.from_numpy(data[k]) for k in ("w", "b")}
            batch = {k: torch.from_numpy(data[k][rank * half:
                                                 (rank + 1) * half])
                     for k in ("x", "y")}
            with use_mesh(dmesh):
                for bucketed in (False, True):
                    loss, grads = grad_accum(
                        _ga_loss, params, batch,
                        n_micro=GA_SHAPES["n_micro"], axis_names=("data",),
                        bucketed=bucketed)
                    res[("ga", bucketed)] = (
                        float(loss), {k: v.numpy() for k, v in grads.items()})
        if rank == 0:
            with open(os.path.join(out, f"w{world}.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_REF = """
import json, os
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.compat import shard_map
from repro.distributed.overlap import grad_accum
from repro.launch.trainer import Trainer

out = {out!r}
mesh = jax.make_mesh(({P},), ("model",), axis_types=(AxisType.Auto,))
tr = Trainer({spec!r}, "reddit", mesh=mesh, ckpt_dir=os.path.join(out, "ckpt"),
             ckpt_every=0, **{train!r})
tr.save(sync=True)
losses = tr.train_steps({steps})
params = [np.asarray(p["w"]) for p in tr.params]
tr.close()
d = dict(np.load(os.path.join(out, "ga.npz")))
dmesh = jax.make_mesh((2,), ("data",), devices=jax.devices()[:2],
                      axis_types=(AxisType.Auto,))

def loss_fn(params, batch):
    err = batch["x"] @ params["w"] + params["b"] - batch["y"]
    return (err * err).mean()

ga = {{}}
for bucketed in (False, True):
    def body(params, batch, bucketed=bucketed):
        return grad_accum(loss_fn, params, batch, n_micro={n_micro},
                          axis_names=("data",), bucketed=bucketed)
    # check_vma off: the reference's scan carries start unvarying
    fn = shard_map(body, mesh=dmesh, in_specs=(P(), P("data")),
                   out_specs=(P(), P()), check_vma=False)
    loss, grads = jax.jit(fn)({{"w": d["w"], "b": d["b"]}},
                              {{"x": d["x"], "y": d["y"]}})
    ga[str(bucketed)] = [float(loss), np.asarray(grads["w"]).tolist(),
                         np.asarray(grads["b"]).tolist()]
np.savez(os.path.join(out, "ref.npz"), *params)
print("REF" + json.dumps({{"losses": [float(v) for v in losses], "ga": ga}}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess (4 devices: its Trainer from step 0 and
    ``grad_accum`` over 2), then one spawn per world size and the stacked
    Trainer, each resuming the reference's step-0 checkpoint."""
    import torch.multiprocessing as mp

    ref_out = str(tmp_path_factory.mktemp("mesh_ref"))
    np.savez(os.path.join(ref_out, "ga.npz"), **_ga_data())
    code = _REF.format(out=ref_out, P=P, spec=SPEC, train=TRAIN, steps=STEPS,
                       n_micro=GA_SHAPES["n_micro"])
    stdout = run_subprocess(code, n_devices=P)
    line = [ln for ln in stdout.splitlines() if ln.startswith("REF")]
    ref = json.loads(line[-1][3:])
    ref_params = np.load(os.path.join(ref_out, "ref.npz"))
    ref["params"] = [ref_params[f"arr_{i}"] for i in range(len(ref_params))]
    ckpt = os.path.join(ref_out, "ckpt")
    got = {}
    for world in WORLDS:
        out = str(tmp_path_factory.mktemp(f"mesh_w{world}"))
        mp.spawn(_worker, args=(world, os.path.join(out, "store"), out,
                                ckpt), nprocs=world, join=True)
        with open(os.path.join(out, f"w{world}.pkl"), "rb") as f:
            got[world] = pickle.load(f)
    from repro_torch.launch.trainer import Trainer
    tr = Trainer(SPEC, "reddit", n_cores=P, ckpt_dir=ckpt, ckpt_every=0,
                 device="cpu", **TRAIN)
    assert tr.resume()
    stacked = {"losses": tr.train_steps(STEPS), "params": _params(tr)}
    tr.close()
    return {"ref": ref, "mesh": got, "stacked": stacked}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("spec,merge", AGG_CASES)
def test_mesh_aggregate_equals_the_stacked_bits(runs, world, spec, merge):
    y_eq, dx_eq, y_err, dx_err = runs["mesh"][world][("agg", spec, merge)]
    assert y_eq and dx_eq, (y_err, dx_err)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_trainer_matches_the_stacked_trainer(runs, world):
    got, want = runs["mesh"][world], runs["stacked"]
    assert np.all(np.isfinite(got["losses"]))
    assert np.abs(np.subtract(got["losses"], want["losses"])).max() <= 1e-6
    for a, b in zip(got["params"], want["params"], strict=True):
        assert np.abs(a - b).max() <= 1e-6
    assert 0.0 <= got["val_acc"] <= 1.0
    for batch_size in (TRAIN["batch_size"], 30):
        mesh_acc, stacked_acc, plain = got[("val_acc", batch_size)]
        assert mesh_acc == stacked_acc == plain, batch_size


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_forward_gathers_the_stacked_logits(runs, world):
    gathered, local, got_shape, want_shape = runs["mesh"][world]["forward"]
    assert gathered, (got_shape, want_shape)
    assert local


def test_mesh_trainer_matches_the_reference_mesh_trainer(runs):
    got, ref = runs["mesh"][4], runs["ref"]
    assert np.abs(np.subtract(got["losses"], ref["losses"])).max() <= 1e-5
    for a, b in zip(got["params"], ref["params"], strict=True):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)


def test_mesh_checkpoint_resume_replays_the_step(runs):
    got = runs["mesh"][2]
    assert abs(got["resumed"][0] - got["losses"][2]) <= 1e-6


@pytest.mark.parametrize("bucketed", [False, True])
def test_grad_accum_over_ranks_matches_the_reference(runs, bucketed):
    loss, grads = runs["mesh"][2][("ga", bucketed)]
    want_loss, want_w, want_b = runs["ref"]["ga"][str(bucketed)]
    assert abs(loss - want_loss) <= 1e-6
    assert np.abs(grads["w"] - np.asarray(want_w)).max() <= 1e-6
    assert np.abs(grads["b"] - np.asarray(want_b)).max() <= 1e-6


def test_a_topology_without_rank_rounds_refuses_the_mesh(runs):
    assert all(runs["mesh"][w]["stacked_only_refused"] for w in WORLDS)
