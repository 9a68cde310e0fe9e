"""Port vs reference: the training slice on ``ell+pipelined``,
``coo+serial`` and ``block+pipelined`` at small sizes (reddit ``scale=0.004``, ``feat_dim`` 16,
hidden 16, batch 32).

* sampler batches and ``GraphBatchPipeline`` state are array-equal;
* ``shard_edges_ell``'s stacked tables (forward and ``t_*``) and
  ``shard_edges``' lists are array-equal at P = 2 and 4;
* ``ell_aggregate`` forward and gradient within 1e-5 of
  ``repro.kernels.ops.ell_aggregate``;
* the distributed aggregates on P stacked cores: forward within 1e-5 and
  gradient within 2e-3 rtol/atol of the reference's ``EngineBundle
  .aggregate`` on P forced CPU devices (the reference's gradient tolerance);
* Trainer 5-step loss trajectories within 1e-5 of the reference Trainer at
  P ∈ {1, 2, 4}, every spec, all starting from one reference checkpoint
  saved at step 0, which the port's Trainer resumes.

The reference runs on P devices in one ``conftest.run_subprocess`` per P
(the three run at once), with its mesh built ``AxisType.Auto`` — the mesh
context the reference's gradients need under this jax (ROADMAP Queue 3).
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import run_subprocess  # noqa: E402
from repro.data import GraphBatchPipeline as RefPipeline  # noqa: E402
from repro.distributed import aggregate as ref_agg  # noqa: E402
from repro.graph import NeighborSampler as RefSampler  # noqa: E402
from repro.graph import from_edges as ref_from_edges  # noqa: E402
from repro.graph import make_dataset as ref_make_dataset  # noqa: E402
from repro.kernels import edgeplan as ref_edgeplan  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.data import GraphBatchPipeline  # noqa: E402
from repro_torch.distributed import aggregate as agg  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.graph import NeighborSampler, from_edges  # noqa: E402
from repro_torch.graph import make_dataset  # noqa: E402
from repro_torch.kernels import edgeplan, ell_aggregate  # noqa: E402
from repro_torch.launch.trainer import Trainer  # noqa: E402

SPECS = ["ell+pipelined", "coo+serial", "block+pipelined"]
CORES = [1, 2, 4]
TRAIN = dict(scale=0.004, feat_dim=16, hidden=16, batch_size=32, lr=0.05,
             seed=0, input_pipeline="sync")
STEPS = 5


def _agg_graph(seed=7, n_dst=48, n_src=64, nnz=420):
    """A rectangular COO with duplicate edges, a hub row, empty rows and
    zero-weight padding, plus an input ``x`` and a cotangent ``g``."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n_dst - 6, nnz),
                           np.full(40, 5), np.zeros(8, np.int64)])
    cols = np.concatenate([rng.integers(0, n_src - 4, nnz),
                           rng.integers(0, n_src, 40), np.zeros(8, np.int64)])
    vals = np.concatenate([rng.uniform(0.05, 1.0, nnz + 40),
                           np.zeros(8)]).astype(np.float32)
    x = rng.standard_normal((n_src, 8)).astype(np.float32)
    g = rng.standard_normal((n_dst, 8)).astype(np.float32)
    return (rows, cols, vals, n_dst, n_src), x, g


_REF = """
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.engine import Engine
from repro.graph import from_edges
from repro.launch.trainer import Trainer

P, out = {P}, {out!r}
mesh = jax.make_mesh((P,), ("model",), axis_types=(AxisType.Auto,))
d = np.load(os.path.join(out, "graph.npz"))
coo = from_edges(d["rows"], d["cols"], d["vals"], int(d["n_dst"]),
                 int(d["n_src"]))
x, g = jnp.asarray(d["x"]), jnp.asarray(d["g"])
res = {{}}
for spec in {specs!r}:
    agg = Engine(spec).build(mesh).aggregator(coo)
    y = agg(x)
    dx = jax.grad(lambda v: jnp.sum(agg(v) * g))(x)
    res[spec.split("+")[0] + "_y"] = np.asarray(y)
    res[spec.split("+")[0] + "_dx"] = np.asarray(dx)
np.savez(os.path.join(out, "agg.npz"), **res)
ckpt = os.path.join(out, "ckpt")
losses = {{}}
for spec in {specs!r}:
    tr = Trainer(spec, "reddit", mesh=mesh, ckpt_dir=ckpt, ckpt_every=0,
                 **{train!r})
    if spec == {specs!r}[0]:
        tr.save(sync=True)
    else:
        assert tr.resume()
    losses[spec] = tr.train_steps({steps})
    tr.close()
print("LOSSES" + json.dumps(losses))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per P: the reference's aggregate outputs and gradients, its 5-step
    losses for every spec, and the step-0 checkpoint they started from."""
    args, x, g = _agg_graph()
    rows, cols, vals, n_dst, n_src = args
    results, errors = {}, []

    def run(P):
        out = str(tmp_path_factory.mktemp(f"ref_p{P}"))
        np.savez(os.path.join(out, "graph.npz"), rows=rows, cols=cols,
                 vals=vals, n_dst=n_dst, n_src=n_src, x=x, g=g)
        code = _REF.format(P=P, out=out, specs=SPECS, train=TRAIN,
                           steps=STEPS)
        try:
            stdout = run_subprocess(code, n_devices=P)
        except AssertionError as e:          # re-raised on the test thread
            errors.append(e)
            return
        line = [ln for ln in stdout.splitlines() if ln.startswith("LOSSES")]
        results[P] = {"losses": json.loads(line[-1][len("LOSSES"):]),
                      "agg": dict(np.load(os.path.join(out, "agg.npz"))),
                      "ckpt": os.path.join(out, "ckpt")}

    threads = [threading.Thread(target=run, args=(P,)) for P in CORES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    assert sorted(results) == CORES, "a reference subprocess did not finish"
    return results


# ---------------------------------------------------------------------------
# host-side pieces: array-equal
# ---------------------------------------------------------------------------
def test_sampler_batches_array_equal():
    rds = ref_make_dataset("reddit", scale=0.004, feat_dim=16)
    pds = make_dataset("reddit", scale=0.004, feat_dim=16)
    rs = RefSampler(rds.graph, (10, 25), pad_multiple=16, seed=3)
    ps = NeighborSampler(pds.graph, (10, 25), pad_multiple=16, seed=3)
    assert ps.static_nnz(32) == rs.static_nnz(32)
    seeds = np.arange(5, 37)
    for rng_seed in (None, 11):        # the sampler's own stream, and a
        kw = {} if rng_seed is None else dict(  # per-batch generator
            rng=np.random.default_rng(rng_seed))
        kw2 = {} if rng_seed is None else dict(
            rng=np.random.default_rng(rng_seed))
        r = rs.sample(seeds, nnz_pad=rs.static_nnz(32), **kw)
        p = ps.sample(seeds, nnz_pad=ps.static_nnz(32), **kw2)
        assert p.n_real == r.n_real
        np.testing.assert_array_equal(p.input_nodes, r.input_nodes)
        np.testing.assert_array_equal(p.seed_nodes, r.seed_nodes)
        for pl, rl in zip(p.layers, r.layers, strict=True):
            assert (pl.n_dst, pl.n_src) == (rl.n_dst, rl.n_src)
            for a in ("rows", "cols", "vals"):
                np.testing.assert_array_equal(getattr(pl, a).numpy(),
                                              np.asarray(getattr(rl, a)))


def test_pipeline_stream_and_state_array_equal():
    rds = ref_make_dataset("reddit", scale=0.004, feat_dim=16)
    pds = make_dataset("reddit", scale=0.004, feat_dim=16)
    rp = RefPipeline(rds, RefSampler(rds.graph, (10, 25)), 128, seed=5)
    pp = GraphBatchPipeline(pds, NeighborSampler(pds.graph, (10, 25)), 128,
                            seed=5)
    assert pp.batches_per_epoch == rp.batches_per_epoch
    for _ in range(pp.batches_per_epoch + 2):      # across an epoch edge
        (rmb, rf, rl), (pmb, pf, pl) = next(rp), next(pp)
        np.testing.assert_array_equal(pmb.input_nodes, rmb.input_nodes)
        np.testing.assert_array_equal(pf, rf)
        np.testing.assert_array_equal(pl, rl)
        assert pp.state() == rp.state()
    state = pp.state()
    want = next(pp)
    pp.restore(state)
    again = next(pp)
    np.testing.assert_array_equal(again[1], want[1])


@pytest.mark.parametrize("P", [2, 4])
def test_shards_array_equal(P):
    args, _, _ = _agg_graph()
    ref_coo, coo = ref_from_edges(*args), from_edges(*args)
    re_, pe = (ref_agg.shard_edges_ell(ref_coo, P),
               agg.shard_edges_ell(coo, P))
    assert sorted(pe.tables) == sorted(re_.tables)
    for key, want in re_.tables.items():
        got = pe.tables[key]
        if isinstance(want, tuple):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got, want)
    rs, ps = ref_agg.shard_edges(ref_coo, P), agg.shard_edges(coo, P)
    for a in ("rows_global", "cols_local", "vals"):
        np.testing.assert_array_equal(getattr(ps, a), getattr(rs, a))


def test_ell_aggregate_forward_and_grad_match_reference():
    args, x, g = _agg_graph(seed=3)
    ref_plan = ref_edgeplan.build_plan(ref_from_edges(*args))
    plan = edgeplan.build_plan(from_edges(*args))
    rt = ref_plan.device_tables()

    def ref_loss(v):
        return jnp.sum(ref_ops.ell_aggregate(rt, v) * g)

    import jax
    want_y = np.asarray(ref_ops.ell_aggregate(rt, jnp.asarray(x)))
    want_dx = np.asarray(jax.grad(ref_loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ell_aggregate(plan.device_tables("cpu"), xt)
    (y * torch.from_numpy(g)).sum().backward()
    assert np.abs(y.detach().numpy() - want_y).max() <= 1e-5
    assert np.abs(xt.grad.numpy() - want_dx).max() <= 1e-5


# ---------------------------------------------------------------------------
# distributed aggregates and training: against the reference on P devices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", CORES)
@pytest.mark.parametrize("spec", SPECS)
def test_distributed_aggregate_matches_reference(reference, spec, P):
    args, x, g = _agg_graph()
    key = spec.split("+")[0]
    want_y = reference[P]["agg"][key + "_y"]
    want_dx = reference[P]["agg"][key + "_dx"]
    bundle = Engine(spec).build(n_cores=P, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bundle.aggregate(xt, graph=from_edges(*args))
    (y * torch.from_numpy(g)).sum().backward()
    assert y.shape == want_y.shape
    assert np.abs(y.detach().numpy() - want_y).max() <= 1e-5
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("P", CORES)
@pytest.mark.parametrize("spec", SPECS)
def test_trainer_losses_match_reference(reference, spec, P):
    want = reference[P]["losses"][spec]
    tr = Trainer(spec, "reddit", n_cores=P, ckpt_dir=reference[P]["ckpt"],
                 ckpt_every=0, device="cpu", **TRAIN)
    assert tr.resume() and tr.global_step == 0
    got = tr.train_steps(STEPS)
    tr.close()
    assert np.all(np.isfinite(got))
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= 1e-5, \
        (got, want)
