"""Port vs reference: the UMA/SMP baseline of Fig. 1 and microbatched
gradient accumulation.

* ``shard_edges_by_dst``'s receiver-side shards are array-equal at
  P = 2 and 4;
* ``uma_aggregate`` on P stacked cores: forward within 2e-4 and gradient
  within 2e-3 of the reference on P forced CPU devices (its own bounds,
  ``tests/test_distributed.py``), in one ``conftest.run_subprocess`` per
  P (the two run at once) with the mesh built ``AxisType.Auto`` (ROADMAP
  Queue 3); and the port's UMA equals its hypercube aggregate;
* ``grad_accum`` equals the full-batch loss and gradient
  (``test_distributed.py::test_grad_accum_matches_full_batch``).
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402
from repro.distributed import aggregate as ref_agg  # noqa: E402
from repro.graph import from_edges as ref_from_edges  # noqa: E402
from repro_torch.distributed import aggregate as agg  # noqa: E402
from repro_torch.distributed.overlap import grad_accum  # noqa: E402
from repro_torch.graph import from_edges  # noqa: E402

FWD_TOL, GRAD_TOL = 2e-4, 2e-3       # the reference's UMA bounds
CORES = [2, 4]


def _graph(seed=11, n_dst=48, n_src=64, nnz=400):
    """A rectangular COO with a hub row, a hub column, empty rows and
    zero-weight padding, plus ``x`` and a cotangent ``g``."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n_dst - 6, nnz), np.full(30, 3),
                           rng.integers(0, n_dst - 6, 20), np.zeros(6, int)])
    cols = np.concatenate([rng.integers(0, n_src, nnz),
                           rng.integers(0, n_src, 30), np.full(20, 9),
                           np.zeros(6, int)])
    vals = np.concatenate([rng.uniform(0.05, 1.0, nnz + 50),
                           np.zeros(6)]).astype(np.float32)
    x = rng.standard_normal((n_src, 8)).astype(np.float32)
    g = rng.standard_normal((n_dst, 8)).astype(np.float32)
    return (rows, cols, vals, n_dst, n_src), x, g


_REF = """
import os
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.compat import shard_map
from repro.distributed.aggregate import shard_edges_by_dst, uma_aggregate
from repro.graph import from_edges

n_cores, out = {P}, {out!r}
ndim = n_cores.bit_length() - 1
mesh = jax.make_mesh((n_cores,), ("model",), axis_types=(AxisType.Auto,))
d = np.load(os.path.join(out, "graph.npz"))
n_dst = int(d["n_dst"])
coo = from_edges(d["rows"], d["cols"], d["vals"], n_dst, int(d["n_src"]))
esd = shard_edges_by_dst(coo, n_cores)
fn = shard_map(
    lambda r, c, v, xl: uma_aggregate("model", ndim, n_dst, r[0], c[0],
                                      v[0], xl),
    mesh=mesh, in_specs=(P("model"),) * 4, out_specs=P("model"))
edges = [jnp.asarray(a) for a in (esd.rows_global, esd.cols_local,
                                  esd.vals)]
x, g = jnp.asarray(d["x"]), jnp.asarray(d["g"])
y = fn(*edges, x)
dx = jax.grad(lambda v: jnp.sum(fn(*edges, v) * g))(x)
np.savez(os.path.join(out, "uma.npz"), y=np.asarray(y), dx=np.asarray(dx))
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per P: the reference's UMA output and input gradient."""
    args, x, g = _graph()
    rows, cols, vals, n_dst, n_src = args
    results, errors = {}, []
    # made on this thread: two threads creating the base temp dir race
    outs = {P: str(tmp_path_factory.mktemp(f"uma_p{P}")) for P in CORES}

    def run(P):
        out = outs[P]
        np.savez(os.path.join(out, "graph.npz"), rows=rows, cols=cols,
                 vals=vals, n_dst=n_dst, n_src=n_src, x=x, g=g)
        try:
            run_subprocess(_REF.format(P=P, out=out), n_devices=P)
            results[P] = dict(np.load(os.path.join(out, "uma.npz")))
        except Exception as exc:          # reported by the test below
            errors.append(f"P={P}: {exc}")

    threads = [threading.Thread(target=run, args=(P,)) for P in CORES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert sorted(results) == CORES, "a reference subprocess did not finish"
    return results


def _port_uma(P, x, g):
    args, _, _ = _graph()
    es = agg.shard_edges_by_dst(from_edges(*args), P)
    leaves = {k: torch.from_numpy(v) for k, v in agg.uma_leaves(es).items()}
    xt = torch.from_numpy(x).reshape(P, -1, x.shape[1]).requires_grad_(True)
    y = agg.uma_aggregate(es.n_dst, leaves["rows"], leaves["cols"],
                          leaves["vals"], xt, groups=leaves)
    y = y.reshape(es.n_dst, -1)
    (dx,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    return y.detach(), dx.reshape(x.shape)


@pytest.mark.parametrize("P", CORES)
def test_shard_edges_by_dst_equals_the_reference(P):
    args, _, _ = _graph()
    got = agg.shard_edges_by_dst(from_edges(*args), P)
    want = ref_agg.shard_edges_by_dst(ref_from_edges(*args), P)
    for a in ("rows_global", "cols_local", "vals"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    assert (got.n_dst, got.n_src, got.n_cores) \
        == (want.n_dst, want.n_src, want.n_cores)


@pytest.mark.parametrize("P", CORES)
def test_uma_aggregate_matches_the_reference(reference, P):
    _, x, g = _graph()
    y, dx = _port_uma(P, x, g)
    np.testing.assert_allclose(y.numpy(), reference[P]["y"], rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(dx.numpy(), reference[P]["dx"],
                               rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("P", CORES)
def test_uma_equals_the_hypercube_aggregate(P):
    """The same ``A @ x`` and ``Aᵀ g`` through the NUMA schedule (sender
    shards, pre-reduce, fold) and through UMA (receiver shards, raw
    gather), and through the dense product."""
    args, x, g = _graph()
    coo = from_edges(*args)
    y_uma, dx_uma = _port_uma(P, x, g)
    es = agg.shard_edges(coo, P)
    leaves = {k: torch.from_numpy(v) for k, v in agg.shard_leaves(es).items()}
    xt = torch.from_numpy(x).reshape(P, -1, x.shape[1]).requires_grad_(True)
    y = agg.hypercube_aggregate(es.n_dst, leaves["rows"], leaves["cols"],
                                leaves["vals"], xt, groups=leaves)
    y = y.reshape(es.n_dst, -1)
    (dx,) = torch.autograd.grad((y * torch.from_numpy(g)).sum(), xt)
    dense = coo.todense().double()
    # the wrappers group the walks themselves when no grouping is given
    es_dst = agg.shard_edges_by_dst(coo, P)
    ungrouped = agg.uma_aggregate(
        es_dst.n_dst, *(torch.from_numpy(a) for a in (
            es_dst.rows_global, es_dst.cols_local, es_dst.vals)),
        torch.from_numpy(x).reshape(P, -1, x.shape[1]))
    assert torch.equal(ungrouped.reshape(es_dst.n_dst, -1), y_uma)
    np.testing.assert_allclose(y_uma.numpy(), y.detach().numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(dx_uma.numpy(), dx.reshape(x.shape).numpy(),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(
        y_uma.numpy(), (dense @ torch.from_numpy(x).double()).numpy(),
        rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_grad_accum_matches_full_batch(remat):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    ys = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))

    def loss(w, batch):
        x, y = batch
        return torch.mean((x @ w - y) ** 2)

    wf = w.clone().requires_grad_(True)
    full_loss = loss(wf, (xs, ys))
    (full_grad,) = torch.autograd.grad(full_loss, wf)
    for n_micro in (2, 4, 8):
        l, g = grad_accum(loss, w, (xs, ys), n_micro=n_micro, remat=remat)
        np.testing.assert_allclose(float(l), float(full_loss.detach()),
                                   rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), full_grad.numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert not w.requires_grad


def test_grad_accum_over_device_axes_names_the_missing_backend():
    w = torch.zeros((2, 2))
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        grad_accum(lambda p, b: (p * b).sum(), w, torch.ones((4, 2)),
                   n_micro=2, axis_names=("data",))
