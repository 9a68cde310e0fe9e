"""The one-launch ELL walk: its descriptor, its work list and its CPU path.

* The work list of a real serving plan, of a real stacked training batch
  (P = 4, forward and transpose) and of a synthetic hub plan (K = 4096),
  decoded warp by warp as the kernel decodes its grid
  (:meth:`EllWalk.unit`), covers every (core, row, feature) of every
  non-empty bucket exactly once.
* The list runs longest K first, names no empty bucket, and the packed
  descriptor holds the records and items the kernel reads.
* ``ell_apply``'s CPU path (the walk) equals the per-bucket loop it
  replaced (``torch.equal``) and the reference's ELL walk
  (``repro.kernels.ops.ell_apply``, ≤ 1e-5 as
  ``test_torch_ell.test_ell_apply_matches_reference`` holds it), forward
  and transpose, on one core and on stacked cores with their own ``x`` or
  one ``x`` shared through a zero core stride.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import aggregate as ref_agg  # noqa: E402
from repro.graph import from_edges as ref_from_edges  # noqa: E402
from repro.kernels import edgeplan as ref_edgeplan  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.data import GraphBatchPipeline  # noqa: E402
from repro_torch.distributed import aggregate as agg  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.engine.registry import get_format  # noqa: E402
from repro_torch.graph import (NeighborSampler, from_edges,  # noqa: E402
                               make_dataset)
from repro_torch.kernels import edgeplan, ell_apply, spmm_ell  # noqa: E402
from repro_torch.kernels.spmm import (BUCKET_DTYPE, ITEM_ENTRIES,  # noqa: E402
                                      ell_walk, rows_per_item,
                                      walk_descriptor, walk_items)
from repro_torch.serving import InferenceEngine  # noqa: E402

TOL = 1e-5


def _serving_plan():
    """The layer-1 plan of an 8-node query, as the serving path builds it."""
    rng = np.random.default_rng(0)
    ds = make_dataset("flickr", scale=0.004, feat_dim=8)
    params = [{"w": (rng.standard_normal((8, 8)) * 0.2).astype(np.float32)},
              {"w": (rng.standard_normal((8, 5)) * 0.2).astype(np.float32)}]
    eng = InferenceEngine("ell+pipelined", ds.graph, ds.features,
                          params=params, device="cpu")
    q = np.unique(rng.integers(0, ds.graph.n_nodes, 8))
    coo2, f2 = eng.canonical_layer(q)
    coo1, _ = eng.canonical_layer(f2)
    return eng.engine.layout(coo1)


def _training_tables(P=4):
    """The deepest hop's stacked tables of a real training batch, placed
    on the CPU as the trainer places them (walks built from the host work
    lists)."""
    ds = make_dataset("reddit", scale=0.004, feat_dim=8)
    sampler = NeighborSampler(ds.graph, (10, 25), pad_multiple=P, seed=0)
    bundle = Engine("ell+pipelined").build(n_cores=P, device="cpu")
    batch = bundle.commit_batch(bundle.prepare_batch(
        *next(GraphBatchPipeline(ds, sampler, 64))))
    return batch["edges"][-1]


def _hub_plan():
    """A plan whose hub row holds 4096 distinct sources (a K = 4096
    bucket) beside short rows."""
    rng = np.random.default_rng(1)
    n_dst, n_src = 40, 5000
    rows = np.concatenate([np.zeros(4096, np.int64),
                           rng.integers(1, n_dst - 3, 400)])
    cols = np.concatenate([np.arange(4096), rng.integers(0, n_src, 400)])
    vals = rng.uniform(0.05, 1.0, len(rows)).astype(np.float32)
    return edgeplan.build_plan(from_edges(rows, cols, vals, n_dst, n_src))


@pytest.fixture(scope="module")
def walks():
    """(name, walk) for every walk the coverage tests decode."""
    serving = _serving_plan().device_tables("cpu")
    train = _training_tables()
    hub = _hub_plan().device_tables("cpu")
    assert max(c.shape[-1] for c in hub["cols"]) == 4096
    return {"serving": serving["walk"], "serving_t": serving["t_walk"],
            "train": train["walk"], "train_t": train["t_walk"],
            "hub": hub["walk"], "hub_t": hub["t_walk"]}


@pytest.mark.parametrize("d", [5, 41, 256, 300])
@pytest.mark.parametrize("name", ["serving", "serving_t", "train", "train_t",
                                  "hub", "hub_t"])
def test_work_list_covers_every_row_and_feature_once(walks, name, d):
    walk = walks[name]
    P = walk.lead[0] if walk.lead else 1
    base = np.cumsum([0] + [int(c.shape[-2]) for c in walk.cols])
    cover = np.zeros((P, walk.total, d), np.int32)
    for u in range(walk.n_units(d)):
        bucket, row0, row1, core, f0, f1 = walk.unit(u, d)
        assert row0 < row1 and f0 < f1
        cover[core, base[bucket] + row0:base[bucket] + row1, f0:f1] += 1
    assert walk.total > 0 and (cover == 1).all()


@pytest.mark.parametrize("name", ["serving", "train_t", "hub"])
def test_work_list_runs_longest_rows_first_and_skips_empty_buckets(walks,
                                                                  name):
    walk = walks[name]
    shapes = [tuple(int(s) for s in c.shape[-2:]) for c in walk.cols]
    ks = [shapes[b][1] for b in walk.items[:, 0]]
    assert ks == sorted(ks, reverse=True)
    assert all(shapes[b][0] > 0 for b in walk.items[:, 0])
    for b, (nb, K) in enumerate(shapes):
        rows = walk.items[walk.items[:, 0] == b, 1]
        np.testing.assert_array_equal(rows,
                                      np.arange(0, nb, rows_per_item(K)))
    # a hub row is an item of its own; K = 1 rows go ITEM_ENTRIES at a time
    assert rows_per_item(4096) == 1 and rows_per_item(1) == ITEM_ENTRIES
    np.testing.assert_array_equal(walk_items(shapes), walk.items)


def test_work_list_of_empty_walks():
    assert walk_items([]).shape == (0, 2)
    assert walk_items([(0, 4), (0, 1)]).shape == (0, 2)
    walk = ell_walk((torch.zeros((0, 4), dtype=torch.int32),),
                    (torch.zeros((0, 4)),))
    assert walk.total == 0 and walk.n_units(64) == 0


def test_descriptor_packs_what_the_kernel_reads(walks):
    walk = walks["train"]
    packed = walk_descriptor(walk.cols, walk.vals, walk.items)
    n = len(walk.cols)
    assert BUCKET_DTYPE.itemsize == 40 and packed.dtype == np.uint8
    rec = packed[:n * 40].view(BUCKET_DTYPE)
    items = packed[n * 40:].view(np.int32).reshape(-1, 2)
    np.testing.assert_array_equal(items, walk.items)
    base = 0
    for r, c, v in zip(rec, walk.cols, walk.vals):
        nb, K = c.shape[-2:]
        assert (r["cols"], r["vals"]) == (c.data_ptr(), v.data_ptr())
        assert (r["nb"], r["K"], r["tab_core"]) == (nb, K, nb * K)
        assert (r["out_base"], r["rows"]) == (base, rows_per_item(K))
        base += nb


def _per_bucket_loop(tables, x, transpose):
    """The walk as ell_apply ran it before: one call per non-empty bucket
    into slices of one buffer whose last row is zero, then placement."""
    pre = "t_" if transpose else ""
    cols, vals, inv = (tables[pre + k] for k in ("cols", "vals", "inv"))
    d = x.shape[-1]
    lead = tuple(inv.shape[:-1])
    total = sum(int(c.shape[-2]) for c in cols)
    buf = torch.empty((*lead, total + 1, d))
    buf[..., total, :].zero_()
    base = 0
    for c, v in zip(cols, vals):
        nb = int(c.shape[-2])
        if nb:
            spmm_ell(c, v, x, out=buf[..., base:base + nb, :])
        base += nb
    if not lead:
        return buf.index_select(0, inv)
    P = lead[0]
    offs = torch.arange(P).view(P, 1) * (total + 1)
    flat = buf.view(P * (total + 1), d).index_select(0, (inv + offs).view(-1))
    return flat.view(P, -1, d)


def _graph(seed=2, n_dst=64, n_src=48, nnz=700):
    """A COO with duplicates, a hub row (K = 64 after the merge), empty rows
    and columns and zero-weight padding."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n_dst - 5, nnz), np.full(60, 9),
                           np.zeros(6, np.int64)])
    cols = np.concatenate([rng.integers(0, n_src - 3, nnz),
                           rng.permutation(n_src)[:40],
                           rng.integers(0, n_src, 20), np.zeros(6, np.int64)])
    vals = np.concatenate([rng.uniform(0.05, 1.0, nnz + 60),
                           np.zeros(6)]).astype(np.float32)
    return (rows, cols, vals, n_dst, n_src), rng


@pytest.mark.parametrize("transpose", [False, True])
def test_walk_on_one_core_equals_the_old_loop_and_the_reference(transpose):
    args, rng = _graph()
    ref = ref_edgeplan.build_plan(ref_from_edges(*args))
    port = edgeplan.build_plan(from_edges(*args))
    n_dst, n_src = args[3:]
    x = rng.standard_normal((n_dst if transpose else n_src, 24)).astype(
        np.float32)
    tables = port.device_tables("cpu")
    got = ell_apply(tables, torch.from_numpy(x), transpose=transpose)
    assert torch.equal(got, _per_bucket_loop(tables, torch.from_numpy(x),
                                             transpose))
    want = np.asarray(ref_ops.ell_apply(ref.device_tables(), jnp.asarray(x),
                                        transpose=transpose))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("shared_x", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_walk_on_stacked_cores_equals_the_old_loop_and_the_reference(
        transpose, shared_x):
    P = 4
    args, rng = _graph(seed=5)
    n_dst, n_src = args[3:]
    ref_tabs = ref_agg.shard_edges_ell(ref_from_edges(*args), P).tables
    fmt = get_format("ell")
    leaves, _, _ = fmt.shard(from_edges(*args), P, Engine("ell").config)
    tables = fmt.to_device(leaves, "cpu")
    assert tables["walk"].lead == (P,) and tables["t_walk"].lead == (P,)
    n_in = n_dst if transpose else n_src // P     # error rows / own slots
    d = 11
    if shared_x:                 # one x for every core: a zero core stride
        x = torch.from_numpy(rng.standard_normal((n_in, d)).astype(
            np.float32)).unsqueeze(0).expand(P, n_in, d)
    else:
        x = torch.from_numpy(rng.standard_normal((P, n_in, d)).astype(
            np.float32))
    got = ell_apply(tables, x, transpose=transpose)
    assert torch.equal(got, _per_bucket_loop(tables, x, transpose))
    for p in range(P):
        tp = {k: (tuple(jnp.asarray(c[p]) for c in v) if isinstance(v, tuple)
                  else jnp.asarray(v[p])) for k, v in ref_tabs.items()}
        want = np.asarray(ref_ops.ell_apply(tp, jnp.asarray(x[p].numpy()),
                                            transpose=transpose))
        assert got[p].shape == want.shape
        assert np.abs(got[p].numpy() - want).max() <= TOL


def test_tables_without_a_descriptor_get_one_on_their_first_walk():
    args, rng = _graph(seed=3)
    tables = dict(edgeplan.build_plan(from_edges(*args)).device_tables("cpu"))
    want = ell_apply(tables, torch.ones((args[4], 3)))
    bare = {k: v for k, v in tables.items() if not k.endswith("walk")}
    assert torch.equal(ell_apply(bare, torch.ones((args[4], 3))), want)
    assert bare["walk"].cols is bare["cols"]
    bare["cols"] = tuple(c.clone() for c in bare["cols"])   # new buckets
    assert torch.equal(ell_apply(bare, torch.ones((args[4], 3))), want)
    assert bare["walk"].cols is bare["cols"]
