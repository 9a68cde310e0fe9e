"""Port vs reference: pre-reduced ELL plans are array-equal.

Random COOs with duplicate (row, col) pairs, zero-weight padding edges and
empty rows go through both ``build_plan``s under every bucket scheme; the
forward and transpose tables (caps, cols, vals, inv_perm) must match array
for array, and the plan cache must key on the COO's identity.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import from_edges as ref_from_edges  # noqa: E402
from repro.kernels import edgeplan as ref_edgeplan  # noqa: E402
from repro_torch.graph import from_edges  # noqa: E402
from repro_torch.kernels import edgeplan  # noqa: E402


def _random_coo(seed, n_dst=40, n_src=30, nnz=200):
    rng = np.random.default_rng(seed)
    # rows drawn from the first 3/4 only: the last quarter stays empty
    rows = rng.integers(0, 3 * n_dst // 4, nnz)
    cols = rng.integers(0, n_src, nnz)
    # duplicates: repeat a slice of the edges with fresh weights
    rows = np.concatenate([rows, rows[:40]])
    cols = np.concatenate([cols, cols[:40]])
    vals = rng.uniform(0.1, 1.0, len(rows)).astype(np.float32)
    # a hub row, and zero-weight padding edges pointing at real row 0 / col 0
    rows = np.concatenate([rows, np.full(50, 1), np.zeros(16, np.int64)])
    cols = np.concatenate([cols, rng.integers(0, n_src, 50),
                           np.zeros(16, np.int64)])
    vals = np.concatenate([vals, rng.uniform(0.1, 1.0, 50),
                           np.zeros(16)]).astype(np.float32)
    return rows, cols, vals, n_dst, n_src


def _assert_tables_equal(port, ref):
    assert port.caps == ref.caps
    assert (port.n_rows, port.n_cols) == (ref.n_rows, ref.n_cols)
    assert len(port.cols) == len(ref.cols)
    for pc, rc, pv, rv in zip(port.cols, ref.cols, port.vals, ref.vals):
        assert pc.dtype == rc.dtype and pv.dtype == rv.dtype
        np.testing.assert_array_equal(pc, rc)
        np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(port.inv_perm, ref.inv_perm)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("caps", ["pow2", "single", [2, 8, 32]])
def test_build_plan_array_equal(seed, caps):
    args = _random_coo(seed)
    ref = ref_edgeplan.build_plan(ref_from_edges(*args), caps=caps)
    port = edgeplan.build_plan(from_edges(*args), caps=caps)
    assert (port.n_dst, port.n_src, port.nnz) == (ref.n_dst, ref.n_src,
                                                  ref.nnz)
    _assert_tables_equal(port.fwd, ref.fwd)
    _assert_tables_equal(port.bwd, ref.bwd)
    assert port.compression == ref.compression
    assert port.padding_overhead == ref.padding_overhead


def test_default_caps_are_pow2_and_merged_degrees_equal():
    rows, cols, vals, n_dst, n_src = _random_coo(5)
    port = edgeplan.build_plan(from_edges(rows, cols, vals, n_dst, n_src))
    deg = edgeplan.merged_degrees(rows, cols, vals, n_dst, n_src)
    np.testing.assert_array_equal(
        deg, ref_edgeplan.merged_degrees(rows, cols, vals, n_dst, n_src))
    assert port.fwd.caps == edgeplan.resolve_caps("pow2", int(deg.max()))


def test_plan_cache_keys_on_coo_identity():
    coo = from_edges(*_random_coo(2))
    before = edgeplan.cache_stats()
    p1 = edgeplan.build_plan(coo)
    p2 = edgeplan.build_plan(coo)
    assert p1 is p2
    after = edgeplan.cache_stats()
    assert after["hits"] - before["hits"] == 1
    # an equal-valued but distinct COO is a different key
    other = from_edges(coo.rows.numpy(), coo.cols.numpy(), coo.vals.numpy(),
                       coo.n_dst, coo.n_src)
    assert edgeplan.build_plan(other) is not p1


def test_device_tables_convert_once_per_device():
    plan = edgeplan.build_plan(from_edges(*_random_coo(3)))
    t1 = plan.device_tables("cpu")
    t2 = plan.device_tables(torch.device("cpu"))
    assert t1 is t2
    for c, ref in zip(t1["cols"], plan.fwd.cols):
        assert c.dtype == torch.int32
        np.testing.assert_array_equal(c.numpy(), ref)
    np.testing.assert_array_equal(t1["t_inv"].numpy(), plan.bwd.inv_perm)


def test_redundancy_merge_names_its_slice():
    # the redundancy tier is ported: on this graph (no pair shared by two
    # rows in proportion) it mines nothing and the plan is the dedup plan,
    # with no vv tables; an unknown level still raises
    coo = from_edges(*_random_coo(0))
    plan = edgeplan.build_plan(coo, merge="redundancy")
    dedup = edgeplan.build_plan(coo)
    assert plan.n_virtual == 0 and plan.vv is None and plan.vv_t is None
    assert plan.merge_stats == {} and plan.flop_reduction == 1.0
    for mine, base in ((plan.fwd, dedup.fwd), (plan.bwd, dedup.bwd)):
        for a, b in zip(mine.cols + mine.vals, base.cols + base.vals):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown merge"):
        edgeplan.build_plan(coo, merge="bogus")
