"""Port vs reference: synthetic datasets, CSR and COO normalization.

The port's host-side numpy code must be array-for-array the reference's:
the same seed gives a byte-identical graph, feature matrix and label vector,
and the COO builders give identical index and weight arrays.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import graph as ref_graph  # noqa: E402
from repro_torch import graph as port_graph  # noqa: E402


@pytest.mark.parametrize("name,seed", [("flickr", 0), ("reddit", 3)])
def test_make_dataset_array_equal(name, seed):
    ref = ref_graph.make_dataset(name, scale=0.004, seed=seed, feat_dim=16)
    port = port_graph.make_dataset(name, scale=0.004, seed=seed, feat_dim=16)
    assert port.graph.n_nodes == ref.graph.n_nodes
    np.testing.assert_array_equal(port.graph.indptr, ref.graph.indptr)
    np.testing.assert_array_equal(port.graph.indices, ref.graph.indices)
    assert port.features.dtype == ref.features.dtype == np.float32
    np.testing.assert_array_equal(port.features, ref.features)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.stats == port_graph.DATASET_STATS[name]
    assert port.stats.feat_dim == ref.stats.feat_dim
    assert port.stats.n_classes == ref.stats.n_classes


def test_make_dataset_feature_stores_not_ported():
    """Ported since: ``features="mmap"`` writes the reference's rows, bit
    for bit, and leaves the labels where the dense path does."""
    ref = ref_graph.make_dataset("flickr", scale=0.004, features="mmap",
                                 feat_dim=16, chunk_rows=100)
    port = port_graph.make_dataset("flickr", scale=0.004, features="mmap",
                                   feat_dim=16, chunk_rows=100)
    try:
        assert port.features.name == "mmap"
        np.testing.assert_array_equal(port.features.as_array(),
                                      ref.features.as_array())
        np.testing.assert_array_equal(port.labels, ref.labels)
    finally:
        port.features.close()
        ref.features.close()


def test_csr_from_edges_equal():
    rng = np.random.default_rng(1)
    src = rng.integers(0, 50, 300)
    dst = rng.integers(0, 50, 300)
    ref = ref_graph.csr_from_edges(src, dst, 50)
    port = port_graph.csr_from_edges(src, dst, 50)
    np.testing.assert_array_equal(port.indptr, ref.indptr)
    np.testing.assert_array_equal(port.indices, ref.indices)
    nodes = np.arange(50)
    np.testing.assert_array_equal(port.degree(nodes), ref.degree(nodes))


def _assert_coo_equal(port, ref):
    assert (port.n_dst, port.n_src) == (ref.n_dst, ref.n_src)
    assert port.rows.dtype == torch.int32 and port.vals.dtype == torch.float32
    np.testing.assert_array_equal(port.rows.numpy(), np.asarray(ref.rows))
    np.testing.assert_array_equal(port.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(port.vals.numpy(), np.asarray(ref.vals))


def test_from_edges_and_normalizations_equal():
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 20, 120)
    cols = rng.integers(0, 30, 120)
    vals = rng.standard_normal(120)
    _assert_coo_equal(port_graph.from_edges(rows, cols, vals, 20, 30),
                      ref_graph.from_edges(rows, cols, vals, 20, 30))
    _assert_coo_equal(port_graph.mean_normalize(rows, cols, 20, 30),
                      ref_graph.mean_normalize(rows, cols, 20, 30))
    sq = rng.integers(0, 20, 120)
    _assert_coo_equal(port_graph.sym_normalize(rows, sq, 20),
                      ref_graph.sym_normalize(rows, sq, 20))


def test_coo_plain_products_match_reference():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 12, 60)
    cols = rng.integers(0, 9, 60)
    vals = rng.standard_normal(60).astype(np.float32)
    x = rng.standard_normal((9, 5)).astype(np.float32)
    e = rng.standard_normal((12, 5)).astype(np.float32)
    ref = ref_graph.from_edges(rows, cols, vals, 12, 9)
    port = port_graph.from_edges(rows, cols, vals, 12, 9)
    np.testing.assert_allclose(port.matmul(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.matmul(x)), atol=1e-5)
    np.testing.assert_allclose(port.rmatmul(torch.from_numpy(e)).numpy(),
                               np.asarray(ref.rmatmul(e)), atol=1e-5)
    np.testing.assert_allclose(port.todense().numpy(),
                               np.asarray(ref.todense()), atol=1e-6)
