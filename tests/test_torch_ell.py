"""Port vs reference: the ELL kernel, the ELL walk, the GEMM and the layers.

On the CPU the port's kernel wrappers run their plain versions; the
reference runs its Pallas kernels in interpret mode (and, for the walk,
its XLA twin too).  Tolerance: ``max|Δ| ≤ 1e-5`` — XLA and torch sum in
different orders (and may or may not fuse multiply-adds).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.engine import Engine as RefEngine  # noqa: E402
from repro.graph import from_edges as ref_from_edges  # noqa: E402
from repro.kernels import edgeplan as ref_edgeplan  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.graph import from_edges  # noqa: E402
from repro_torch.kernels import (edgeplan, ell_apply, gemm,  # noqa: E402
                                 spmm_ell)

# repro.kernels re-exports a function named spmm over its spmm module
ref_spmm = importlib.import_module("repro.kernels.spmm")

TOL = 1e-5


def _bucket(rng, nb, K, n_src, n_pad):
    """One [nb, K] bucket; the last ``n_pad`` slots of each row are
    padding (col = n_src, val = 0), like build_tables writes them."""
    cols = rng.integers(0, n_src, (nb, K)).astype(np.int32)
    vals = rng.standard_normal((nb, K)).astype(np.float32)
    if n_pad:
        cols[:, K - n_pad:] = n_src
        vals[:, K - n_pad:] = 0.0
    return cols, vals


@pytest.mark.parametrize("K,n_pad", [(1, 0), (5, 2), (16, 7)])
def test_spmm_ell_matches_interpreted_pallas(K, n_pad):
    rng = np.random.default_rng(K)
    nb, n_src, d = 16, 31, 16
    cols, vals = _bucket(rng, nb, K, n_src, n_pad)
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    # the Pallas kernel takes x with the dedicated zero row appended,
    # padded to its source tile (here n_src + 1 = 32 = 2 tiles of 16)
    xz = np.concatenate([x, np.zeros((1, d), np.float32)])
    want = np.asarray(ref_spmm.spmm_ell(jnp.asarray(cols), jnp.asarray(vals),
                                        jnp.asarray(xz), br=8, bd=16, bs=16,
                                        interpret=True))
    got = spmm_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                   torch.from_numpy(x))
    assert got.shape == (nb, d)
    assert np.abs(got.numpy() - want).max() <= TOL


def test_spmm_ell_out_slice_and_empty_bucket():
    rng = np.random.default_rng(9)
    cols, vals = _bucket(rng, 6, 4, 10, 1)
    x = torch.from_numpy(rng.standard_normal((10, 3)).astype(np.float32))
    buf = torch.full((9, 3), 5.0)
    spmm_ell(torch.from_numpy(cols), torch.from_numpy(vals), x,
             out=buf[2:8])
    want = spmm_ell(torch.from_numpy(cols), torch.from_numpy(vals), x)
    assert torch.equal(buf[2:8], want)
    assert torch.equal(buf[:2], torch.full((2, 3), 5.0))   # untouched
    assert torch.equal(buf[8:], torch.full((1, 3), 5.0))
    empty = spmm_ell(torch.zeros((0, 4), dtype=torch.int32),
                     torch.zeros((0, 4)), x)
    assert empty.shape == (0, 3)


def test_spmm_ell_rejects_bad_inputs():
    x = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        spmm_ell(torch.zeros((2, 2), dtype=torch.int64), torch.zeros((2, 2)),
                 x)
    with pytest.raises(ValueError):
        spmm_ell(torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 3)),
                 x)
    with pytest.raises(ValueError):
        spmm_ell(torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2)),
                 x, out=torch.zeros((3, 3)))


def test_poisoned_padding_gathers_nothing():
    """Padding entries carry a poisoned weight and out-of-range columns;
    real rows hold large sentinel values.  Padding must read nothing at
    all, so every output equals the dense oracle of the real entries."""
    rng = np.random.default_rng(11)
    nb, K, n_src, d = 12, 6, 20, 7
    cols, vals = _bucket(rng, nb, K, n_src, 2)
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    x[0] = 3.0e4                 # real row 0: the row padding must not hit
    x[-1] = -2.0e4
    dense = np.zeros((nb, n_src), np.float64)
    for r in range(nb):
        for k in range(K - 2):
            dense[r, cols[r, k]] += vals[r, k]
    want = dense @ x.astype(np.float64)
    poisoned_c = cols.copy()
    poisoned_v = vals.copy()
    poisoned_v[:, K - 2:] = 7.0                  # poisoned pad weights
    poisoned_c[::2, K - 1] = n_src + 5           # and stray pad columns
    poisoned_c[1::2, K - 1] = -1
    got = spmm_ell(torch.from_numpy(poisoned_c), torch.from_numpy(poisoned_v),
                   torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    clean = spmm_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                     torch.from_numpy(x)).numpy()
    assert np.array_equal(got, clean)


def _plan_pair(seed, caps="pow2"):
    rng = np.random.default_rng(seed)
    n_dst, n_src, nnz = 24, 18, 150
    # rows 20.. and cols 15.. get no edges: empty rows in both walks
    rows = np.concatenate([rng.integers(0, 20, nnz), np.full(30, 3)])
    cols = rng.integers(0, n_src - 3, len(rows))
    vals = rng.uniform(0.05, 1.0, len(rows)).astype(np.float32)
    ref = ref_edgeplan.build_plan(
        ref_from_edges(rows, cols, vals, n_dst, n_src), caps=caps)
    port = edgeplan.build_plan(from_edges(rows, cols, vals, n_dst, n_src),
                               caps=caps)
    return ref, port, rng


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_ell_apply_matches_reference(transpose, use_pallas):
    ref, port, rng = _plan_pair(1)
    n_in = ref.n_dst if transpose else ref.n_src
    x = rng.standard_normal((n_in, 9)).astype(np.float32)
    want = np.asarray(ref_ops.ell_apply(ref.device_tables(), jnp.asarray(x),
                                        transpose=transpose,
                                        use_pallas=use_pallas))
    got = ell_apply(port.device_tables("cpu"), torch.from_numpy(x),
                    transpose=transpose)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL
    # rows with no edges come out exactly zero
    empty = np.asarray(
        (port.bwd if transpose else port.fwd).inv_perm) == sum(
        c.shape[0] for c in (port.bwd if transpose else port.fwd).cols)
    assert empty.any() and not got.numpy()[empty].any()


@pytest.mark.parametrize("bias,relu", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_gemm_matches_interpreted_pallas(bias, relu):
    rng = np.random.default_rng(int(bias) * 2 + int(relu))
    x = rng.standard_normal((37, 13)).astype(np.float32)
    w = rng.standard_normal((13, 11)).astype(np.float32)
    b = rng.standard_normal(11).astype(np.float32) if bias else None
    want = np.asarray(ref_ops.gemm(jnp.asarray(x), jnp.asarray(w),
                                   None if b is None else jnp.asarray(b),
                                   relu=relu))
    got = gemm(torch.from_numpy(x), torch.from_numpy(w),
               None if b is None else torch.from_numpy(b), relu=relu)
    assert got.shape == (37, 11)
    assert np.abs(got.numpy() - want).max() <= TOL


def test_gemm_rows_do_not_depend_on_row_count():
    """The contract the kernel keeps on the card, held by the plain version
    on the CPU: a row's bits are the same in every row bucket."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    full = gemm(x, w, relu=True)
    for lo, m in [(0, 1), (3, 8), (17, 32)]:
        assert torch.equal(gemm(x[lo:lo + m], w, relu=True),
                           full[lo:lo + m])


@pytest.mark.parametrize("spec", ["coo+serial", "ell+pipelined"])
@pytest.mark.parametrize("order", ["coag", "agco"])
def test_engine_layer_matches_reference(spec, order):
    rng = np.random.default_rng(3)
    n_dst, n_src, d, h = 16, 24, 10, 6
    rows = rng.integers(0, n_dst - 2, 120)
    cols = rng.integers(0, n_src, 120)
    vals = rng.uniform(0.05, 1.0, 120).astype(np.float32)
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    w = rng.standard_normal((d, h)).astype(np.float32)
    for activate in (True, False):
        want = np.asarray(RefEngine(spec).layer(
            ref_from_edges(rows, cols, vals, n_dst, n_src), jnp.asarray(x),
            jnp.asarray(w), order=order, activate=activate))
        got = Engine(spec).layer(
            from_edges(rows, cols, vals, n_dst, n_src), torch.from_numpy(x),
            torch.from_numpy(w), order=order, activate=activate,
            device="cpu")
        assert got.shape == (n_dst, h)
        assert np.abs(got.numpy() - want).max() <= TOL
