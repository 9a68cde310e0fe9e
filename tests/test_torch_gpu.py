"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips with a reason here.  On a machine with one NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

(``chip_smoke.py`` holds every kernel at the shapes of its paths; these
are the edge cases, quick to rerun after a kernel edit.)  No JAX here: the
machine with the card has none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

# f32: the reference's 3e-4 tightened to 1e-5 (kernel and plain version
# differ only in summation order); bf16: the reference's 5e-2
F32_TOL, BF16_TOL = 1e-5, 5e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _qkv(seed, bh, sq, sk, hd, dtype, dev):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((bh, sk, hd)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(a).to(dev, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,sk,hd,qb,kb", [
    (4, 1024, 1024, 64, 128, 256),     # the reference's sweep
    (2, 512, 512, 128, 256, 128),
    (1, 256, 256, 32, 128, 128),
    (2, 256, 256, 16, 128, 128),       # the smoke config's head dim
    (2, 512, 512, 64, 512, 512),       # one tile
    (2, 256, 512, 64, 128, 256),       # sq < sk
    (2, 512, 256, 64, 256, 128),       # sq > sk
    (3, 100, 70, 32, 4, 2),            # ragged for the kernel's 64-tile
])
def test_flash_mha_kernel_matches_plain(causal, bh, sq, sk, hd, qb, kb):
    from repro_torch.kernels import flash_mha, mha_ref

    dev = _card()
    q, k, v = _qkv(sq + sk + hd, bh, sq, sk, hd, torch.float32, dev)
    n0 = flash_mha.launches
    got = flash_mha(q, k, v, causal=causal, q_block=qb, k_block=kb)
    torch.cuda.synchronize()
    assert flash_mha.launches == n0 + 1
    want = mha_ref(q, k, v, causal=causal, q_block=qb)
    assert got.dtype == torch.float32 and got.shape == (bh, sq, hd)
    assert float((got - want).abs().max()) <= F32_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_flash_mha_kernel_bf16(causal):
    from repro_torch.kernels import flash_mha, mha_ref

    dev = _card()
    q, k, v = _qkv(7, 2, 512, 512, 64, torch.bfloat16, dev)
    got = flash_mha(q, k, v, causal=causal, q_block=128, k_block=128)
    want = mha_ref(q, k, v, causal=causal, q_block=128)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL


# -- flash_mha on the tensor cores: f32 as three TF32 products per product
# (hi·hi + hi·lo + lo·hi), bf16 as one bf16 product, 128-row query tiles --
F64_TOL = 2e-6          # plain f32 is 3.2e-7 off float64 at the shape below,
                        # one TF32 product 1.8e-4: catches a dropped lo term


def test_flash_mha_kernel_f32_near_float64():
    from repro_torch.kernels import flash_mha, mha_ref

    dev = _card()
    q, k, v = _qkv(11, 4, 1024, 1024, 64, torch.float32, dev)
    got = flash_mha(q, k, v, causal=False, q_block=128, k_block=256)
    want = mha_ref(q.double(), k.double(), v.double(), causal=False,
                   q_block=256)
    assert float((got.double() - want).abs().max()) <= F64_TOL


@pytest.mark.parametrize("hd", [128, 16])
def test_flash_mha_kernel_causal_s2048(hd):
    from repro_torch.kernels import flash_mha, mha_ref

    dev = _card()
    q, k, v = _qkv(hd, 2, 2048, 2048, hd, torch.float32, dev)
    got = flash_mha(q, k, v, causal=True, q_block=256, k_block=256)
    want = mha_ref(q, k, v, causal=True, q_block=256)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= F32_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,sk,hd,qb,kb", [
    (2, 512, 512, 128, 128, 128),      # hd 128
    (3, 100, 70, 32, 4, 2),            # ragged for the kernel's tiles
])
def test_flash_mha_kernel_bf16_edges(causal, bh, sq, sk, hd, qb, kb):
    from repro_torch.kernels import flash_mha, mha_ref

    dev = _card()
    q, k, v = _qkv(sq + hd, bh, sq, sk, hd, torch.bfloat16, dev)
    got = flash_mha(q, k, v, causal=causal, q_block=qb, k_block=kb)
    want = mha_ref(q, k, v, causal=causal, q_block=qb)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, sq, hd)
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(200, 328), (328, 200), (129, 127),
                                   (127, 255), (1, 130), (130, 1)])
def test_flash_mha_kernel_off_the_query_tile(sq, sk, dtype, causal):
    """sq and sk that are not multiples of the kernel's 128-row query tile
    or 64-key tile: the last warps and keys are masked in the kernel."""
    from repro_torch.kernels import flash_mha, mha_ref

    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v = _qkv(sq * 7 + sk, 2, sq, sk, 64, dt, dev)
    got = flash_mha(q, k, v, causal=causal, q_block=1, k_block=1)
    want = mha_ref(q, k, v, causal=causal, q_block=128)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    assert torch.isfinite(got.float()).all()
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_flash_mha_kernel_one_launch_per_call():
    from repro_torch.kernels import flash_mha

    dev = _card()
    calls = [(1, 64, 64, 16, torch.float32, True),
             (2, 300, 200, 64, torch.float32, False),
             (2, 257, 513, 128, torch.float32, True),
             (1, 1000, 1000, 64, torch.bfloat16, True),
             (3, 100, 70, 32, torch.bfloat16, False)]
    n0 = flash_mha.launches
    for i, (bh, sq, sk, hd, dt, causal) in enumerate(calls):
        q, k, v = _qkv(i, bh, sq, sk, hd, dt, dev)
        flash_mha(q, k, v, causal=causal, q_block=1, k_block=1)
        assert flash_mha.launches == n0 + i + 1
    torch.cuda.synchronize()


# -- flash_mha with a sliding window (gemma3's local layers): the band
# i - j < w on top of the causal mask, tiles below the band skipped --------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [1, 7, 64, 65, 384, 1000])
@pytest.mark.parametrize("bh,sq,sk,hd", [
    (2, 1024, 1024, 128),      # gemma3's head dim
    (2, 512, 512, 64),
    (2, 256, 640, 64),         # sq < sk
    (1, 300, 200, 32),         # ragged, sq > sk
])
def test_flash_mha_window_matches_plain(bh, sq, sk, hd, w, dtype):
    from repro_torch.kernels import flash_mha, mha_ref

    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v = _qkv(sq + sk + w, bh, sq, sk, hd, dt, dev)
    n0, w0 = flash_mha.launches, flash_mha.window_launches
    got = flash_mha(q, k, v, causal=True, q_block=1, k_block=1, window=w)
    torch.cuda.synchronize()
    assert (flash_mha.launches, flash_mha.window_launches) == (n0 + 1,
                                                               w0 + 1)
    want = mha_ref(q, k, v, causal=True, q_block=128, window=w)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    assert got.dtype == dt and torch.isfinite(got.float()).all()
    # a row with no key in its band (i >= sk + w - 1, only when sq > sk)
    # comes out 0 from the kernel; the plain version averages v there
    live = torch.arange(sq, device=dev) < sk + w - 1
    assert float((got.float() - want.float())[:, live].abs().max()) <= tol
    assert not got[:, ~live].any()


@pytest.mark.parametrize("w", [1, 65])
def test_flash_mha_window_without_the_causal_mask(w):
    from repro_torch.kernels import flash_mha, mha_ref

    dev = _card()
    q, k, v = _qkv(w, 2, 512, 512, 64, torch.float32, dev)
    got = flash_mha(q, k, v, causal=False, q_block=1, k_block=1, window=w)
    want = mha_ref(q, k, v, causal=False, q_block=128, window=w)
    assert float((got - want).abs().max()) <= F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1024, 1000])
def test_flash_mha_window_past_the_keys_equals_causal(s, dtype):
    """w >= s masks nothing more than the causal mask: the same bits."""
    from repro_torch.kernels import flash_mha

    dev = _card()
    q, k, v = _qkv(s, 2, s, s, 128, getattr(torch, dtype), dev)
    causal = flash_mha(q, k, v, causal=True, q_block=1, k_block=1)
    for w in (s, s + 1, 2 ** 31 - 1):
        got = flash_mha(q, k, v, causal=True, q_block=1, k_block=1,
                        window=w)
        assert torch.equal(got, causal), w


# -- spmm_ell: the one-launch walk and the per-bucket wrapper, bit-equal to
# the plain version (same products, same ascending-k sums) ----------------
WALK_KS = (1, 3, 31, 32, 33, 64, 2048, 4096)


def _ell_bucket(rng, lead, nb, K, n_src):
    """One bucket: random entries with trailing padding (col n_src, weight
    0) and stray padding columns (past n_src, and -1) mid-row."""
    cols = rng.integers(0, n_src, (*lead, nb, K)).astype(np.int32)
    vals = rng.standard_normal((*lead, nb, K)).astype(np.float32)
    if nb and K > 2:
        cols[..., -(K // 3 + 1):] = n_src
        vals[..., -(K // 3 + 1):] = 0.0
        cols[..., ::2, K // 2] = n_src + 7
        cols[..., 1::2, 0] = -1
    if nb > 1:
        cols[..., -1, :] = n_src                    # a pad-only row
        vals[..., -1, :] = 0.0
    return cols, vals


def _ell_walk_inputs(seed, P, d, x_rows4, dev):
    """A walk over every K of ``WALK_KS`` plus an empty bucket, on ``P``
    cores (P = 2: one shared x through a zero core stride), ``x`` either
    contiguous or with rows padded to a multiple of 4 floats."""
    from repro_torch.kernels.spmm import ell_walk

    rng = np.random.default_rng(seed)
    n_src = 5000
    lead = (P,) if P > 1 else ()
    shapes = [(300, 1), (40, 3), (9, 31), (0, 8), (12, 32), (7, 33),
              (5, 64), (3, 2048), (2, 4096)]
    assert {K for _, K in shapes} >= set(WALK_KS)
    tabs = [_ell_bucket(rng, lead, nb, K, n_src) for nb, K in shapes]
    cols = tuple(torch.from_numpy(c).to(dev) for c, _ in tabs)
    vals = tuple(torch.from_numpy(v).to(dev) for _, v in tabs)
    ld = -(-d // 4) * 4 if x_rows4 else d
    xs = torch.from_numpy(rng.standard_normal((n_src, ld)).astype(
        np.float32)).to(dev)[:, :d]
    x = xs.unsqueeze(0).expand(P, n_src, d) if P > 1 else xs
    return ell_walk(cols, vals), cols, vals, x


@pytest.mark.parametrize("x_rows4", [False, True])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("d", [5, 41, 256, 602])
def test_spmm_ell_walk_kernel_bit_equal(d, P, x_rows4):
    from repro_torch.kernels import spmm_ell, spmm_ell_ref
    from repro_torch.kernels.spmm import spmm_ell_walk

    dev = _card()
    walk, cols, vals, x = _ell_walk_inputs(d + P, P, d, x_rows4, dev)
    lead = (P,) if P > 1 else ()
    # out: a strided slice of a larger buffer (rows 2.., features 3..)
    big = torch.full((*lead, walk.total + 4, d + 7), 7.0, device=dev)
    out = big[..., 2:2 + walk.total, 3:3 + d]
    n0 = spmm_ell.launches
    spmm_ell_walk(walk, x, out)
    torch.cuda.synchronize()
    assert spmm_ell.launches == n0 + 1
    base = 0
    for c, v in zip(cols, vals):
        nb = c.shape[-2]
        if nb:
            want = spmm_ell_ref(c, v, x)
            assert torch.equal(out[..., base:base + nb, :], want), \
                f"bucket K={c.shape[-1]} differs"
        base += nb
    assert (big[..., :2, :] == 7).all() and (big[..., -2:, :] == 7).all()
    assert (big[..., :3] == 7).all() and (big[..., 3 + d:] == 7).all()


@pytest.mark.parametrize("K", WALK_KS)
def test_spmm_ell_bucket_kernel_bit_equal(K):
    from repro_torch.kernels import spmm_ell, spmm_ell_ref, spmm_ell_t

    dev = _card()
    rng = np.random.default_rng(K)
    for lead, d in (((), 256), ((2,), 41)):
        c, v = (torch.from_numpy(a).to(dev)
                for a in _ell_bucket(rng, lead, 6, K, 3000))
        x = torch.from_numpy(rng.standard_normal((3000, d)).astype(
            np.float32)).to(dev)
        if lead:
            x = x.unsqueeze(0).expand(2, 3000, d)
        n0, t0 = spmm_ell.launches, spmm_ell_t.launches
        assert torch.equal(spmm_ell(c, v, x), spmm_ell_ref(c, v, x))
        assert torch.equal(spmm_ell_t(c, v, x), spmm_ell_ref(c, v, x))
        assert (spmm_ell.launches, spmm_ell_t.launches) == (n0 + 1, t0 + 1)


def test_spmm_ell_walk_counts_and_empty_walks():
    from repro_torch.kernels import spmm_ell, spmm_ell_t
    from repro_torch.kernels.spmm import (ell_walk, spmm_ell_t_walk,
                                          spmm_ell_walk)

    dev = _card()
    walk, _, _, x = _ell_walk_inputs(1, 1, 41, False, dev)
    out = torch.empty((walk.total, 41), device=dev)
    n0, t0 = spmm_ell.launches, spmm_ell_t.launches
    spmm_ell_t_walk(walk, x, out)
    assert (spmm_ell.launches, spmm_ell_t.launches) == (n0, t0 + 1)
    empty = ell_walk((torch.zeros((0, 4), dtype=torch.int32, device=dev),),
                     (torch.zeros((0, 4), device=dev),))
    spmm_ell_walk(empty, x, torch.empty((0, 41), device=dev))
    none = ell_walk((), ())
    spmm_ell_walk(none, x, torch.empty((0, 41), device=dev))
    assert spmm_ell.launches == n0


@pytest.mark.parametrize("transpose", [False, True])
def test_ell_apply_on_the_card_equals_the_cpu(transpose):
    from repro_torch.graph import from_edges
    from repro_torch.kernels import edgeplan, ell_apply

    dev = _card()
    rng = np.random.default_rng(4)
    n_dst, n_src = 3000, 2500
    rows = np.concatenate([rng.integers(0, n_dst, 60000),
                           np.full(3000, 17)])          # one hub row
    cols = rng.integers(0, n_src, len(rows))
    vals = rng.uniform(0.05, 1.0, len(rows)).astype(np.float32)
    plan = edgeplan.build_plan(from_edges(rows, cols, vals, n_dst, n_src))
    x = rng.standard_normal((n_dst if transpose else n_src, 256)).astype(
        np.float32)
    got = ell_apply(plan.device_tables(dev), torch.from_numpy(x).to(dev),
                    transpose=transpose)
    want = ell_apply(plan.device_tables("cpu"), torch.from_numpy(x),
                     transpose=transpose)
    assert torch.equal(got.cpu(), want)


# -- gemm: within (1e-4, 1e-5) of the K-ordered plain version; a row's bits
# never depend on M.  w is drawn at the Glorot scale of the served model's
# weights (chip_smoke.seeded_params): the kernel fuses each multiply-add and
# the plain version does not, so their gap grows with |x @ w|, and unit
# weights at K = 602 put outputs near 25, far from any layer's ---------------
GEMM_RTOL, GEMM_ATOL = 1e-4, 1e-5


def _gemm_inputs(seed, m, k, n, dev):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * np.sqrt(2.0 / (k + n))).astype(
        np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return (torch.from_numpy(a).to(dev) for a in (x, w, bias))


@pytest.mark.parametrize("n", [1, 41, 256])
@pytest.mark.parametrize("k", [1, 16, 256, 602])
@pytest.mark.parametrize("m", [1, 8, 127, 1024, 16387])
def test_gemm_kernel_matches_plain(m, k, n):
    from repro_torch.kernels import gemm, gemm_ref

    dev = _card()
    x, w, bias = _gemm_inputs(m + k + n, m, k, n, dev)
    for b, relu in ((None, False), (bias, True)):
        n0 = gemm.launches
        got = gemm(x, w, b, relu=relu)
        assert gemm.launches == n0 + 1
        torch.testing.assert_close(got, gemm_ref(x, w, b, relu=relu),
                                   rtol=GEMM_RTOL, atol=GEMM_ATOL)


@pytest.mark.parametrize("n", [1, 41, 256])
@pytest.mark.parametrize("k", [1, 16, 256, 602])
def test_gemm_rows_do_not_depend_on_m(k, n):
    from repro_torch.kernels import gemm

    dev = _card()
    x, w, bias = _gemm_inputs(k * n, 16387, k, n, dev)
    for b, relu in ((None, False), (bias, True)):
        full = gemm(x, w, b, relu=relu)
        for lo, rows in ((0, 8), (5, 64), (1000, 1024), (7, 8192), (0, 1),
                         (3, 127)):
            part = gemm(x[lo:lo + rows].contiguous(), w, b, relu=relu)
            assert torch.equal(part, full[lo:lo + rows]), (lo, rows)


# -- spmm / spmm_block: the COO walk kernel, torch.equal to its plain version
# (every row adds its entries in grouping order from +0.0) -----------------
COO_ROW_LENGTHS = (0, 1, 2, 31, 32, 33, 95, 2048)
COO_WIDTHS = (1, 5, 41, 128, 256, 300, 602)


def _coo_walk_case(rng, P, n_out, n_src):
    """``[P, E]`` entries of one stacked COO walk: per core a row of every
    length in ``COO_ROW_LENGTHS``, random short rows, a run of 600 empty
    rows (past a warp's budget), padding columns past ``n_src`` with
    nonzero weight and weight-0 entries; core 3 (when P > 3) has no
    entries that count.  Entries are shuffled, so grouping reorders them."""
    parts = []
    for p in range(P):
        rows = [np.full(n, 7 + 9 * i) for i, n in enumerate(COO_ROW_LENGTHS)]
        rows.append(rng.integers(700, n_out, 3000))      # rows 100-699 empty
        rows = np.concatenate(rows)
        cols = rng.integers(0, n_src, len(rows))
        vals = rng.standard_normal(len(rows)).astype(np.float32)
        cols[rng.random(len(rows)) < 0.03] = n_src + 5     # padding
        vals[rng.random(len(rows)) < 0.03] = 0.0
        if p == 3:
            vals[:] = 0.0
        order = rng.permutation(len(rows))
        parts.append((rows[order], cols[order], vals[order]))
    E = max(len(r) for r, _, _ in parts)
    out = [np.zeros((P, E), np.int32), np.full((P, E), n_src, np.int32),
           np.zeros((P, E), np.float32)]
    for p, arrs in enumerate(parts):
        for o, a in zip(out, arrs):
            o[p, :len(a)] = a
    return out


def _coo_tensors(fn_name, rows, cols, vals, n_out, dev, squeeze=False):
    """The wrapper's arguments: flat ``[P, E]`` lists for ``spmm``, or the
    same entries as ``[P, B, eb]`` tiles of ``dpc`` block-local rows for
    ``spmm_block``; without the core axis when ``squeeze``."""
    if fn_name == "spmm":
        return [torch.from_numpy(a[0] if squeeze else a).to(dev)
                for a in (rows, cols, vals)], n_out
    B, dpc = 4, n_out // 4
    P, E = rows.shape
    tiles = [np.zeros((P, B, E), np.int32), np.full((P, B, E), -1, np.int32),
             np.zeros((P, B, E), np.float32)]
    for p in range(P):
        for b in range(B):
            sel = rows[p] // dpc == b
            n = int(sel.sum())
            tiles[0][p, b, :n] = rows[p][sel] - b * dpc
            tiles[1][p, b, :n] = cols[p][sel]
            tiles[2][p, b, :n] = vals[p][sel]
    return [torch.from_numpy(a[0] if squeeze else a).to(dev)
            for a in tiles], dpc


def _coo_call(fn_name, args, rows_arg, x, out=None):
    from repro_torch.kernels import spmm, spmm_block

    fn = spmm if fn_name == "spmm" else spmm_block
    return fn(*args, x, rows_arg, out=out)


def _coo_plain(fn_name, args, rows_arg, x):
    """The plain version on the CPU (its ``index_add_`` adds in grouping
    order)."""
    from repro_torch.kernels import spmm_block_ref, spmm_ref

    fn = spmm_ref if fn_name == "spmm" else spmm_block_ref
    return fn(*(a.cpu() for a in args), x.cpu(), rows_arg)


@pytest.mark.parametrize("fn_name", ["spmm", "spmm_block"])
@pytest.mark.parametrize("P", [1, 16])
@pytest.mark.parametrize("d", COO_WIDTHS)
def test_coo_walk_kernel_bit_equal(d, P, fn_name):
    from repro_torch.kernels import spmm, spmm_block

    dev = _card()
    rng = np.random.default_rng(d * 100 + P)
    n_out, n_src = 2400, 1500
    rows, cols, vals = _coo_walk_case(rng, P, n_out, n_src)
    args, rows_arg = _coo_tensors(fn_name, rows, cols, vals, n_out, dev,
                                  squeeze=P == 1)
    xs = torch.from_numpy(rng.standard_normal(
        (P if fn_name == "spmm_block" else 1, n_src, d)).astype(
            np.float32)).to(dev)
    # spmm: one x shared by every core (zero core stride), as the
    # backward's all-gathered error; spmm_block: each core's own rows
    x = xs[0] if P == 1 else (xs if fn_name == "spmm_block"
                              else xs.expand(P, n_src, d))
    counter = spmm if fn_name == "spmm" else spmm_block
    n0 = counter.launches
    got = _coo_call(fn_name, args, rows_arg, x)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    want = _coo_plain(fn_name, args, rows_arg, x)
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    if P > 3:
        assert not got[3].any()                  # a core with no entries


@pytest.mark.parametrize("x_offset", [32, 1])
def test_coo_walk_kernel_feature_wave_and_strided_out(x_offset):
    """A feature-wave slice of a wider x (16-byte aligned, or not) into a
    strided slice of a larger out, whose neighbours stay untouched."""
    dev = _card()
    rng = np.random.default_rng(x_offset)
    P, n_out, n_src, d = 4, 2400, 1500, 128
    rows, cols, vals = _coo_walk_case(rng, P, n_out, n_src)
    wide = torch.from_numpy(rng.standard_normal(
        (P, n_src, d + 64)).astype(np.float32)).to(dev)
    x = wide[..., x_offset:x_offset + d]
    for fn_name in ("spmm", "spmm_block"):
        args, rows_arg = _coo_tensors(fn_name, rows, cols, vals, n_out, dev)
        big = torch.full((P, n_out + 3, d + 70), 7.0, device=dev)
        out = big[:, 1:1 + n_out, 64:64 + d]
        _coo_call(fn_name, args, rows_arg, x, out=out)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), _coo_plain(fn_name, args, rows_arg,
                                                 x.contiguous()))
        assert (big[:, 0] == 7).all() and (big[:, -2:] == 7).all()
        assert (big[..., :64] == 7).all() and (big[..., 64 + d:] == 7).all()


def test_coo_walk_kernel_block_equals_coo_on_a_training_batch():
    """A real P = 4 training batch: the block tiles' forward and transpose
    walks on the card equal the coo shards' (torch.equal) and the CPU's,
    on both hops."""
    from repro_torch.data import GraphBatchPipeline
    from repro_torch.engine import Engine
    from repro_torch.graph import NeighborSampler, make_dataset
    from repro_torch.kernels import spmm, spmm_block

    dev = _card()
    P, d = 4, 256
    ds = make_dataset("reddit", scale=0.01, feat_dim=8)
    sampler = NeighborSampler(ds.graph, (10, 25), pad_multiple=P, seed=0)
    item = next(GraphBatchPipeline(ds, sampler, 128))
    batches = {}
    for spec in ("block+pipelined", "coo+serial"):
        bundle = Engine(spec).build(n_cores=P, device=dev)
        batches[spec] = bundle.commit_batch(bundle.prepare_batch(*item))
    bb, cb = batches["block+pipelined"], batches["coo+serial"]
    rng = np.random.default_rng(0)
    for layer, (n_dst, n_src) in enumerate(bb["dims"]):
        t, c = bb["edges"][layer], cb["edges"][layer]
        spc, dpc = n_src // P, n_dst // P
        x = torch.from_numpy(rng.standard_normal((P, spc, d)).astype(
            np.float32)).to(dev)
        fb = spmm_block(t["rows"], t["cols"], t["vals"], x, dpc,
                        perm=t["perm"], ptr=t["ptr"])
        fc = spmm(c["rows"], c["cols"], c["vals"], x, n_dst, perm=c["perm"],
                  ptr=c["ptr"])
        assert torch.equal(fb, fc)
        assert torch.equal(fb.cpu(), spmm_block(
            *(t[k].cpu() for k in ("rows", "cols", "vals")), x.cpu(), dpc))
        e = torch.from_numpy(rng.standard_normal((n_dst, d)).astype(
            np.float32)).to(dev).unsqueeze(0).expand(P, n_dst, d)
        flat = t["t_rows"].shape
        tb = spmm(t["cols"].reshape(flat), t["t_rows"],
                  t["vals"].reshape(flat), e, spc, perm=t["t_perm"],
                  ptr=t["t_ptr"])
        tc = spmm(c["cols"], c["rows"], c["vals"], e, spc,
                  perm=c["t_perm"], ptr=c["t_ptr"])
        assert torch.equal(tb, tc)
        assert torch.equal(tb.cpu(), spmm(c["cols"].cpu(), c["rows"].cpu(),
                                          c["vals"].cpu(), e.cpu(), spc))


def test_coo_walk_kernel_empty_walks_launch_nothing():
    from repro_torch.kernels import spmm, spmm_block

    dev = _card()
    z = torch.zeros((4, 0), dtype=torch.int32, device=dev)
    x = torch.ones((4, 10, 8), device=dev)
    n0, b0 = spmm.launches, spmm_block.launches
    assert spmm(z, z, z.float(), x, 0).shape == (4, 0, 8)
    # entries that all add nothing: every row is written, as zeros
    rows = torch.zeros((4, 6), dtype=torch.int32, device=dev)
    y = spmm(rows, rows, torch.zeros((4, 6), device=dev), x, 50)
    torch.cuda.synchronize()
    assert y.shape == (4, 50, 8) and not y.any()
    assert (spmm.launches, spmm_block.launches) == (n0 + 1, b0)


# -- the paper's GCN layer (coo): the transpose-free backward through the
# flat spmm kernel, the naive baseline, and the UMA walk ------------------
def _paper_layer_case(seed, n_dst=3000, n_src=5000, e=40000, d=96, h=41):
    """A rectangular COO whose columns include hubs (2048 and 600 edges),
    a run of 800 empty columns and every short length, plus zero-weight
    padding; x, w at the served model's scale, and a cotangent."""
    from repro_torch.graph import from_edges

    rng = np.random.default_rng(seed)
    cols = np.concatenate([rng.integers(1000, n_src, e), np.full(2048, 7),
                           np.full(600, 900), np.arange(33) % 5 + 100])
    rows = rng.integers(0, n_dst, len(cols))
    vals = rng.uniform(0.01, 1.0, len(cols)).astype(np.float32)
    vals[rng.random(len(cols)) < 0.02] = 0.0
    order = rng.permutation(len(cols))
    A = from_edges(rows[order], cols[order], vals[order], n_dst, n_src)
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    w = (rng.standard_normal((d, h)) * (2.0 / (d + h)) ** 0.5).astype(
        np.float32)
    ct = rng.standard_normal((n_dst, h)).astype(np.float32)
    return A, x, w, ct


@pytest.mark.parametrize("d", [1, 41, 256, 602])
def test_spmm_t_kernel_bit_equal_on_a_column_major_walk(d):
    """``_spmm_t`` (``Aᵀ e`` by the flat ``spmm`` kernel with the roles
    swapped) is ``torch.equal`` to the plain version on the card and on
    the CPU: hub columns, empty columns, padding; one launch a call."""
    from repro_torch.core.gcn import _spmm_t
    from repro_torch.kernels import spmm, spmm_ref

    dev = _card()
    A, _, _, _ = _paper_layer_case(d)
    e = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (A.n_dst, d)).astype(np.float32))
    n0 = spmm.launches
    got = _spmm_t(A, e.to(dev))
    torch.cuda.synchronize()
    assert spmm.launches == n0 + 1
    want = spmm_ref(A.cols.to(dev), A.rows.to(dev), A.vals.to(dev),
                    e.to(dev), A.n_src)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), _spmm_t(A, e))
    assert got[7].any() and not got[200:900].any()     # a hub, empty columns


@pytest.mark.parametrize("activate", [True, False])
@pytest.mark.parametrize("order", ["coag", "agco"])
@pytest.mark.parametrize("dataflow", ["ours", "naive"])
def test_gcn_layer_grads_on_the_card_match_the_cpu(dataflow, order,
                                                   activate):
    """Card vs CPU: forward within ``F32_TOL`` (the ``gemm`` kernel fuses
    the multiply-adds its plain version rounds apart), gradients within
    1e-5 of the largest gradient entry (cuBLAS and the CPU sum the
    products' n rows in different orders); the backward launches the flat
    ``spmm`` kernel (once per Aᵀ walk) and nothing else."""
    from repro_torch.core import gcn_layer, gcn_layer_baseline
    from repro_torch.kernels import gemm, spmm, spmm_block, spmm_ell

    dev = _card()
    fn = gcn_layer if dataflow == "ours" else gcn_layer_baseline
    A, x, w, ct = _paper_layer_case(3)
    out = {}
    for where in ("cpu", dev):
        xt = torch.from_numpy(x).to(where).requires_grad_(True)
        wt = torch.from_numpy(w).to(where).requires_grad_(True)
        y = fn(A, xt, wt, order=order, activate=activate)
        counts = (gemm.launches, spmm.launches, spmm_block.launches,
                  spmm_ell.launches)
        grads = torch.autograd.grad(
            (y * torch.from_numpy(ct).to(where)).sum(), (xt, wt))
        if where != "cpu":
            torch.cuda.synchronize()
            assert spmm.launches == counts[1] + 1
            assert (gemm.launches, spmm_block.launches,
                    spmm_ell.launches) == (counts[0], *counts[2:])
        out[str(where)] = [t.detach().cpu() for t in (y, *grads)]
    cpu, card = out["cpu"], out[str(dev)]
    assert float((card[0] - cpu[0]).abs().max()) <= F32_TOL
    for a, b in zip(card[1:], cpu[1:]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_gcn_layer_backward_skips_the_walk_no_input_needs():
    """AgCo's ``Aᵀ`` walk serves only ``dX``: with ``X`` a leaf that takes
    no gradient (the input features) the backward launches no ``spmm``;
    CoAg's walk also feeds ``dW`` and always runs."""
    from repro_torch.core import gcn_layer
    from repro_torch.kernels import spmm

    dev = _card()
    A, x, w, ct = _paper_layer_case(4)
    for order, walks in (("agco", 0), ("coag", 1)):
        wt = torch.from_numpy(w).to(dev).requires_grad_(True)
        y = gcn_layer(A, torch.from_numpy(x).to(dev), wt, order=order)
        n0 = spmm.launches
        (y * torch.from_numpy(ct).to(dev)).sum().backward()
        torch.cuda.synchronize()
        assert spmm.launches == n0 + walks
        assert wt.grad is not None and torch.isfinite(wt.grad).all()


def test_uma_aggregate_on_the_card_matches_the_cpu():
    """The UMA walk at P = 16 on the card (one launch forward, one
    backward) against the CPU: forward equal bits, gradient within 1e-5."""
    from repro_torch.distributed import aggregate as agg
    from repro_torch.kernels import spmm

    dev = _card()
    A, x, _, _ = _paper_layer_case(5, n_dst=3008, n_src=5008)
    P = 16
    es = agg.shard_edges_by_dst(A, P)
    leaves = agg.uma_leaves(es)
    g = np.random.default_rng(5).standard_normal(
        (A.n_dst, x.shape[1])).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        t = {k: torch.from_numpy(v).to(where) for k, v in leaves.items()}
        xt = torch.from_numpy(x).to(where).reshape(P, -1, x.shape[1])
        xt.requires_grad_(True)
        n0 = spmm.launches
        y = agg.uma_aggregate(es.n_dst, t["rows"], t["cols"], t["vals"], xt,
                              groups=t).reshape(A.n_dst, -1)
        (dx,) = torch.autograd.grad(
            (y * torch.from_numpy(g).to(where)).sum(), xt)
        if where != "cpu":
            torch.cuda.synchronize()
            assert spmm.launches == n0 + 2
        out[str(where)] = (y.detach().cpu(), dx.cpu())
    (y0, d0), (y1, d1) = out["cpu"], out[str(dev)]
    assert torch.equal(y1, y0)
    assert float((d1 - d0).abs().max()) <= 1e-5


# -- the redundancy tier's pre-pass walks (vv forward, vvt backward) and the
# topologies' folds: card against CPU, equal bits ----------------------------
def _zipf_gcn(n_dst, n_src, deg, seed, sparse_stripe=None, P=4):
    """Zipf-skewed sources with GCN weights (shared pairs mine); with
    ``sparse_stripe`` that source stripe keeps one entry per row, so its
    sender mines nothing."""
    from repro_torch.graph import from_edges

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_dst, dtype=np.int64), deg)
    w = 1.0 / np.arange(1.0, n_src + 1.0) ** 1.2
    cols = rng.permutation(n_src)[rng.choice(n_src, rows.size,
                                             p=w / w.sum())]
    keep = np.unique(rows * n_src + cols)
    rows, cols = keep // n_src, keep % n_src
    if sparse_stripe is not None:
        on = cols // (n_src // P) == sparse_stripe
        seen, keep = set(), np.ones(rows.size, bool)
        for i in np.flatnonzero(on):
            keep[i] = rows[i] not in seen
            seen.add(rows[i])
        rows, cols = rows[keep], cols[keep]
    dd = np.bincount(rows, minlength=n_dst).astype(np.float64)
    ds = np.bincount(cols, minlength=n_src).astype(np.float64)
    vals = (1.0 / np.sqrt(np.maximum(dd[rows] * ds[cols], 1.0))).astype(
        np.float32)
    return from_edges(rows, cols, vals, n_dst, n_src)


@pytest.mark.parametrize("case", ["plan", "stacked_one_core_empty",
                                  "stacked_none_mined"])
def test_redundancy_walks_on_the_card_equal_the_cpu(case):
    """The ``vv`` pre-pass (forward) and the ``Vᵀ`` walk (backward) through
    ``ell_apply``: card == CPU bit for bit, at d = 41 and 256, one more
    ``spmm_ell`` / ``spmm_ell_t`` launch each where a sender mined, none
    where no sender did (the tables are then the dedup tables)."""
    from repro_torch.distributed import aggregate as agg
    from repro_torch.engine import formats
    from repro_torch.kernels import edgeplan, ell_apply, spmm_ell, spmm_ell_t

    dev = _card()
    P = 4
    if case == "plan":
        coo = _zipf_gcn(3000, 2000, 12, 1)
        plan = edgeplan.build_plan(coo, merge="redundancy")
        assert plan.n_virtual > 0
        tabs = {w: plan.device_tables(w) for w in ("cpu", dev)}
        x_rows, e_rows, lead = coo.n_src, coo.n_dst, ()
    else:
        if case == "stacked_one_core_empty":
            coo = _zipf_gcn(2048, 4096, 24, 2, sparse_stripe=3, P=P)
        else:                       # every row one entry: nothing to mine
            from repro_torch.graph import from_edges
            coo = from_edges(np.arange(2048), np.arange(2048) * 2,
                             np.ones(2048, np.float32), 2048, 4096)
        ee = agg.shard_edges_ell(coo, P, merge="redundancy")
        leaves = {**ee.tables, **ee.items}
        fmt = formats.EllFormat()
        tabs = {w: fmt.to_device(leaves, w) for w in ("cpu", dev)}
        x_rows, e_rows, lead = coo.n_src // P, coo.n_dst, (P,)
        if case == "stacked_none_mined":
            assert ee.n_virtual == 0 and "vv_cols" not in ee.tables
        else:
            vv = ee.tables["vv_cols"]
            assert ee.n_virtual > 0
            assert all((c[3] == x_rows).all() for c in vv)
    merged = "vv_cols" in tabs["cpu"]
    rng = np.random.default_rng(7)
    for d in (41, 256):
        x = rng.standard_normal((*lead, x_rows, d)).astype(np.float32)
        e = rng.standard_normal((e_rows, d)).astype(np.float32)
        for transpose, inp in ((False, x), (True, e)):
            got = {}
            for where in ("cpu", dev):
                t = torch.from_numpy(inp).to(where)
                if transpose and lead:      # the all-gathered error
                    t = t.unsqueeze(0).expand(P, *t.shape)
                n0, t0 = spmm_ell.launches, spmm_ell_t.launches
                got[str(where)] = ell_apply(tabs[where], t,
                                            transpose=transpose).cpu()
                if where != "cpu":
                    torch.cuda.synchronize()
                    walks = 2 if merged else 1
                    assert (spmm_ell.launches - n0,
                            spmm_ell_t.launches - t0) == \
                        ((0, walks) if transpose else (walks, 0))
            assert torch.equal(got[str(dev)], got["cpu"]), (case, d,
                                                            transpose)


@pytest.mark.parametrize("name", ["ring", "allpairs", "torus2d",
                                  "hypercube"])
def test_topology_folds_on_the_card_equal_the_cpu(name):
    """Each topology's reduce-scatter, all-gather and fused fold, and the
    ``ell`` aggregate over it (forward and gradient), card == CPU bit for
    bit at P = 16, d = 41 (torus2d's odd split) and 256."""
    from repro_torch.engine import Engine, get_topology

    dev = _card()
    topo = get_topology(name)
    P, t = 16, 24
    rng = np.random.default_rng(3)
    coo = _zipf_gcn(P * 64, P * 128, 16, 3)
    for d in (41, 256):
        part = rng.standard_normal((P, P, t, d)).astype(np.float32)
        xb = rng.standard_normal((P, t, d)).astype(np.float32)
        xl = rng.standard_normal((P, P * t, d)).astype(np.float32)
        x = rng.standard_normal((coo.n_src, d)).astype(np.float32)
        g = rng.standard_normal((coo.n_dst, d)).astype(np.float32)
        out = {}
        for where in ("cpu", dev):
            def put(a):
                return torch.from_numpy(a).to(where)
            bundle = Engine(f"ell+pipelined+{name}").build(P, device=where)
            xt = put(x).requires_grad_(True)
            y = bundle.aggregate(xt, coo)
            (dx,) = torch.autograd.grad((y * put(g)).sum(), xt)
            out[str(where)] = [a.detach().cpu() for a in (
                topo.reduce_scatter(put(part), P),
                topo.allgather(put(xb), P),
                topo.allgather_pipelined(put(xb), P, 2),
                topo.fold_pipelined(
                    P, 2, lambda xc: (xc * 2.0).reshape(P, P, t, -1),
                    put(xl)),
                y, dx)]
        for a, b in zip(out[str(dev)], out["cpu"]):
            assert torch.equal(a, b), (name, d)


# ---------------------------------------------------------------------------
# The planner slice: the caps sweep, the roofline count and tier 1 on the
# card, at toy sizes (chip_smoke.py's phase 11 runs them at full width).
# ---------------------------------------------------------------------------
@pytest.fixture
def _planner_records(monkeypatch, tmp_path):
    from repro_torch.kernels import tune

    for var in ("REPRO_TORCH_PLANNER_PATH", "REPRO_TORCH_TOPOLOGY_PATH",
                tune.ENV_PATH):
        monkeypatch.setenv(var, str(tmp_path / f"{var}.json"))
    tune.reset()
    yield tmp_path
    tune.reset()


def test_caps_sweep_on_the_card(_planner_records):
    """``tune.autotune`` on the card: one ``spmm_ell`` and one
    ``spmm_ell_t`` launch per forward + backward, a record keyed by the
    card that ``get_config`` then reads."""
    from repro_torch.kernels import spmm_ell, spmm_ell_t, tune

    dev = _card()
    n0, t0 = spmm_ell.launches, spmm_ell_t.launches
    rec = tune.autotune(n_reps=2, device=dev)
    calls = len(tune.CAPS_CANDIDATES) * 3
    assert (spmm_ell.launches - n0, spmm_ell_t.launches - t0) == (calls,
                                                                  calls)
    assert rec["backend"] == "cuda:" + torch.cuda.get_device_name(dev)
    assert tune.get_config()["caps"] == rec["config"]["caps"]


def test_count_work_on_the_card_equals_the_cpu(_planner_records):
    """Each format's layer at the planner's roofline dims counts the same
    ``(flops, bytes)`` on the card as on the CPU, and launches its
    kernels there."""
    from repro_torch.engine import planner
    from repro_torch.kernels import gemm
    from repro_torch.launch.roofline import count_work

    dev = _card()
    stats = planner.GraphStats(n_dst=300, n_src=900, avg_deg=6.0,
                               feat_dim=602)
    dims = planner._roofline_dims(stats)
    for spec in ("ell+pipelined", "block+pipelined", "coo+serial"):
        fmt, layout, x, w = planner.roofline_layer_inputs(spec, dims)
        n0 = gemm.launches
        card = count_work(fmt.layer, layout, x.to(dev), w.to(dev))
        assert gemm.launches - n0 == 1
        assert card == count_work(fmt.layer, layout, x, w), spec


def test_planner_autotune_on_the_card(_planner_records):
    """Tier 1 on the card at toy size: every three-part spec measured,
    first-step losses within 1e-5, a second call measures nothing, and
    ``Engine("auto")`` follows the winner."""
    from repro_torch.engine import Engine, EngineConfig, planner
    from repro_torch.kernels import spmm, spmm_block, spmm_ell

    dev = _card()
    stats = planner.GraphStats(n_dst=64, n_src=256, avg_deg=6.0,
                               feat_dim=32)
    entry = planner.autotune(stats, n_cores=4, n_steps=1, n_trials=2,
                             device=dev)
    assert entry["loss_match"] is True
    assert set(entry["s_per_step"]) == set(entry["candidates"])
    assert entry["backend"] == "cuda:" + torch.cuda.get_device_name(dev)
    before = (spmm.launches, spmm_block.launches, spmm_ell.launches)
    assert planner.autotune(stats, n_cores=4, device=dev) == entry
    assert (spmm.launches, spmm_block.launches, spmm_ell.launches) == before
    assert Engine("auto").resolve(4, graph_stats=stats, device=dev).spec == \
        EngineConfig.from_spec(entry["spec"]).spec


def test_feature_store_trainer_on_the_card_equals_dense():
    """Feature stores at toy size on the card: an mmap store behind a
    hot-vertex cache through the staged chain trains the dense run's
    losses bit for bit with the same ELL launches, and the cache's pinned
    rows live on the card."""
    from repro_torch.featurestore import MmapStore
    from repro_torch.graph import make_dataset
    from repro_torch.kernels import spmm_ell, spmm_ell_t
    from repro_torch.launch.trainer import Trainer

    dev = _card()
    dense = make_dataset("reddit", scale=0.01, feat_dim=16)
    ds = make_dataset("reddit", scale=0.01, feat_dim=16, features="mmap")
    kw = dict(n_cores=4, hidden=16, batch_size=64, seed=0, device=dev)
    runs = []
    try:
        for data, extra in ((dense, {}), (ds, {"cache_capacity": 64})):
            tr = Trainer("ell+pipelined", data, **kw, **extra)
            n0, t0 = spmm_ell.launches, spmm_ell_t.launches
            losses = tr.train_steps(4)
            runs.append((losses, spmm_ell.launches - n0,
                         spmm_ell_t.launches - t0))
            if extra:
                assert isinstance(tr.store, MmapStore)
                rows = tr.cache.device_rows
                assert rows.device.type == "cuda"
                assert torch.equal(rows.cpu(), torch.from_numpy(
                    tr.cache._rows[:tr.cache.n_pinned]))
            tr.close()
    finally:
        ds.features.close()
    assert runs[0] == runs[1] and runs[0][1] == runs[0][2] == 8


@pytest.mark.parametrize("P", [2, 16])
def test_compressed_psum_on_the_card_equals_the_cpu(P):
    """The int8 hypercube all-reduce and two error-feedback steps on the
    card equal the port's CPU run bit for bit (IEEE division, round half
    to even, a separate multiply and add on both)."""
    from repro_torch.distributed import (compressed_psum, ef_compress_grads,
                                         init_error_state)

    dev = _card()
    rng = np.random.default_rng(P)
    x = torch.from_numpy(rng.standard_normal((P, 4096 * P))
                         .astype(np.float32))
    assert torch.equal(compressed_psum(x.to(dev), n_cores=P).cpu(),
                       compressed_psum(x, n_cores=P))
    g = {"w": torch.from_numpy(rng.standard_normal((P, 33, 7))
                               .astype(np.float32))}
    runs = []
    for d in (dev, torch.device("cpu")):
        err = init_error_state({"w": torch.zeros(33, 7, device=d)}, P)
        gd = {"w": g["w"].to(d)}
        for _ in range(2):
            mean, err = ef_compress_grads(gd, err, n_cores=P)
        runs.append((mean["w"].cpu(), err["w"].cpu()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_full_width_lm_train_step_is_finite():
    """One AdamW step of llama3.2-1b at its published config on the card:
    a finite loss and gradient norm, every parameter changed, no
    ``flash_mha`` launch (training runs the materialized attention)."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_batch
    from repro_torch.kernels import flash_mha
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    dev = _card()
    cfg = get_config("llama3.2-1b")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dtype=torch.float32)
    opt = adamw(1e-3)
    state = opt[0](lm.param_tree(params))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in make_lm_batch(0, 0, 2, 64, cfg.vocab).items()}
    before = flash_mha.launches
    new, state, m = lm.train_step_fn(cfg, opt)(params, state, batch)
    assert flash_mha.launches == before
    assert bool(torch.isfinite(m["loss"])) and bool(
        torch.isfinite(m["grad_norm"]))
    assert int(state.step) == 1
    assert not torch.equal(new.layers[0].wq, params.layers[0].wq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,sk,hd,causal,w", [
    (2, 256, 256, 64, True, None),     # causal: the LM's self-attention
    (2, 200, 300, 16, True, None),     # ragged, sq < sk, the smoke hd
    (2, 300, 200, 32, False, None),    # non-causal, sq > sk
    (2, 128, 384, 128, False, None),   # cross-attention: sq < sk
    (3, 256, 256, 128, True, 7),       # a window
    (2, 256, 256, 64, True, 1),        # one key a row
    (2, 333, 129, 64, False, 50),      # rows >= 178 keep no key
])
def test_flash_mha_bwd_kernel_matches_plain(dtype, bh, sq, sk, hd, causal,
                                            w):
    """``flash_mha_bwd`` on the forward kernel's own ``o`` and ``lse``
    (``o`` the bits of a call without ``lse``) against ``mha_bwd_ref``:
    f32 within ``F32_TOL``, bf16 within 1e-2 of the largest gradient; a
    row with no live key gets o and dq 0; one launch a call, counted as
    windowed with a window; autograd through ``flash_mha`` runs it."""
    from repro_torch.kernels import flash_mha, flash_mha_bwd, mha_bwd_ref

    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v = _qkv(sq + sk + hd + (w or 0), bh, sq, sk, hd, dt, dev)
    do = _qkv(1, bh, sq, sq, hd, dt, dev)[0]
    mask = dict(causal=causal, window=w)
    o, lse = flash_mha(q, k, v, q_block=1, k_block=1, return_lse=True,
                       **mask)
    assert torch.equal(o, flash_mha(q, k, v, q_block=1, k_block=1, **mask))
    n0, w0 = flash_mha_bwd.launches, flash_mha_bwd.window_launches
    got = flash_mha_bwd(q, k, v, o, lse, do, **mask)
    torch.cuda.synchronize()
    assert flash_mha_bwd.launches == n0 + 1
    assert flash_mha_bwd.window_launches == w0 + (w is not None)
    want = mha_bwd_ref(q, k, v, o, lse, do, **mask)
    scale = max(float(t.float().abs().max()) for t in want)
    tol = F32_TOL if dtype == "float32" else 1e-2 * scale
    for g, e in zip(got, want):
        assert g.dtype == dt and bool(torch.isfinite(g.float()).all())
        assert float((g.float() - e.float()).abs().max()) <= tol
    dead = torch.isneginf(lse)
    assert not o[dead].any() and not got[0][dead].any()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_mha(*leaves, q_block=1, k_block=1, **mask)
    grads = torch.autograd.grad(out, leaves, do)
    assert flash_mha_bwd.launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(grads, got))


# lengths around the backward's tiles: 64 rows a CTA, swept tiles of 32
# (f32, and bf16 at hd 128) or 64 (bf16)
BWD_LENS = (1, 63, 64, 65, 127, 129, 191)


@pytest.mark.parametrize("mask", ["causal", "full", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_mha_bwd_kernel_tile_edges(hd, dtype, mask):
    """``flash_mha_bwd`` against ``mha_bwd_ref`` for every (sq, sk) of
    ``BWD_LENS``: causal, full, and causal with a window of 40 keys; f32
    within ``F32_TOL`` or 2^-20 of the gradient's largest entry (the
    kernel's tensor-core adds round toward zero: at sk = 1 dV sums up to
    191 unit rows, ~15, in 32-row partials), bf16 within 1e-2 of the
    largest gradient; a row with no live key gets dq 0."""
    from repro_torch.kernels import flash_mha, flash_mha_bwd, mha_bwd_ref

    dev = _card()
    dt = getattr(torch, dtype)
    opts = dict(causal=mask != "full", window=40 if mask == "window" else None)
    for sq in BWD_LENS:
        for sk in BWD_LENS:
            q, k, v = _qkv(sq * 1000 + sk + hd, 2, sq, sk, hd, dt, dev)
            do = _qkv(sq + hd, 2, sq, sq, hd, dt, dev)[0]
            o, lse = flash_mha(q, k, v, q_block=1, k_block=1,
                               return_lse=True, **opts)
            got = flash_mha_bwd(q, k, v, o, lse, do, **opts)
            torch.cuda.synchronize()
            want = mha_bwd_ref(q, k, v, o, lse, do, **opts)
            scale = max(float(t.float().abs().max()) for t in want)
            for name, g, e in zip(("dq", "dk", "dv"), got, want):
                tol = max(F32_TOL, 2.0 ** -20 * float(e.abs().max())) \
                    if dtype == "float32" else 1e-2 * scale
                assert g.dtype == dt and bool(torch.isfinite(g.float()).all())
                err = float((g.float() - e.float()).abs().max())
                assert err <= tol, (sq, sk, name, err, tol)
            assert not got[0][torch.isneginf(lse)].any(), (sq, sk)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_mha_bwd_kernel_bf16_as_far_from_float64_as_plain(hd, causal):
    """In bf16 the kernel computes the plain version's function: dS stays
    f32-exact in dQ and dK (split into two bf16 terms), p is rounded to
    bf16 for dV as both round it.  Each of dq, dk and dv lies within 1.2×
    the plain bf16 version's L2 distance from a float64 backward on the
    same inputs; dS rounded to bf16 puts dq and dk ~1.4× as far (a numpy
    model of both at these shapes: 1.38-1.60×, the split 1.00×)."""
    from repro_torch.kernels import flash_mha, flash_mha_bwd, mha_bwd_ref

    dev = _card()
    q, k, v = _qkv(hd + 11, 2, 256, 256, hd, torch.bfloat16, dev)
    do = _qkv(hd + 12, 2, 256, 256, hd, torch.bfloat16, dev)[0]
    o, lse = flash_mha(q, k, v, q_block=1, k_block=1, return_lse=True,
                       causal=causal)
    got = flash_mha_bwd(q, k, v, o, lse, do, causal=causal)
    plain = mha_bwd_ref(q, k, v, o, lse, do, causal=causal)
    exact = mha_bwd_ref(*(t.double() for t in (q, k, v, o)), lse,
                        do.double(), causal=causal)
    for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        dist = float((g.double() - e).norm())
        limit = 1.2 * float((p.double() - e).norm())
        assert dist <= limit, (name, dist, limit)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,w", [(64, None), (128, 300)])
def test_flash_mha_bwd_kernel_two_calls_same_bits(hd, w, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    from repro_torch.kernels import flash_mha, flash_mha_bwd

    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v = _qkv(hd + 5, 4, 1000, 1000, hd, dt, dev)
    do = _qkv(hd + 6, 4, 1000, 1000, hd, dt, dev)[0]
    o, lse = flash_mha(q, k, v, q_block=1, k_block=1, return_lse=True,
                       window=w)
    first = flash_mha_bwd(q, k, v, o, lse, do, window=w)
    second = flash_mha_bwd(q, k, v, o, lse, do, window=w)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
