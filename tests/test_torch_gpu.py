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
