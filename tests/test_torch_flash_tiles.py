"""``flash_mha``'s CUDA kernel, checked on the CPU through the test's own
copy of its arithmetic (the kernel itself runs only on the card).

* Schedule: the grid's query-tile order, the causal key-tile count, the
  window's first key tile and the per-warp skips of ``csrc/flash_mha.cu``
  (copied here; the tile constants are read from the source) visit every
  live (b, row, key) pair exactly once and compute no tile with nothing
  live, for ragged sq and sk, sq < sk and sq > sk, with and without a
  sliding window (w below, at and above a key tile); tiles that skip the
  mask hold only live pairs.
* The backward's two sweeps (``csrc/flash_mha_bwd.cu``; its tile lines
  are checked against the test's copy): for every (CTA rows, swept rows)
  the kernel builds, the dQ kernel's key tiles for each query tile and the
  dK / dV kernel's query tiles for each key tile, each consumer warpgroup
  skipping a tile it has nothing live in, visit every live (b, row, key)
  pair exactly once and no tile with nothing live (but a query tile whose
  rows all lie past sk + w - 1), causal or not, with a window or not,
  ragged, sq < sk and sq > sk; f32's k-slot order (the S accumulator as
  the tf32 A fragment, the transposed planes' rows to match) pairs each
  swept row once.
* Rounding: the kernel's TF32 rounding, ``(bits + 0x1000) & 0xffffe000``,
  rounds known bit patterns as PTX's ``cvt.rna.tf32.f32`` specifies (to
  nearest, ties away from zero).
* Arithmetic: attention with every f32 product split into three TF32
  products (hi·hi + hi·lo + lo·hi) on that rounding is within 2e-6 of a
  float64 attention at the f32 shapes of ``chip_smoke.FLASH_EDGES``, and
  within ``FLASH_TOL`` (1e-5) of the port's plain ``mha_ref`` and of the
  reference's Pallas ``flash_mha`` (interpret mode); a single TF32 product
  is not, which is why the kernel splits.
* The backward's arithmetic: a numpy model of the kernel's f32 wgmma (3
  TF32 products on that rounding, each 8-term step added toward zero as
  the tensor cores add, S and dP in fresh fragments of 2 k steps, each
  swept tile's partial fresh and joined in an f32 add) keeps dq, dk and
  dv within chip_smoke's float64 gate (``BWD_F64_FACTOR`` × the plain f32
  version's L2 distance) at the f32 ``BWD_EDGES`` cut to a quarter; one
  TF32 product misses it by far, and so, at hd 128, do S and dP in one
  accumulator each.
"""
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash import flash_mha as ref_flash_mha  # noqa: E402
from repro_torch.kernels import flash as port_flash  # noqa: E402
from repro_torch.kernels import mha_bwd_ref, mha_ref  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

SOURCE = (port_flash._build.CSRC / "flash_mha.cu").read_text()
BWD_SOURCE = (port_flash._build.CSRC / "flash_mha_bwd.cu").read_text()


def _constant(name: str, source: str = SOURCE) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


WARPS = _constant("kWarps")
BK = _constant("BK")
BQ = 16 * WARPS                 # the kernel's BQ: 16 query rows a warp
SPLIT_TOL = 2e-6                # split product vs float64 (plain f32: 1e-6)


def test_tile_constants_match_the_wrapper():
    assert "constexpr int BQ = 16 * kWarps;" in SOURCE
    assert port_flash._TILE == BQ


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------
def kernel_cover(bh, sq, sk, causal, window=0):
    """(count of visits per (b, row, key) over written rows, each CTA's key
    tile count in launch order), as the kernel schedules them (``window``
    0: none, as the kernel's argument)."""
    nq = -(-sq // BQ)
    cover = np.zeros((bh, sq, sk), np.int64)
    counts = []
    for x in range(nq * bh):
        qt, b = nq - 1 - x // bh, x % bh
        q0 = qt * BQ
        q_last = min(q0 + BQ, sq) - 1
        n_kt = -(-sk // BK)
        if causal:
            n_kt = min(n_kt, q_last // BK + 1)
        kt0 = max(0, q0 - window + 1) // BK if window > 0 else 0
        counts.append(n_kt - kt0)
        for w in range(WARPS):
            w0 = q0 + 16 * w
            w_last = min(w0 + 15, sq - 1)
            for kt in range(kt0, n_kt):
                k0 = kt * BK
                if w_last < w0 or (causal and k0 > w_last) or (
                        window > 0 and k0 + BK - 1 < w0 - window + 1):
                    continue                        # the warp's skip
                rows = np.arange(w0, w0 + 16)[:, None]
                cols = np.arange(k0, k0 + BK)[None, :]
                live = (rows < sq) & (cols < sk) & ((cols <= rows)
                                                    | (not causal))
                if window > 0:
                    live &= rows - cols < window
                # no dead tile computed, but by a warp none of whose rows
                # has a key (all past sk + w - 1: sq > sk with a window)
                assert live.any() or (window > 0
                                      and w0 >= sk + window - 1), (b, w0, k0)
                edge = (causal and k0 + BK - 1 > w0) or k0 + BK > sk or (
                    window > 0 and w0 + 15 - window + 1 > k0)
                if edge:
                    taken = live
                else:                               # no mask evaluated
                    taken = np.broadcast_to(rows < sq, live.shape)
                    assert (taken == live).all(), (b, w0, k0)
                r, c = np.nonzero(taken)
                cover[b, w0 + r, k0 + c] += 1
    return cover, counts


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,sk", [
    (2, 128, 128),          # one query tile, two key tiles
    (2, 300, 200),          # ragged both, sq > sk
    (1, 200, 700),          # ragged both, sq < sk
    (3, 129, 65),           # one row / one key past a tile
    (1, 1000, 1000),        # many tiles, ragged
    (2, 16, 1),             # one warp's rows, one key
    (1, 1, 300),            # one row
])
def test_schedule_visits_every_live_pair_once(bh, sq, sk, causal):
    cover, counts = kernel_cover(bh, sq, sk, causal)
    rows = np.arange(sq)[:, None]
    cols = np.arange(sk)[None, :]
    want = np.broadcast_to((cols <= rows) | (not causal), (bh, sq, sk))
    np.testing.assert_array_equal(cover, want.astype(np.int64))
    if causal:              # the heaviest query tiles launch first
        assert counts == sorted(counts, reverse=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 7, 16, 64, 65, 200, 5000])
@pytest.mark.parametrize("bh,sq,sk", [
    (1, 1000, 1000),        # many tiles, ragged
    (2, 300, 200),          # sq > sk: rows past sk + w - 1 have no key
    (1, 200, 700),          # sq < sk
    (1, 129, 65),
])
def test_windowed_schedule_visits_every_live_pair_once(bh, sq, sk, window,
                                                       causal):
    cover, counts = kernel_cover(bh, sq, sk, causal, window)
    rows = np.arange(sq)[:, None]
    cols = np.arange(sk)[None, :]
    live = (rows - cols < window) & ((cols <= rows) | (not causal))
    np.testing.assert_array_equal(
        cover, np.broadcast_to(live, (bh, sq, sk)).astype(np.int64))
    # the band skips the key tiles below it: with w <= one key tile a
    # causal CTA sweeps at most the tiles its 128 rows and the band span
    if causal and window <= BK:
        assert max(counts) <= -(-(BQ + window) // BK) + 1


# ---------------------------------------------------------------------------
# the backward's sweeps
# ---------------------------------------------------------------------------
BWD_BQ = _constant("BQ", BWD_SOURCE)        # fixed rows a consumer


def bwd_tiles(f32: bool, hd: int):
    """(fixed rows a CTA, rows a swept tile) of ``csrc/flash_mha_bwd.cu``'s
    ``Cfg`` (its lines are checked in ``test_bwd_sweeps_match_the_source``):
    two consumer warpgroups of ``BWD_BQ`` rows, one past hd 64; swept
    tiles of 32 rows in f32 and past hd 64, else 64."""
    return BWD_BQ * (1 if hd > 64 else 2), 32 if f32 or hd > 64 else 64


# every (fixed rows a CTA, swept rows) the kernel builds
BWD_CONFIGS = sorted({bwd_tiles(f32, hd) for f32 in (True, False)
                      for hd in port_flash.HEAD_DIMS})


def _live(sq, sk, causal, window, rows=None, cols=None):
    rows = np.arange(sq)[:, None] if rows is None else rows
    cols = np.arange(sk)[None, :] if cols is None else cols
    live = (rows < sq) & (cols < sk) & ((cols <= rows) | (not causal))
    if window > 0:
        live &= rows - cols < window
    return live


def bwd_cover(sq, sk, causal, window=0, rows=128, bn=32):
    """Visits per (row, key) of the dQ sweep and of the dK / dV sweep, as
    ``dq_kernel`` and ``dkv_kernel`` schedule them (one head: the sweeps
    do not depend on b; ``window`` 0: none): each CTA's fixed ``rows`` in
    consumers of ``BWD_BQ``, swept tiles of ``bn``, a consumer skipping a
    tile it has nothing live in."""
    nq, nk = -(-sq // rows), -(-sk // rows)
    by_q = np.zeros((sq, sk), np.int64)
    for x in range(nq):
        q0 = (nq - 1 - x) * rows
        q_last = min(q0 + rows, sq) - 1
        kt0 = max(0, q0 - window + 1) // bn if window > 0 else 0
        kt1 = min(-(-sk // bn), q_last // bn + 1) if causal else -(-sk // bn)
        for kt in range(kt0, kt1):
            k0 = kt * bn
            cols = np.arange(k0, k0 + bn)[None, :]
            tile = _live(sq, sk, causal, window,
                         np.arange(q0, q0 + rows)[:, None], cols)
            # none dead, but in a tile none of whose rows has a key (all
            # past sk + w - 1: sq > sk with a window)
            assert tile.any() or (window > 0 and q0 >= sk + window - 1), \
                ("dq sweep", q0, k0)
            for r0 in range(q0, q0 + rows, BWD_BQ):
                live = _live(sq, sk, causal, window,
                             np.arange(r0, r0 + BWD_BQ)[:, None], cols)
                idle = r0 >= sq or (causal and k0 > r0 + BWD_BQ - 1) or (
                    window > 0 and r0 - (k0 + bn - 1) >= window)
                if idle:                            # the consumer's skip
                    assert not live.any(), ("dq skip", r0, k0)
                    continue
                r, c = np.nonzero(live)
                by_q[r0 + r, k0 + c] += 1
    by_k = np.zeros((sq, sk), np.int64)
    for kt in range(nk):
        k0 = kt * rows
        k_last = min(k0 + rows, sk) - 1
        qt0 = min(-(-sq // bn), k0 // bn) if causal else 0
        qt1 = min(-(-sq // bn), (k_last + window - 1) // bn + 1) \
            if window > 0 else -(-sq // bn)
        for qt in range(qt0, qt1):
            i0 = qt * bn
            qrows = np.arange(i0, i0 + bn)[:, None]
            tile = _live(sq, sk, causal, window, qrows,
                         np.arange(k0, k0 + rows)[None, :])
            assert tile.any(), ("dk/dv sweep", i0, k0)
            for kc0 in range(k0, k0 + rows, BWD_BQ):
                live = _live(sq, sk, causal, window, qrows,
                             np.arange(kc0, kc0 + BWD_BQ)[None, :])
                idle = kc0 >= sk or (causal and i0 + bn - 1 < kc0) or (
                    window > 0 and i0 - (kc0 + BWD_BQ - 1) >= window)
                if idle:
                    assert not live.any(), ("dk/dv skip", i0, kc0)
                    continue
                r, c = np.nonzero(live)
                by_k[i0 + r, kc0 + c] += 1
    return by_q, by_k


def test_bwd_sweeps_match_the_source():
    assert BWD_BQ == port_flash._BWD_TILE      # the smallest CTA (hd 128)
    for line in (
            "static constexpr int NC = HD > 64 ? 1 : 2;",
            "static constexpr int ROWS = BQ * NC;",
            "static constexpr int BN = f32 || HD > 64 ? 32 : 64;",
            "max(0, q0 - window + 1) / BN",
            "causal ? min(nk, q_last / BN + 1) : nk",
            "causal ? min(nq, k0 / BN) : 0",
            "(static_cast<long long>(k_last) + window - 1) / BN",
            "r0 >= sq || (causal && k0 > r0 + BQ - 1) ||",
            "(window > 0 && r0 - (k0 + BN - 1) >= window)",
            "kc0 >= sk || (causal && i0 + BN - 1 < kc0) ||",
            "(window > 0 && i0 - (kc0 + BQ - 1) >= window)"):
        assert line in BWD_SOURCE, line


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 7, 64, 65, 200])
@pytest.mark.parametrize("sq,sk", [
    (256, 256),             # whole tiles
    (300, 200),             # ragged, sq > sk: rows past sk + w - 1 keyless
    (200, 700),             # ragged, sq < sk
    (129, 65),              # one row / one key past a tile
    (1, 130),               # one row
])
def test_bwd_sweeps_visit_every_live_pair_once(sq, sk, causal, window):
    want = _live(sq, sk, causal, window).astype(np.int64)
    for rows, bn in BWD_CONFIGS:
        by_q, by_k = bwd_cover(sq, sk, causal, window, rows, bn)
        np.testing.assert_array_equal(by_q, want, err_msg=f"{rows} {bn}")
        np.testing.assert_array_equal(by_k, want, err_msg=f"{rows} {bn}")


def test_bwd_k_slots_pair_each_swept_row_once():
    """f32's d-side products take the S / dP accumulator as the tf32 A
    fragment as it stands: a[0..3] of k step kk are columns 8kk + 2t,
    8kk + 2t, 8kk + 2t + 1, 8kk + 2t + 1 (rows g, g + 8, g, g + 8) in k
    slots t, t, t + 4, t + 4.  ``planes_t`` puts swept row 8j + u in k
    chunk 2j + u % 2 at slot u / 2 of the transposed planes; the two must
    name the same row for every (k step, slot), each row once."""
    assert "split(x[4 * kk], hi[kk][0], lo[kk][0]);" in BWD_SOURCE
    assert "split(x[4 * kk + 2], hi[kk][1], lo[kk][1]);" in BWD_SOURCE
    assert "split(x[4 * kk + 1], hi[kk][2], lo[kk][2]);" in BWD_SOURCE
    assert "split(x[4 * kk + 3], hi[kk][3], lo[kk][3]);" in BWD_SOURCE
    assert "const int base = (2 * j + (u & 1)) * TLBO + (u >> 1) * 4;" \
        in BWD_SOURCE
    for bn in sorted({bn for _, bn in BWD_CONFIGS}):
        b_side = {}                 # (k step, slot) -> swept row, planes_t
        for row in range(bn):
            j, u = divmod(row, 8)
            chunk, pos = 2 * j + u % 2, u // 2
            b_side[(chunk // 2, 4 * (chunk % 2) + pos)] = row
        a_side = {}                 # (k step, slot) -> accumulator column
        for kk in range(bn // 8):
            for t in range(4):
                for i, e in enumerate((0, 2, 1, 3)):   # a[i] = x[4kk + e]
                    col = 8 * kk + 2 * t + (e & 1)
                    slot = t + 4 * (i >> 1)
                    assert a_side.setdefault((kk, slot), col) == col
        assert len(b_side) == len(a_side) == bn
        assert b_side == a_side
        assert sorted(b_side.values()) == list(range(bn))


# ---------------------------------------------------------------------------
# rounding
# ---------------------------------------------------------------------------
def tf32_rna(x: np.ndarray) -> np.ndarray:
    """The kernel's ``tf32_rna``: f32 to TF32, to nearest, ties away from
    zero (PTX ``cvt.rna.tf32.f32`` for finite inputs)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def test_kernel_rounds_as_the_copy():
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in SOURCE
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in BWD_SOURCE


@pytest.mark.parametrize("bits,want", [
    (0x3f800000, 0x3f800000),   # 1.0: exact
    (0x3f800fff, 0x3f800000),   # just below half an ulp: down
    (0x3f801000, 0x3f802000),   # a tie to an even neighbour: away, not even
    (0x3f803000, 0x3f804000),   # a tie to an odd neighbour: away
    (0xbf801000, 0xbf802000),   # a negative tie: away from zero
    (0x3f801001, 0x3f802000),   # above half an ulp: up
    (0x3ffff000, 0x40000000),   # a tie that carries into the exponent: 2.0
    (0x00001000, 0x00002000),   # a subnormal tie
    (0x00000fff, 0x00000000),   # a subnormal below half: to +0
    (0x80000fff, 0x80000000),   # ... and to -0
    (0x7f7ff000, 0x7f800000),   # a tie past the largest TF32: inf
    (0x7f800000, 0x7f800000),   # inf stays inf
    (0xff800000, 0xff800000),
])
def test_tf32_rna_rounds_known_bit_patterns(bits, want):
    got = tf32_rna(np.array([bits], np.uint32).view(np.float32))
    assert int(got.view(np.uint32)[0]) == want


def split(x: np.ndarray):
    """The kernel's ``split``: x = hi + lo, both TF32, as float64."""
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    return hi.astype(np.float64), lo.astype(np.float64)


def test_split_keeps_22_bits():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    x *= np.float32(2.0) ** np.arange(-20, 20, 10, dtype=np.float32).repeat(
        1024)
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.astype(np.float32).view(np.uint32) & 0x1fff).any()
    rel = np.abs(hi + lo - x.astype(np.float64)) / np.abs(x)
    assert rel.max() <= 2.0 ** -22


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------
def product(a: np.ndarray, b: np.ndarray, terms: int) -> np.ndarray:
    """a @ b with both f32 operands split (``terms`` 3: lo·hi + hi·lo +
    hi·hi, as the kernel; 1: hi·hi, one TF32 product), summed exactly."""
    ah, al = split(a)
    bh, bl = split(b)
    out = ah @ bh
    if terms == 3:
        out += al @ bh + ah @ bl
    return out


def tf32_attention(q, k, v, causal, terms=3):
    """The kernel's arithmetic on f32 numpy q [bh, sq, hd], k/v [bh, sk,
    hd]: split products, f32 logits, p = exp(logit - max) rounded to f32,
    o = (p v) / Σ p."""
    sq, hd = q.shape[1:]
    sk = k.shape[1]
    s = product(q, k.transpose(0, 2, 1), terms).astype(np.float32)
    logits = s.astype(np.float64) / np.sqrt(hd)
    if causal:
        logits[:, np.arange(sk)[None, :] > np.arange(sq)[:, None]] = -np.inf
    p = np.exp(logits - logits.max(-1, keepdims=True)).astype(np.float32)
    o = product(p, v, terms) / p.astype(np.float64).sum(-1, keepdims=True)
    return o.astype(np.float32)


F32_EDGES = [e for e in chip_smoke.FLASH_EDGES if e[-1] == "float32"]


@pytest.fixture(scope="module")
def edge_results():
    """Per f32 edge: q, k, v, the split and single-product emulations and
    a float64 attention."""
    out = {}
    for bh, sq, sk, hd, qb, kb, causal, _ in F32_EDGES:
        rng = np.random.default_rng(sq + sk + hd)
        q, k, v = (rng.standard_normal((bh, n, hd)).astype(np.float32)
                   for n in (sq, sk, sk))
        f64 = mha_ref(*(torch.from_numpy(t).double() for t in (q, k, v)),
                      causal=causal, q_block=qb).numpy()
        out[(bh, sq, sk, hd, qb, kb, causal)] = dict(
            qkv=(q, k, v), f64=f64, split=tf32_attention(q, k, v, causal),
            single=tf32_attention(q, k, v, causal, terms=1))
    return out


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("edge", [e[:-1] for e in F32_EDGES],
                         ids=lambda e: "bh{}_sq{}_sk{}_hd{}_qb{}_kb{}_{}"
                         .format(*e[:6], "causal" if e[6] else "full"))
def test_split_attention_matches_float64_and_references(edge, edge_results):
    bh, sq, sk, hd, qb, kb, causal = edge
    r = edge_results[edge]
    q, k, v = r["qkv"]
    assert _err(r["split"], r["f64"]) <= SPLIT_TOL
    plain = mha_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                    causal=causal, q_block=qb).numpy()
    assert _err(r["split"], plain) <= chip_smoke.FLASH_TOL
    if (sq // qb) * (sk // kb) > 64:        # the ragged case's tiny blocks
        qb, kb = sq, sk                     # interpret one step per head
    jax_out = ref_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, q_block=qb, k_block=kb,
                            interpret=True)
    assert _err(r["split"], np.asarray(jax_out)) <= chip_smoke.FLASH_TOL


def test_single_tf32_product_misses_the_gate(edge_results):
    worst = max(_err(r["single"], r["f64"]) for r in edge_results.values())
    assert worst > chip_smoke.FLASH_TOL
    best_split = max(_err(r["split"], r["f64"])
                     for r in edge_results.values())
    assert worst > 10 * best_split


# ---------------------------------------------------------------------------
# the backward's arithmetic
# ---------------------------------------------------------------------------
def rz_f32(x: np.ndarray) -> np.ndarray:
    """float64 x to f32 rounding toward zero: the tensor cores' add into
    their accumulator (flash_mha.cu: up to an ulp, always of one sign)."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def tc_product(a, b, terms=3, group=None):
    """a [M, K] @ b [K, N] as the kernel's wgmma: K in steps of 8, each
    step lo·hi', hi·lo', hi·hi' (``terms`` 3; hi·hi' alone for 1), each
    wgmma's 8-term sum exact and added to its f32 accumulator rounding
    toward zero.  ``group`` k steps sum in a fresh fragment that joins the
    result in a round-to-nearest f32 add (``qk2_f32``); ``None``: one
    fresh accumulator for all of K (a d-side partial)."""
    pad = -a.shape[1] % 8                  # a ragged tile's zero rows
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, pad), (0, 0)))
    ah, al = split(a)
    bh, bl = split(b)
    steps = a.shape[1] // 8
    group = group or steps
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for g0 in range(0, steps, group):
        frag = np.zeros_like(out)
        for kk in range(g0, min(g0 + group, steps)):
            s = slice(8 * kk, 8 * kk + 8)
            parts = ((al, bh), (ah, bl), (ah, bh)) if terms == 3 \
                else ((ah, bh),)
            for x, y in parts:
                frag = rz_f32(frag.astype(np.float64) + x[:, s] @ y[s])
        out = frag if g0 == 0 else out + frag
    return out


def model_bwd(q, k, v, o, lse, do, causal, window, terms=3, s_group=2,
              fma_delta=False):
    """``csrc/flash_mha_bwd.cu``'s f32 arithmetic on numpy [bh, s, hd]:
    S and dP as ``tc_product`` in fresh fragments of 2 k steps, δ as the
    diagonal of the same products (``delta_kernel``: dO oᵀ for the dQ
    sweep, o dOᵀ for the dK / dV sweep, as dP and dPᵀ take them), p =
    2^(s · scale · log2 e - lse2) in f32, dS = p (dP - δ); dQ over key
    tiles and dK, dV over query tiles of the kernel's swept rows, each
    tile's partial fresh (``tc_product``) and joined to the running sum in
    an f32 add; dQ and dK times scale at the end; rows with no live key
    give dV 1 / sk of their dO (``dead_dv_kernel``).  ``fma_delta``: δ
    as plain f32 sums instead (the kernel before ``delta_kernel``)."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
    bn = bwd_tiles(True, hd)[1]
    w = window or 0
    scale = np.float32(1 / np.sqrt(hd))
    sl2 = np.float32(1 / np.sqrt(hd) * 1.4426950408889634)
    def diag(a, b):
        return np.array([tc_product(a[i:i + 1], b[i:i + 1].T, terms,
                                    s_group)[0, 0] for i in range(len(a))],
                        np.float32)

    m = np.where(np.isneginf(lse), np.float32(np.inf), lse).astype(
        np.float32)
    dq, dk, dv = (np.zeros_like(x) for x in (q, k, v))

    def probs(s, dp, rows, cols, d_rows, side):
        p = np.exp2(s * sl2 - m[b, rows][:, None]).astype(np.float32)
        p[~_live(sq, sk, causal, w, rows[:, None], cols[None, :])] = 0
        return p, p * (dp - delta[side][d_rows][:, None])

    for b in range(bh):
        if fma_delta:
            fma = (do[b].astype(np.float64) * o[b]).sum(-1).astype(np.float32)
            delta = {"q": fma, "kv": fma}
        else:
            delta = {"q": diag(do[b], o[b]), "kv": diag(o[b], do[b])}
        rows = np.arange(sq)
        acc = np.zeros((sq, hd), np.float32)
        for k0 in range(0, sk, bn):
            keys = np.arange(k0, min(k0 + bn, sk))
            s = tc_product(q[b], k[b, keys].T, terms, s_group)
            dp = tc_product(do[b], v[b, keys].T, terms, s_group)
            _, ds = probs(s, dp, rows, keys, rows, "q")
            acc = acc + tc_product(ds, k[b, keys], terms)
        dq[b] = acc * scale
        keys = np.arange(sk)
        adk = np.zeros((sk, hd), np.float32)
        adv = np.zeros_like(adk)
        for i0 in range(0, sq, bn):
            qs = np.arange(i0, min(i0 + bn, sq))
            st = tc_product(k[b], q[b, qs].T, terms, s_group)
            dpt = tc_product(v[b], do[b, qs].T, terms, s_group)
            p, ds = probs(st.T, dpt.T, qs, keys, qs, "kv")
            adv = adv + tc_product(p.T, do[b, qs], terms)
            adk = adk + tc_product(ds.T, q[b, qs], terms)
        if w and sk - 1 + w < sq:       # dead rows: 1 / sk of their dO
            adv = adv + do[b, sk - 1 + w:].sum(0, dtype=np.float32) / \
                np.float32(sk)
        dv[b], dk[b] = adv, adk * scale
    return dq, dk, dv


def _bwd_model_edge(edge):
    """chip_smoke's f32 ``BWD_EDGES`` cut to one head and a quarter of the
    rows (windows of 150 or more a quarter too)."""
    _, sq, sk, hd, causal, w, _ = edge
    return (1, sq // 4, sk // 4, hd, causal,
            w if w is None or w < 150 else w // 4)


BWD_MODEL_EDGES = [_bwd_model_edge(e) for e in chip_smoke.BWD_EDGES
                   if e[-1] == "float32"]


@pytest.fixture(scope="module")
def bwd_model_results():
    """Per edge: each of dq, dk, dv's L2 distance from a float64 backward
    over chip_smoke's limit (``BWD_F64_FACTOR`` × the plain f32 version's
    own distance, or ``BWD_F64_FLOOR`` of the float64 gradient's norm),
    for the kernel's split arithmetic (3), for one TF32 product (1) and
    for S and dP in one accumulator each ("one accumulator")."""
    out = {}
    for edge in BWD_MODEL_EDGES:
        bh, sq, sk, hd, causal, w = edge
        rng = np.random.default_rng(sq + sk + hd)
        q, k, v, do = (rng.standard_normal((bh, n, hd)).astype(np.float32)
                       for n in (sq, sk, sk, sq))
        mask = dict(causal=causal, window=w)
        tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
        po, plse = mha_ref(tq, tk, tv, return_lse=True, **mask)
        plain = mha_bwd_ref(tq, tk, tv, po, plse, tdo, **mask)
        wide = [t.double() for t in (tq, tk, tv, tdo)]
        o64, lse64 = mha_ref(*wide[:3], return_lse=True, **mask)
        exact = mha_bwd_ref(*wide[:3], o64, lse64, wide[3], **mask)
        ratios = {}
        for variant, terms, group in ((3, 3, 2), (1, 1, 2),
                                      ("one accumulator", 3, None)):
            got = model_bwd(q, k, v, po.numpy(), plse.numpy(), do, causal,
                            w, terms, group)
            ratios[variant] = []
            for g, p, e in zip(got, plain, exact):
                own = float(torch.linalg.vector_norm(p.double() - e))
                limit = max(chip_smoke.BWD_F64_FACTOR * own,
                            chip_smoke.BWD_F64_FLOOR
                            * float(torch.linalg.vector_norm(e)))
                ratios[variant].append(float(torch.linalg.vector_norm(
                    torch.from_numpy(g).double() - e)) / limit)
        out[edge] = ratios
    return out


@pytest.mark.parametrize("edge", BWD_MODEL_EDGES,
                         ids=lambda e: "sq{}_sk{}_hd{}_{}_w{}".format(
                             *e[1:4], "causal" if e[4] else "full", e[5]))
def test_bwd_split_arithmetic_within_the_float64_gate(edge,
                                                      bwd_model_results):
    assert max(bwd_model_results[edge][3]) <= 1.0


def test_bwd_single_tf32_product_misses_the_float64_gate(bwd_model_results):
    single = [max(r[1]) for r in bwd_model_results.values()]
    split_worst = max(max(r[3]) for r in bwd_model_results.values())
    assert min(single) > 1.0 and min(single) > 10 * split_worst


def test_bwd_s_in_one_accumulator_misses_the_float64_gate_at_hd_128(
        bwd_model_results):
    """Why ``qk2_f32`` sums S and dP in fresh fragments: taking all 48
    tensor-core adds of an hd-128 product in one accumulator leaves some
    gradient past the gate."""
    worst = max(max(r["one accumulator"])
                for e, r in bwd_model_results.items() if e[3] == 128)
    assert worst > 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_delta_from_dp_products_cancels_at_one_key(causal):
    """At sk = 1 every row's p is 1 and the forward's o is v_hi + v_lo,
    which splits as v does, so dS = dP − δ is 0 in exact arithmetic and dK
    is what rounding leaves.  With δ from the same split products as dP
    (``delta_kernel``) it cancels, and the model's dK at hd 80, sq 191
    sits under the card test's limit (``test_torch_gpu.py::
    test_flash_mha_bwd_kernel_tile_edges``: 1e-5 or 2^-20 of the largest
    entry); δ in plain f32 sums put it over (1.19e-5, the card read
    1.22e-5)."""
    hd, sq = 80, 191
    rng = np.random.default_rng(sq * 1000 + 1 + hd)   # the card test's
    q = rng.standard_normal((2, sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, 1, hd)).astype(np.float32)
            for _ in range(2))
    do = np.random.default_rng(sq + hd).standard_normal(
        (2, sq, hd)).astype(np.float32)
    vh, vl = split(v)
    o = np.broadcast_to((vh + vl).astype(np.float32), q.shape).copy()
    tq, tk, tv, to, tdo = (torch.from_numpy(x) for x in (q, k, v, o, do))
    _, lse = mha_ref(tq, tk, tv, causal=causal, return_lse=True)
    want = mha_bwd_ref(tq, tk, tv, to, lse, tdo, causal=causal)[1].numpy()
    limit = max(1e-5, 2.0 ** -20 * float(np.abs(want).max()))
    errs = [float(np.abs(model_bwd(q, k, v, o, lse.numpy(), do, causal, None,
                                   fma_delta=f)[1] - want).max())
            for f in (False, True)]
    assert errs[0] <= 0.8 * limit < limit < errs[1]
