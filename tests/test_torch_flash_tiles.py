"""``flash_mha``'s CUDA kernel, checked on the CPU through the test's own
copy of its arithmetic (the kernel itself runs only on the card).

* Schedule: the grid's query-tile order, the causal key-tile count, the
  window's first key tile and the per-warp skips of ``csrc/flash_mha.cu``
  (copied here; the tile constants are read from the source) visit every
  live (b, row, key) pair exactly once and compute no tile with nothing
  live, for ragged sq and sk, sq < sk and sq > sk, with and without a
  sliding window (w below, at and above a key tile); tiles that skip the
  mask hold only live pairs.
* The backward's two sweeps (``csrc/flash_mha_bwd.cu``, tile constants
  read from the source): the dQ kernel's key tiles for each query tile
  and the dK / dV kernel's query tiles for each key tile each visit every
  live (b, row, key) pair exactly once and no tile with nothing live (but
  a query tile whose rows all lie past sk + w - 1), causal or not, with a
  window or not, ragged, sq < sk and sq > sk.
* Rounding: the kernel's TF32 rounding, ``(bits + 0x1000) & 0xffffe000``,
  rounds known bit patterns as PTX's ``cvt.rna.tf32.f32`` specifies (to
  nearest, ties away from zero).
* Arithmetic: attention with every f32 product split into three TF32
  products (hi·hi + hi·lo + lo·hi) on that rounding is within 2e-6 of a
  float64 attention at the f32 shapes of ``chip_smoke.FLASH_EDGES``, and
  within ``FLASH_TOL`` (1e-5) of the port's plain ``mha_ref`` and of the
  reference's Pallas ``flash_mha`` (interpret mode); a single TF32 product
  is not, which is why the kernel splits.
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
from repro_torch.kernels import mha_ref  # noqa: E402

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
BWD_BQ = _constant("BQ", BWD_SOURCE)
BWD_BKV = _constant("BKV", BWD_SOURCE)


def _live(sq, sk, causal, window, rows=None, cols=None):
    rows = np.arange(sq)[:, None] if rows is None else rows
    cols = np.arange(sk)[None, :] if cols is None else cols
    live = (rows < sq) & (cols < sk) & ((cols <= rows) | (not causal))
    if window > 0:
        live &= rows - cols < window
    return live


def bwd_cover(sq, sk, causal, window=0):
    """Visits per (row, key) of the dQ sweep and of the dK / dV sweep, as
    ``dq_kernel`` and ``dkv_kernel`` schedule them (one head: the sweeps
    do not depend on b; ``window`` 0: none)."""
    nq, nk = -(-sq // BWD_BQ), -(-sk // BWD_BKV)
    by_q = np.zeros((sq, sk), np.int64)
    for x in range(nq):
        qt = nq - 1 - x
        q0 = qt * BWD_BQ
        q_last = min(q0 + BWD_BQ, sq) - 1
        kt0 = max(0, q0 - window + 1) // BWD_BKV if window > 0 else 0
        kt1 = min(nk, q_last // BWD_BKV + 1) if causal else nk
        for kt in range(kt0, kt1):
            k0 = kt * BWD_BKV
            rows = np.arange(q0, q0 + BWD_BQ)[:, None]
            cols = np.arange(k0, k0 + BWD_BKV)[None, :]
            live = _live(sq, sk, causal, window, rows, cols)
            # none dead, but in a tile none of whose rows has a key (all
            # past sk + w - 1: sq > sk with a window)
            assert live.any() or (window > 0 and q0 >= sk + window - 1), \
                ("dq sweep", q0, k0)
            r, c = np.nonzero(live)
            by_q[q0 + r, k0 + c] += 1
    by_k = np.zeros((sq, sk), np.int64)
    for kt in range(nk):
        k0 = kt * BWD_BKV
        k_last = min(k0 + BWD_BKV, sk) - 1
        qt0 = min(nq, k0 // BWD_BQ) if causal else 0
        qt1 = min(nq, (k_last + window - 1) // BWD_BQ + 1) if window > 0 \
            else nq
        for qt in range(qt0, qt1):
            q0 = qt * BWD_BQ
            rows = np.arange(q0, q0 + BWD_BQ)[:, None]
            cols = np.arange(k0, k0 + BWD_BKV)[None, :]
            live = _live(sq, sk, causal, window, rows, cols)
            assert live.any(), ("dk/dv sweep", q0, k0)
            r, c = np.nonzero(live)
            by_k[q0 + r, k0 + c] += 1
    return by_q, by_k


def test_bwd_sweeps_match_the_source():
    assert BWD_BQ == BWD_BKV == port_flash._BWD_TILE
    assert "max(0, q0 - window + 1) / BKV" in BWD_SOURCE
    assert "causal ? min(nk, q_last / BKV + 1) : nk" in BWD_SOURCE
    assert "causal ? min(nq, k0 / BQ) : 0" in BWD_SOURCE
    assert "(static_cast<long long>(k_last) + window - 1) / BQ" in BWD_SOURCE


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
    by_q, by_k = bwd_cover(sq, sk, causal, window)
    want = _live(sq, sk, causal, window).astype(np.int64)
    np.testing.assert_array_equal(by_q, want)
    np.testing.assert_array_equal(by_k, want)


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
