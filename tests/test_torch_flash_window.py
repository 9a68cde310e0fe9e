"""Port vs reference: the sliding window of ``flash_mha`` (gemma3's local
layers past ``FLASH_THRESHOLD``), on the CPU through the plain version.

* ``mha_ref(window=)`` and ``flash_attend(w_eff=)`` within 2e-4 of the
  reference's XLA ``flash_attend`` at s 2048 (q_block 256, k_block 512,
  w 384; the reference's own test), causal and not; a window of at least
  ``sq`` is no window (the same call, bit for bit);
* ``flash_attend_causal_pairs`` against the reference's within 2e-4;
* (gemma3's SMOKE prefill past the threshold:
  ``test_torch_gemma3_prefill.py``);
* ``flash_mha``'s roofline count: the live (query, key) pairs against a
  brute-force count of the masks, for causal, windowed and full calls,
  sq = sk and not;
* ``window`` is checked (an int >= 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.kernels import flash, flash_mha, mha_ref  # noqa: E402
from repro_torch.launch.roofline import count_work  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

FLASH_TOL = 2e-4          # online softmax against XLA's scan (other order)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, s, h, kv, hd, sk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk or s, kv, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("causal", [True, False])
def test_windowed_flash_attend_matches_reference(causal):
    b, s, h, kv, hd, w = 2, 2048, 4, 2, 32, 384
    q, k, v = _qkv(int(causal), b, s, h, kv, hd)
    want = ref_tf.flash_attend(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               w_eff=jnp.int32(w), q_block=256, k_block=512)
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return flash_mha(*args, **kw)

    got = tf.flash_attend(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, w_eff=w,
                          q_block=256, k_block=512)
    assert got.shape == (b, s, h, hd)
    assert _err(got, want) <= FLASH_TOL
    # the plain version alone, on the heads-first layout
    kt, vt = tf._repeat_kv(torch.from_numpy(k), torch.from_numpy(v), h)
    qh, kh, vh = (tf.heads_first(t) for t in (torch.from_numpy(q), kt, vt))
    plain = mha_ref(qh, kh, vh, causal=causal, q_block=256, window=w)
    assert _err(plain.reshape(b, h, s, hd).permute(0, 2, 1, 3), want) \
        <= FLASH_TOL
    # w_eff >= sq masks nothing more: the kernel gets no window
    import repro_torch.models.transformer as tmod
    saved = tmod.flash_mha
    tmod.flash_mha = spy
    try:
        wide = tf.flash_attend(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal, w_eff=s,
                               q_block=256, k_block=512)
    finally:
        tmod.flash_mha = saved
    assert calls[0]["window"] is None
    plain_call = tf.flash_attend(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 q_block=256, k_block=512)
    assert torch.equal(wide, plain_call)


def test_causal_pairs_match_reference():
    b, s, h, kv, hd = 1, 1024, 2, 1, 16
    q, k, v = _qkv(7, b, s, h, kv, hd)
    want = ref_tf.flash_attend_causal_pairs(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), q_block=256,
                                            k_block=128)
    got = tf.flash_attend_causal_pairs(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), q_block=256,
                                       k_block=128)
    assert _err(got, want) <= FLASH_TOL
    with pytest.raises(ValueError, match="self-attention"):
        tf.flash_attend_causal_pairs(torch.from_numpy(q),
                                     torch.from_numpy(k[:, :512]),
                                     torch.from_numpy(v[:, :512]))


def _brute_pairs(sq, sk, causal, window):
    i = np.arange(sq)[:, None]
    j = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= i - j < window
    return int(ok.sum())


@pytest.mark.parametrize("sq,sk", [(300, 300), (256, 640), (640, 256),
                                   (1, 70), (129, 1)])
@pytest.mark.parametrize("window", [None, 1, 7, 64, 65, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_live_pairs_count_the_masks(sq, sk, window, causal):
    assert flash.live_pairs(sq, sk, causal, window) \
        == _brute_pairs(sq, sk, causal, window)


def test_roofline_count_reads_the_live_pairs():
    bh, s, hd = 2, 256, 16
    x = torch.zeros((bh, s, hd))
    blocks = dict(q_block=128, k_block=128)
    full = count_work(flash_mha, x, x, x, causal=False, **blocks)
    causal = count_work(flash_mha, x, x, x, causal=True, **blocks)
    band = count_work(flash_mha, x, x, x, causal=True, window=16, **blocks)
    assert full[0] == 4 * bh * hd * s * s
    assert causal[0] == 4 * bh * hd * s * (s + 1) // 2
    assert band[0] == 4 * bh * hd * _brute_pairs(s, s, True, 16)
    assert full[1] == causal[1] == band[1] == 4 * 4 * bh * s * hd


@pytest.mark.parametrize("window", [0, -3, 2.5, True])
def test_window_must_be_a_positive_int(window):
    x = torch.zeros((1, 64, 16))
    with pytest.raises(ValueError, match="window"):
        flash_mha(x, x, x, q_block=64, k_block=64, window=window)
