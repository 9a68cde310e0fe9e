"""Port vs reference: the gradient of ``flash_mha`` on the CPU, through its
``torch.autograd.Function`` (plain forward ``mha_ref``, plain backward
``mha_bwd_ref``; the CUDA kernels ``csrc/flash_mha_bwd.cu`` run only on the
card, ``chip_smoke.py`` phase 16 and ``tests/test_torch_gpu.py``).

* ``flash_attend``'s gradients (q, k, v) against ``jax.grad`` of the
  reference's XLA ``flash_attend`` on the same numpy inputs and cotangent,
  within 2e-3 (the reference tests' gradient bound; the largest error seen
  here is 2.1e-6, and each case is also held to 1e-5): causal and not,
  windows 1, 7 and 64, sq != sk non-causal, GQA (4 query heads on 2 KV
  heads), q_block / k_block 16-64;
* ``mha_bwd_ref`` equals ``torch.autograd`` of ``mha_ref`` in float64
  (to 1e-12), causal or not, with a window or not, sq != sk, blocked or
  not; a row with no live key gets zero gradients (the kernel's o is 0
  there) and ``-inf`` as its ``lse``;
* ``mha_ref(return_lse=True)``'s ``lse`` is ``logsumexp`` of the masked
  logits, in base 2;
* the wrapper raises on a device that is neither CPU nor CUDA, on a wrong
  type and on a wrong shape; the roofline counter charges a forward and
  backward 4 + 10 flops a live pair and head dim.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.kernels import (flash_mha, flash_mha_bwd,  # noqa: E402
                                 mha_bwd_ref, mha_ref)
from repro_torch.kernels.flash import live_pairs  # noqa: E402
from repro_torch.launch.roofline import count_work  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

GRAD_TOL = 2e-3           # rtol = atol: the reference tests' bound
F64_TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,w,qb,kb", [
    (1, 128, 128, 2, 2, 16, True, None, 32, 64),     # causal
    (2, 128, 128, 2, 2, 16, False, None, 64, 32),    # non-causal
    (1, 128, 128, 2, 2, 32, True, 1, 16, 16),        # window 1
    (1, 128, 128, 2, 2, 16, True, 7, 32, 32),        # window 7
    (2, 192, 192, 2, 2, 16, True, 64, 64, 64),       # window 64
    (1, 64, 192, 2, 2, 16, False, None, 32, 64),     # sq < sk, non-causal
    (1, 192, 64, 2, 2, 16, False, None, 64, 32),     # sq > sk, non-causal
    (2, 128, 128, 4, 2, 16, True, None, 32, 32),     # GQA h 4 / kv 2
    (1, 128, 128, 4, 2, 16, True, 7, 16, 64),        # GQA with a window
])
def test_flash_attend_gradients_match_jax_grad(b, sq, sk, h, kv, hd, causal,
                                               w, qb, kb):
    q, k, v, g = _arrays(sq * 7 + sk + h + (w or 0), (b, sq, h, hd),
                         (b, sk, kv, hd), (b, sk, kv, hd), (b, sq, h, hd))
    w_ref = None if w is None else jnp.int32(w)

    def ref_loss(q_, k_, v_):
        out = ref_tf.flash_attend(q_, k_, v_, causal=causal, w_eff=w_ref,
                                  q_block=qb, k_block=kb)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tf.flash_attend(tq, tk, tv, causal=causal, w_eff=w, q_block=qb,
                          k_block=kb)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, e in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")
        assert np.abs(a.numpy() - np.asarray(e)).max() <= 1e-5, f"d{name}"


def _f64(seed, bh, sq, sk, hd):
    return [torch.from_numpy(a).double() for a in _arrays(
        seed, (bh, sq, hd), (bh, sk, hd), (bh, sk, hd), (bh, sq, hd))]


@pytest.mark.parametrize("bh,sq,sk,hd,causal,w,qb", [
    (2, 96, 96, 16, True, None, 32),
    (2, 96, 96, 16, False, None, 96),
    (2, 96, 96, 16, True, 5, 16),
    (2, 80, 120, 8, False, None, 32),
    (3, 120, 80, 8, True, 50, 7),
    (2, 100, 100, 16, False, 9, 1000),
])
def test_mha_bwd_ref_is_autograd_of_mha_ref_in_float64(bh, sq, sk, hd,
                                                       causal, w, qb):
    q, k, v, do = _f64(bh + sq + (w or 0), bh, sq, sk, hd)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = mha_ref(*leaves, causal=causal, q_block=qb, window=w)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = mha_ref(q, k, v, causal=causal, q_block=qb, window=w,
                     return_lse=True)
    assert not torch.isneginf(lse).any()
    got = mha_bwd_ref(q, k, v, o, lse, do, causal=causal, window=w,
                      q_block=qb)
    for a, e in zip(got, want):
        assert a.dtype == torch.float64
        assert float((a - e).abs().max()) <= F64_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_rows_without_a_live_key_get_zero_gradients(causal):
    # a window of 5 over 40 keys: rows 44.. keep none (sq > sk)
    bh, sq, sk, hd, w = 2, 64, 40, 8, 5
    q, k, v, do = (t.float() for t in _f64(3, bh, sq, sk, hd))
    o, lse = mha_ref(q, k, v, causal=causal, window=w, q_block=16,
                     return_lse=True)
    dead = torch.isneginf(lse)
    assert dead.sum() == bh * (sq - (sk - 1 + w))
    assert dead[:, sk - 1 + w:].all() and not dead[:, :sk - 1 + w].any()
    dq, dk, dv = mha_bwd_ref(q, k, v, o, lse, do, causal=causal, window=w,
                             q_block=16)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert not dq[dead].any()
    # the rows with keys alone give the same dk, dv
    live = slice(0, sk - 1 + w)
    _, dk2, dv2 = mha_bwd_ref(q[:, live], k, v, o[:, live], lse[:, live],
                              do[:, live], causal=causal, window=w,
                              q_block=16)
    torch.testing.assert_close(dk, dk2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dv, dv2, rtol=1e-6, atol=1e-6)
    # through the autograd Function too
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_mha(*leaves, causal=causal, window=w, q_block=1, k_block=1)
    gq, _, _ = torch.autograd.grad(out, leaves, do)
    assert torch.isfinite(gq).all() and not gq[dead].any()


@pytest.mark.parametrize("causal,w", [(True, None), (False, None),
                                      (True, 3), (False, 7)])
def test_mha_ref_lse_is_logsumexp_of_its_logits(causal, w):
    bh, sq, sk, hd = 2, 50, 70, 8
    q, k, v, _ = (t.float() for t in _f64(5, bh, sq, sk, hd))
    _, lse = mha_ref(q, k, v, causal=causal, window=w, q_block=16,
                     return_lse=True)
    logits = (q @ k.transpose(1, 2)) / math.sqrt(hd)
    i = torch.arange(sq)[:, None]
    j = torch.arange(sk)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        ok &= j <= i
    if w is not None:
        ok &= i - j < w
    want = torch.logsumexp(logits.masked_fill(~ok, -math.inf), -1) \
        / math.log(2.0)
    assert lse.dtype == torch.float32 and lse.shape == (bh, sq)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)
    # the wrapper on the CPU: the plain version with its q_block
    o2, lse2 = flash_mha(q, k, v, causal=causal, window=w, q_block=1,
                         k_block=1, return_lse=True)
    assert torch.equal(lse2, mha_ref(q, k, v, causal=causal, window=w,
                                     q_block=1, return_lse=True)[1])
    assert torch.equal(o2, flash_mha(q, k, v, causal=causal, window=w,
                                     q_block=1, k_block=1))


def test_bf16_backward_rounds_p_as_the_forward():
    """bf16: ``dv`` sums ``p`` cast to bf16 (the forward's rounding), the
    rest in f32 from the f32 ``p``; the result in bf16, close to f32."""
    bh, s, hd = 2, 64, 16
    q, k, v, do = (t.float() for t in _f64(9, bh, s, s, hd))
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    o, lse = mha_ref(qb, kb, vb, q_block=16, return_lse=True)
    got = mha_bwd_ref(qb, kb, vb, o, lse, dob, q_block=16)
    assert all(t.dtype == torch.bfloat16 for t in got)
    leaves = [t.float().requires_grad_() for t in (qb, kb, vb)]
    want = torch.autograd.grad(mha_ref(*leaves, q_block=16), leaves,
                               dob.float())
    for a, e in zip(got, want):
        assert float((a.float() - e).abs().max()) <= 5e-2


def test_flash_mha_bwd_checks_its_inputs():
    bh, s, hd = 1, 64, 16
    q = torch.zeros((bh, s, hd))
    lse = torch.zeros((bh, s))
    ok = (q, q, q, q, lse, q)
    assert [t.shape for t in flash_mha_bwd(*ok)] == [q.shape] * 3
    with pytest.raises(ValueError, match="shapes"):
        flash_mha_bwd(q, q, q, q, torch.zeros((bh, s + 1)), q)
    with pytest.raises(ValueError, match="shapes"):
        flash_mha_bwd(q, q[:, :, :8], q, q, lse, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_mha_bwd(*(t.half() if t is q else t for t in ok))
    with pytest.raises(TypeError, match="lse"):
        flash_mha_bwd(q, q, q, q, lse.double(), q)
    with pytest.raises(ValueError, match="window"):
        flash_mha_bwd(*ok, window=0)
    meta = [t.to("meta") for t in ok]
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_mha_bwd(*meta)
    with pytest.raises(ValueError, match="span devices"):
        flash_mha_bwd(q, q, q, q, lse.to("meta"), q)


def test_roofline_counts_the_backward():
    bh, sq, sk, hd, w = 2, 64, 96, 16, 9

    def step():
        leaves = [torch.randn(bh, n, hd, requires_grad=True)
                  for n in (sq, sk, sk)]
        out = flash_mha(*leaves, causal=True, window=w, q_block=1,
                        k_block=1)
        out.sum().backward()

    flops, nbytes = count_work(step)
    pairs = live_pairs(sq, sk, True, w)
    kernels = (4 + 10) * bh * hd * pairs
    assert flops == kernels                  # the plain versions uncounted
    assert nbytes >= (2 + 4) * bh * (sq + sk) * hd * 4 + 4 * bh * sq
