"""Port vs reference: attention rows with no live key, on the CPU.

A sliding window with no causal mask, or with more query rows than keys,
leaves the rows ``i >= sk - 1 + w`` with no key in their band.  The
reference's ``flash_attend`` masks every logit of such a row to the same
finite floor and visits every key block, so the row averages ``v`` over
all ``sk`` keys; under ``jax.grad`` each key's ``dv`` takes ``do / sk``
from it and ``dq`` and ``dk`` take nothing (the mask's ``where`` stops
them).  The port's ``flash_attend`` runs ``flash_mha`` (plain ``mha_ref``
on the CPU) and its autograd backward ``mha_bwd_ref``; here they are held
to the reference's forward within 1e-5 and to ``jax.grad`` within the
reference tests' 2e-3 and 1e-5, and ``mha_bwd_ref`` to ``torch.autograd``
of ``mha_ref`` in float64 with dead rows present.  The kernels
(``dead_rows_kernel``, ``dead_dv_kernel``) are held to these plain
versions on the card: ``tests/test_torch_gpu.py::
test_flash_mha_dead_rows_match_plain``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.kernels import mha_bwd_ref, mha_ref  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

GRAD_TOL = 2e-3           # rtol = atol: the reference tests' bound
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (b, sq, sk, h, kv, hd, causal, w, q_block, k_block): dead rows from
# sk - 1 + w on
CASES = [
    (1, 64, 32, 2, 2, 8, True, 8, 16, 16),       # rows 39.. dead
    (1, 64, 32, 2, 2, 8, False, 8, 16, 16),
    (2, 96, 48, 2, 2, 16, False, 5, 32, 16),     # rows 52.. dead
    (1, 128, 64, 4, 2, 16, True, 17, 32, 32),    # GQA, rows 80.. dead
    (1, 64, 16, 2, 2, 8, False, 1, 16, 16),      # w 1: rows 16.. dead
]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,w,qb,kb", CASES)
def test_dead_rows_match_the_reference_forward_and_grad(b, sq, sk, h, kv, hd,
                                                        causal, w, qb, kb):
    q, k, v, g = _arrays(sq + sk + h + w, (b, sq, h, hd), (b, sk, kv, hd),
                         (b, sk, kv, hd), (b, sq, h, hd))

    def ref_out(q_, k_, v_):
        return ref_tf.flash_attend(q_, k_, v_, causal=causal,
                                   w_eff=jnp.int32(w), q_block=qb,
                                   k_block=kb)

    def ref_loss(q_, k_, v_):
        return jnp.sum(ref_out(q_, k_, v_) * jnp.asarray(g))

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_o = np.asarray(ref_out(jq, jk, jv))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tf.flash_attend(tq, tk, tv, causal=causal, w_eff=w, q_block=qb,
                          k_block=kb)
    # the dead rows average v, in both
    dead = slice(sk - 1 + w, sq)
    mean_v = np.repeat(v.mean(1), h // kv, axis=1)
    np.testing.assert_allclose(want_o[:, dead], np.broadcast_to(
        mean_v[:, None], want_o[:, dead].shape), atol=TOL)
    assert np.abs(out.detach().numpy() - want_o).max() <= TOL
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, e in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")
        assert np.abs(a.numpy() - np.asarray(e)).max() <= TOL, f"d{name}"
    # the dead rows' own terms: no dq, and a dv share that is not small
    assert not got[0][:, dead].any()
    share = np.abs(g[:, dead].sum(1)).max() / sk
    assert share > 100 * TOL


@pytest.mark.parametrize("causal,w,qb", [(True, 6, 16), (False, 6, 64),
                                         (False, 1, 7)])
def test_mha_bwd_ref_is_autograd_of_mha_ref_with_dead_rows(causal, w, qb):
    bh, sq, sk, hd = 2, 64, 30, 8
    q, k, v, do = (torch.from_numpy(a).double() for a in _arrays(
        w + qb, (bh, sq, hd), (bh, sk, hd), (bh, sk, hd), (bh, sq, hd)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = mha_ref(*leaves, causal=causal, q_block=qb, window=w)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = mha_ref(q, k, v, causal=causal, q_block=qb, window=w,
                     return_lse=True)
    assert torch.isneginf(lse[:, sk - 1 + w:]).all()
    got = mha_bwd_ref(q, k, v, o, lse, do, causal=causal, window=w,
                      q_block=qb)
    for a, e in zip(got, want):
        assert float((a - e).abs().max()) <= 1e-12
