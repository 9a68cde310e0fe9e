"""Port vs reference: Mamba2's SSD scan and convs (``repro.models.mamba2``)
on the same numpy inputs.

* ``ssd_scan`` within 1e-5 of the reference's for chunks 8 and 16, with
  and without ``h_init``, output and final state; chunk sizes agree with
  each other;
* ``ssd_step`` run token by token equals the scan within 1e-5;
* ``causal_conv`` within 1e-6, and ``conv_step`` token by token equals it;
* a chunk whose upper triangle overflows ``exp``: the reference's forward
  stays finite and its gradient is NaN, the port's forward matches and its
  gradient is finite and matches a float64 run;
* ``MambaCache.zeros`` and ``slice_layers`` as the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import mamba2 as ref_m  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import mamba2 as m  # noqa: E402

SCAN_TOL, CONV_TOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b=2, l=32, nh=3, p=4, n=5, dt_scale=0.5, a_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, nh, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, l, nh))) * dt_scale).astype(
        np.float32) + 1e-3
    A = -(np.abs(rng.standard_normal(nh)) * a_scale + 0.1).astype(
        np.float32)
    B, C = (rng.standard_normal((b, l, n)).astype(np.float32)
            for _ in range(2))
    D = rng.standard_normal(nh).astype(np.float32)
    h0 = rng.standard_normal((b, nh, n, p)).astype(np.float32)
    return x, dt, A, B, C, D, h0


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("with_h", [False, True])
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_scan_matches_reference(chunk, with_h):
    x, dt, A, B, C, D, h0 = _inputs(chunk + with_h)
    h = h0 if with_h else None
    want_y, want_h = ref_m.ssd_scan(
        *(jnp.asarray(a) for a in (x, dt, A, B, C, D)), chunk=chunk,
        h_init=None if h is None else jnp.asarray(h))
    got_y, got_h = m.ssd_scan(
        *(torch.from_numpy(a) for a in (x, dt, A, B, C, D)), chunk=chunk,
        h_init=None if h is None else torch.from_numpy(h))
    assert got_y.dtype == torch.float32 and got_y.shape == x.shape
    assert _err(got_y, want_y) <= SCAN_TOL
    assert _err(got_h, want_h) <= SCAN_TOL
    other, _ = m.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, B, C, D)),
                          chunk=24 - chunk,
                          h_init=None if h is None else torch.from_numpy(h))
    assert _err(other, got_y) <= SCAN_TOL
    with pytest.raises(ValueError, match="divisible"):
        m.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, B, C, D)),
                   chunk=5)


def test_ssd_step_token_by_token_equals_the_scan():
    x, dt, A, B, C, D, h0 = _inputs(4)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C, D, h0)]
    y_scan, h_scan = m.ssd_scan(*t[:6], chunk=8, h_init=t[6])
    H, ys = t[6], []
    for i in range(x.shape[1]):
        H, y = m.ssd_step(H, t[0][:, i], t[1][:, i], t[2], t[3][:, i],
                          t[4][:, i], t[5])
        ys.append(y)
    assert _err(torch.stack(ys, 1), y_scan) <= SCAN_TOL
    assert _err(H, h_scan) <= SCAN_TOL
    want_h, want_y = ref_m.ssd_step(*(jnp.asarray(a) for a in (
        h0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)))
    got_h, got_y = m.ssd_step(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in (h0, x[:, 0], dt[:, 0], A, B[:, 0],
                                          C[:, 0], D)))
    assert _err(got_y, want_y) <= CONV_TOL and _err(got_h, want_h) <= CONV_TOL


def test_causal_conv_and_conv_step_match_reference():
    rng = np.random.default_rng(5)
    b, l, ch, k = 2, 11, 6, 4
    x = rng.standard_normal((b, l, ch)).astype(np.float32)
    w = rng.standard_normal((k, ch)).astype(np.float32)
    bias = rng.standard_normal(ch).astype(np.float32)
    want = ref_m.causal_conv(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(bias))
    got = m.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(bias))
    assert _err(got, want) <= CONV_TOL
    state = torch.zeros((b, k - 1, ch))
    ref_state = jnp.zeros((b, k - 1, ch))
    for i in range(l):
        y, state = m.conv_step(torch.from_numpy(x[:, i]), state,
                               torch.from_numpy(w), torch.from_numpy(bias))
        want_y, ref_state = ref_m.conv_step(jnp.asarray(x[:, i]), ref_state,
                                            jnp.asarray(w),
                                            jnp.asarray(bias))
        assert _err(y, got[:, i]) <= CONV_TOL
        assert _err(y, want_y) <= CONV_TOL
        assert _err(state, ref_state) <= CONV_TOL


def test_overflowing_chunk_keeps_the_gradient_finite():
    """dt·A summed over one chunk reaches ~-200, so exp(cum_i - cum_j)
    above the diagonal is exp(+200) = inf in f32: the reference's forward
    survives (the where drops it) but its gradient is 0·inf = NaN.  The
    port masks before the exp."""
    x, dt, A, B, C, D, _ = _inputs(6, l=16, dt_scale=8.0, a_scale=4.0)
    cum = np.cumsum(dt[0, :, 0] * A[0])
    assert cum[0] - cum[-1] > 89                 # exp overflows f32
    args = [jnp.asarray(a) for a in (x, dt, A, B, C, D)]
    want_y, _ = ref_m.ssd_scan(*args, chunk=16)
    ref_grad = jax.grad(lambda d: ref_m.ssd_scan(
        args[0], d, *args[2:], chunk=16)[0].sum())(args[1])
    assert np.isfinite(np.asarray(want_y)).all()
    assert np.isnan(np.asarray(ref_grad)).any()
    x_, A_, B_, C_, D_ = (torch.from_numpy(a) for a in (x, A, B, C, D))
    dtt = torch.from_numpy(dt).requires_grad_()
    got_y, _ = m.ssd_scan(x_, dtt, A_, B_, C_, D_, chunk=16)
    # dt up to ~30 makes y ~30× larger than the other cases: relative
    scale = max(1.0, float(np.abs(np.asarray(want_y)).max()))
    assert _err(got_y.detach(), want_y) <= SCAN_TOL * scale
    (grad,) = torch.autograd.grad(got_y.sum(), dtt)
    assert torch.isfinite(grad).all()
    dt64 = torch.from_numpy(dt).double().requires_grad_()
    y64, _ = m.ssd_scan(x_.double(), dt64, A_.double(), B_.double(),
                        C_.double(), D_.double(), chunk=16)
    (grad64,) = torch.autograd.grad(y64.sum(), dt64)
    assert _err(grad, grad64) <= 1e-4 * float(grad64.abs().max())


def test_mamba_cache_matches_reference():
    arch = "zamba2-1.2b"
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    want = ref_m.MambaCache.zeros(ref_cfg, 3)
    got = m.MambaCache.zeros(cfg, 3, device="cpu")
    for name in ("conv_x", "conv_B", "conv_C", "ssm"):
        a, w = getattr(got, name), getattr(want, name)
        assert tuple(a.shape) == w.shape and a.dtype == torch.float32
        assert not a.any()
    part = got.slice_layers(2, 5)
    assert part.ssm.shape[0] == 3 and part.conv_x.shape[1:] \
        == got.conv_x.shape[1:]
