"""Port vs reference at head dim 80 (stablelm-3b's), past
``FLASH_THRESHOLD``, on the CPU through the plain version.

* ``flash_attend`` at hd 80 within 2e-4 of the reference's XLA
  ``flash_attend`` (the tolerance of ``test_torch_flash_window.py``):
  causal, with a window, and non-causal with ``sq != sk``, each over
  9216 keys, one head;
* a 1-layer ``stablelm-3b`` smoke config at head dim 80 (the reference's
  weights) prefilled over 9216 tokens within the LM tests' 1e-4 of the
  reference's logits, through ``flash_mha`` once;
* the card's checks take hd 80 and still refuse other head dims: fake
  CUDA tensors (shapes only, no autograd, so this runs on a CPU-only
  build) pass ``flash_mha`` and ``flash_mha_bwd`` at hd 80 and get the
  kernels' output shapes, and hd 96 raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import flash_mha, flash_mha_bwd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

FLASH_TOL = 2e-4          # online softmax against XLA's scan (other order)
LOGIT_TOL = 1e-4          # logits after a whole model
HD, S = 80, 9216          # stablelm-3b's head dim; 9 key blocks of 1024


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("sq,causal,w", [
    (S, True, None),                   # causal self-attention
    (S, True, 700),                    # a window
    (1024, False, None),               # non-causal, sq != sk
])
def test_flash_attend_hd80_matches_reference(sq, causal, w):
    assert S > tf.FLASH_THRESHOLD
    rng = np.random.default_rng(sq + (w or 0))
    q = rng.standard_normal((1, sq, 1, HD)).astype(np.float32)
    k, v = (rng.standard_normal((1, S, 1, HD)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, q_block=512, k_block=1024)
    want = ref_tf.flash_attend(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v),
                               w_eff=None if w is None else jnp.int32(w),
                               **kw)
    got = tf.flash_attend(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), w_eff=w, **kw)
    assert got.shape == (1, sq, 1, HD)
    assert _err(got, want) <= FLASH_TOL


def test_stablelm_hd80_prefill_past_the_threshold_matches_reference(
        monkeypatch):
    cfg = get_smoke("stablelm-3b").scaled(n_layers=1, head_dim=HD)
    ref_cfg = ref_get_smoke("stablelm-3b").scaled(n_layers=1, head_dim=HD)
    ref_params = jax.tree_util.tree_map(np.asarray, ref_lm.init_params(
        jax.random.PRNGKey(0), ref_cfg, dtype=jnp.float32))
    params = lm.params_from_reference(ref_params, cfg, device="cpu")
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (1, S))
    want = ref_lm.prefill_fn(ref_cfg)(ref_params,
                                      {"tokens": jnp.asarray(tokens)})
    calls = []

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return flash_mha(q, k, v, **kw)

    monkeypatch.setattr(tf, "flash_mha", spy)
    got = lm.prefill_fn(cfg)(params, {"tokens": torch.from_numpy(tokens)})
    assert calls == [(cfg.n_heads, S, HD)]
    assert got.shape == (1, 1, cfg.vocab)
    assert _err(got.numpy(), want) <= LOGIT_TOL


def test_the_card_checks_take_hd80_and_refuse_other_head_dims():
    from torch._subclasses.fake_tensor import FakeTensorMode

    n0, m0 = flash_mha.launches, flash_mha_bwd.launches
    with FakeTensorMode():
        q = torch.empty((2, 300, HD), device="cuda")
        k = torch.empty((2, 200, HD), device="cuda")
        o, lse = flash_mha(q, k, k, causal=False, q_block=1, k_block=1,
                           return_lse=True)
        grads = flash_mha_bwd(q, k, k, o, lse, q, causal=False)
        assert (o.shape, o.device.type, lse.shape, lse.dtype) == (
            q.shape, "cuda", (2, 300), torch.float32)
        assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
        wide = torch.empty((2, 64, 96), device="cuda")
        for call in (lambda: flash_mha(wide, wide, wide, q_block=1,
                                       k_block=1),
                     lambda: flash_mha_bwd(
                         wide, wide, wide, wide,
                         torch.empty((2, 64), device="cuda"), wide)):
            with pytest.raises(ValueError, match="head dims"):
                call()
    # shapes only: no launch
    assert (flash_mha.launches, flash_mha_bwd.launches) == (n0, m0)
