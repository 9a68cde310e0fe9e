"""Port vs reference: gemma3-27b's SMOKE prefill past ``FLASH_THRESHOLD``
(s = 9216), where every layer takes the flash branch: five windowed
``flash_mha`` calls (gemma3's 1024-key window on its local layers) and one
plain causal call for the global layer (``w_eff = s`` is no window), the
last logits within 1e-4 of the reference's on its own weights.  The
port's wrapper runs its plain version on CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import flash_mha  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def test_gemma3_prefill_past_the_threshold_matches_reference(monkeypatch):
    """s = 9216 > FLASH_THRESHOLD: every layer takes the flash branch, the
    five local layers with gemma3's 1024-key window."""
    arch = "gemma3-27b"
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    ref = jax.tree_util.tree_map(np.asarray, ref_lm.init_params(
        jax.random.PRNGKey(0), ref_cfg, dtype=jnp.float32))
    params = lm.params_from_reference(ref, cfg, device="cpu")
    s = 9216
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (1, s))
    want = ref_lm.prefill_fn(ref_cfg)(ref, {"tokens": jnp.asarray(tokens)})
    calls = []

    def spy(q, k, v, **kw):
        calls.append(kw["window"])
        return flash_mha(q, k, v, **kw)

    monkeypatch.setattr(tf, "flash_mha", spy)
    got = lm.prefill_fn(cfg)(params, {"tokens": torch.from_numpy(tokens)})
    assert calls == [cfg.sliding_window] * 5 + [None]
    assert got.shape == (1, 1, cfg.vocab)
    assert _err(got, want) <= LOGIT_TOL
