"""Port vs reference: serving the MoE, SSM and hybrid LM families
(``lm_serve.Server`` on the SMOKE configs of moonshot-v1-16b-a3b,
llama4-maverick-400b-a17b, mamba2-1.3b and zamba2-1.2b).

* the server's greedy tokens equal the reference ``Server``'s on the same
  weights and traffic (the reference's test_serve_completes_all_requests
  traffic), every pick's top-2 logit margin above twice the 1e-4 that
  decode logits keep to the reference's, so no near-tie decides a token;
* ``merge_cache`` keeps the masked rows' state on every leaf of every
  family's cache, on the batch axis;
* ``examples/torch_serve_lm.py`` serves moonshot's smoke config on the
  CPU, as ``chip_smoke.py``'s phase 15 runs it on the card (the phase
  itself is rehearsed in ``test_torch_lm_families_phase.py``).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402

from conftest import REPO, SRC  # noqa: E402

LOGIT_TOL = 1e-4        # decode logits vs the reference's
                        # (test_torch_lm_families.py)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_server_matches_reference_tokens(arch):
    from repro.launch.lm_serve import Request as RefRequest
    from repro.launch.lm_serve import Server as RefServer

    ref = RefServer(arch, slots=3, max_seq=64)
    weights = jax.tree_util.tree_map(np.asarray, ref_lm.init_params(
        jax.random.PRNGKey(0), ref_get_smoke(arch), dtype=jnp.float32))
    srv = lm_serve.Server(arch, slots=3, max_seq=64, device="cpu",
                          params=lm.params_from_reference(
                              weights, get_smoke(arch), device="cpu"))
    rng = np.random.default_rng(0)
    for i in range(5):
        prompt = rng.integers(0, srv.cfg.vocab, 6).astype(np.int32)
        ref.submit(RefRequest(rid=i, prompt=prompt, max_new=4))
        srv.submit(lm_serve.Request(rid=i, prompt=prompt.copy(), max_new=4))
    margins, prefill = [], []
    decode, step_slot = srv.decode, srv._step_slot

    def record(tokens, pos, mask):
        logits = decode(tokens, pos, mask)
        if not prefill:
            top = torch.topk(logits[:, 0][torch.from_numpy(mask)], 2).values
            margins.extend((top[:, 0] - top[:, 1]).tolist())
        return logits

    def quiet(*args):
        prefill.append(1)
        try:
            step_slot(*args)
        finally:
            prefill.pop()

    srv.decode, srv._step_slot = record, quiet
    ref_stats, stats = ref.run(), srv.run()
    assert [r.rid for r in srv.completed] == [r.rid for r in ref.completed]
    assert [r.generated for r in srv.completed] \
        == [r.generated for r in ref.completed]
    assert stats["tokens"] == ref_stats["tokens"] == 20
    assert stats["steps"] == ref_stats["steps"]
    assert len(margins) == 20 and min(margins) > 2 * LOGIT_TOL


def _leaves(cache):
    if dataclasses.is_dataclass(cache):
        return [t for f in dataclasses.fields(cache)
                for t in _leaves(getattr(cache, f.name))]
    return [cache]


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mamba2-1.3b",
                                  "zamba2-1.2b"])
def test_merge_cache_masks_every_leaf_on_the_batch_axis(arch):
    cfg = get_smoke(arch)
    old = lm.init_cache(cfg, 3, 8, dtype=torch.float32, device="cpu")
    fresh = _fill(old, 1.0)
    mask = torch.tensor([False, True, False])
    got = lm_serve.merge_cache(fresh, old, mask)
    assert type(got) is type(old)
    leaves = _leaves(got)
    assert len(leaves) == len(_leaves(old)) >= 2
    for t in leaves:
        assert t.shape[1] == 3
        assert bool((t[:, 1] == 1.0).all())
        assert not t[:, 0].any() and not t[:, 2].any()


def _fill(cache, value):
    if dataclasses.is_dataclass(cache):
        return type(cache)(**{f.name: _fill(getattr(cache, f.name), value)
                              for f in dataclasses.fields(cache)})
    return torch.full_like(cache, value)


def test_serve_example_runs_moonshot_on_the_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_serve_lm.py"),
         "--arch", "moonshot-v1-16b-a3b", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 8 requests / 96 tokens" in out.stdout
