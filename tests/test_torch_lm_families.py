"""Port vs reference: the MoE, SSM, hybrid and encoder-decoder LM families
(the SMOKE configs of moonshot-v1-16b-a3b, llama4-maverick-400b-a17b,
mamba2-1.3b, zamba2-1.2b and seamless-m4t-medium), on the reference's own
weights (``repro.models.lm.init_params(PRNGKey(0), smoke, f32)``) carried
over by ``params_from_reference``.

* ``params_from_reference`` / ``params_to_reference`` round-trip every
  leaf, in the reference's leaf order and types (the MoE router f32);
* forward logits within 1e-4 and the MoE aux loss within 1e-5 of
  ``repro.models.lm.forward``;
* decode steps' logits within 1e-4 of the reference's decode (the
  reference test's bound is 2e-3; the servers' near-tie guard relies on
  1e-4) and every cache leaf within 2e-3; encdec's decode within 2e-3 of
  the reference's and 1e-3 of its teacher-forced forward;
* training (gradients, AdamW) is held in ``test_torch_lm_families_train.py``
  and serving (the ``Server``, the example, phase 15's rehearsal) in
  ``test_torch_lm_families_serve.py``.

Each case jits at most one reference function.  The file runs on one
intra-op thread (the smoke models' matmuls are tiny).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.data.tokens import make_lm_batch as ref_make_lm_batch  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import make_lm_batch  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402

ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b", "mamba2-1.3b",
         "zamba2-1.2b", "seamless-m4t-medium")
DECODERS = ARCHS[:4]
LOGIT_TOL, AUX_TOL = 1e-4, 1e-5
DECODE_TOL = 2e-3          # the reference's test_decode_matches_prefill
TF_TOL = 1e-3              # the reference's encdec teacher-forcing test
SEQ, CHUNK = 16, 8


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch → (reference cfg, reference params as numpy, port cfg, port
    params on the CPU)."""
    out = {}
    for arch in ARCHS:
        ref_cfg = ref_get_smoke(arch)
        ref = jax.tree_util.tree_map(np.asarray, ref_lm.init_params(
            jax.random.PRNGKey(0), ref_cfg, dtype=jnp.float32))
        cfg = get_smoke(arch)
        out[arch] = (ref_cfg, ref, cfg,
                     lm.params_from_reference(ref, cfg, device="cpu"))
    return out


def _batch(cfg, step=0, b=2):
    """The token stream's batch (encdec: stub frames of ``SEQ`` positions
    and ``SEQ // 4`` decoder tokens, as ``train_lm``), equal in both
    packages."""
    frames = SEQ if cfg.family == "encdec" else 0
    got = make_lm_batch(0, step, b, SEQ, cfg.vocab, enc_frames=frames,
                        d_model=cfg.d_model)
    want = ref_make_lm_batch(0, step, b, SEQ, cfg.vocab, enc_frames=frames,
                             d_model=cfg.d_model)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    if cfg.family == "encdec":
        for k in ("tokens", "labels"):
            got[k] = got[k][:, :SEQ // 4]
    return got


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_every_leaf(models, arch):
    _, ref, cfg, params = models[arch]
    back = lm.params_to_reference(params)
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=str(key))
    tree = lm.param_tree(params)
    assert len(tree_leaves(tree)) == sum(       # one tensor a stacked layer
        np.shape(a)[0] if str(k[0].key).endswith("layers") else 1
        for k, a in want)
    if cfg.family == "moe":
        assert all(p.router.dtype == torch.float32
                   for p in params.moe_layers)
    with pytest.raises(ValueError, match="not a"):
        lm.params_from_reference(ref, get_smoke("llama3.2-1b"), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    ref_cfg, ref, cfg, params = models[arch]
    batch = _batch(cfg)
    want, want_aux = ref_lm.forward(ref, _jnp(batch), ref_cfg, chunk=CHUNK)
    with torch.no_grad():
        got, aux = lm.forward(params, _torch(batch), cfg, chunk=CHUNK)
        last = lm.prefill_fn(cfg, chunk=CHUNK)(params, _torch(batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _err(got.numpy(), want) <= LOGIT_TOL
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL
    assert (float(aux) > 0) == (cfg.family == "moe")
    assert last.shape == (2, 1, cfg.vocab)
    assert _err(last.numpy(), np.asarray(want)[:, -1:]) <= LOGIT_TOL


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps_match_reference(models, arch):
    ref_cfg, ref, cfg, params = models[arch]
    b, S = 2, 8
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (b, S))
    ref_cache = ref_lm.init_cache(ref_cfg, b, S, dtype=jnp.float32)
    cache = lm.init_cache(cfg, b, S, dtype=torch.float32, device="cpu")
    ref_step, step = jax.jit(ref_lm.decode_fn(ref_cfg)), lm.decode_fn(cfg)
    for t in range(S):
        want, ref_cache = ref_step(ref, ref_cache,
                                   jnp.asarray(tokens[:, t:t + 1]),
                                   jnp.int32(t))
        got, cache = step(params, cache,
                          torch.from_numpy(tokens[:, t:t + 1]), t)
        assert got.shape == (b, 1, cfg.vocab)
        assert _err(got.numpy(), want) <= LOGIT_TOL, t
    want_leaves = jax.tree_util.tree_leaves(ref_cache)
    got_leaves = _cache_leaves(cache)
    assert [np.shape(a) for a in want_leaves] \
        == [tuple(a.shape) for a in got_leaves]
    for a, w in zip(got_leaves, want_leaves):
        assert _err(a.numpy(), w) <= DECODE_TOL


def _cache_leaves(cache):
    """A cache's tensors in the reference pytree's order (dataclass fields
    in declaration order, as its registered flatten)."""
    import dataclasses

    if dataclasses.is_dataclass(cache):
        return [t for f in dataclasses.fields(cache)
                for t in _cache_leaves(getattr(cache, f.name))]
    return [cache]


@pytest.mark.parametrize("arch", ("moonshot-v1-16b-a3b", "mamba2-1.3b",
                                  "zamba2-1.2b"))
def test_decode_matches_teacher_forced_forward(models, arch):
    """The reference's test_decode_matches_prefill on the port (MoE at
    capacity factor 8: no slot drops in the forward either)."""
    from repro_torch.models import moe

    _, _, cfg, params = models[arch]
    b, s = 2, 16
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (b, s)))
    with torch.no_grad():
        if cfg.family == "moe":
            full, _ = moe.moe_forward(params, tokens, cfg,
                                      capacity_factor=8.0)
        else:
            full, _ = lm.forward(params, {"tokens": tokens}, cfg, chunk=8)
        cache = lm.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
        outs = []
        for t in range(s):
            if cfg.family == "moe":
                lg, cache = moe.moe_decode_step(params, cache,
                                                tokens[:, t:t + 1], t, cfg,
                                                capacity_factor=8.0)
            else:
                lg, cache = lm.decode_fn(cfg)(params, cache,
                                              tokens[:, t:t + 1], t)
            outs.append(lg[:, 0])
    assert _err(torch.stack(outs, 1).numpy(), full.numpy()) <= DECODE_TOL


def test_encdec_decode_matches_teacher_forcing_and_reference(models):
    ref_cfg, ref, cfg, params = models["seamless-m4t-medium"]
    rng = np.random.default_rng(2)
    b, s_enc, s_dec = 2, 12, 10
    frames = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (b, s_dec))
    with torch.no_grad():
        full = encdec.encdec_forward(params, torch.from_numpy(frames),
                                     torch.from_numpy(tokens), cfg)
        memory = encdec.encode(params, torch.from_numpy(frames), cfg)
        cache = encdec.prefill_cross(params, memory, cfg, b, s_dec,
                                     dtype=torch.float32)
        ref_cache = ref_encdec.prefill_cross(
            ref, ref_encdec.encode(ref, jnp.asarray(frames), ref_cfg),
            ref_cfg, b, s_dec, dtype=jnp.float32)
        assert _err(cache.cross_k.numpy(), ref_cache.cross_k) <= LOGIT_TOL
        step = lm.decode_fn(cfg)
        ref_step = jax.jit(ref_lm.decode_fn(ref_cfg))
        outs = []
        for t in range(s_dec):
            tok = tokens[:, t:t + 1]
            lg, cache = step(params, cache, torch.from_numpy(tok), t)
            want, ref_cache = ref_step(ref, ref_cache, jnp.asarray(tok),
                                       jnp.int32(t))
            assert _err(lg.numpy(), want) <= DECODE_TOL, t
            outs.append(lg[:, 0])
    assert _err(torch.stack(outs, 1).numpy(), full.numpy()) <= TF_TOL
    # a decode-ready cache from lm.init_cache needs the params
    with pytest.raises(ValueError, match="params"):
        lm.init_cache(cfg, b, s_dec, device="cpu")
    zero = lm.init_cache(cfg, b, s_dec, dtype=torch.float32, enc_frames=6,
                         params=params, device="cpu")
    assert tuple(zero.cross_k.shape) == (cfg.n_layers, b, 6, cfg.n_kv_heads,
                                         cfg.hd)
