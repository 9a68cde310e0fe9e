"""Port vs reference: the dense LM serving slice (llama3.2-1b smoke widths).

The same numpy inputs go through :mod:`repro` and :mod:`repro_torch`.  The
reference's Pallas ``flash_mha`` runs in interpret mode; the port's
wrapper runs its plain version on CPU tensors.  Weights are the
reference's own (``repro.models.lm.init_params(PRNGKey(0), smoke, f32)``)
carried over by ``params_from_reference``.  Tolerances: 3e-4 (f32) and
5e-2 (bf16) for ``flash_mha``, as the reference's own kernel tests; 1e-5
for the materialized attention, 2e-4 for the blocked one (online softmax
against XLA's scan, in another order); 1e-6 for the norm and the rotary
embedding; 1e-4 for logits after a whole model (two frameworks' f32
matmuls in different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.kernels.flash import flash_mha as ref_flash_mha  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import flash_mha  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCH = "llama3.2-1b"
LOGIT_TOL = 1e-4


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke llama weights, as numpy leaves."""
    params = ref_lm.init_params(jax.random.PRNGKey(0), ref_get_smoke(ARCH),
                                dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def port_params(ref_params):
    return lm.params_from_reference(ref_params, get_smoke(ARCH), device="cpu")


# ---------------------------------------------------------------------------
# flash_mha
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd,qb,kb", [(4, 1024, 64, 128, 256),
                                           (2, 512, 128, 256, 128),
                                           (1, 256, 32, 128, 128)])
def test_flash_mha_matches_interpreted_pallas(causal, bh, s, hd, qb, kb):
    rng = np.random.default_rng(bh * s + hd)
    q, k, v = (rng.standard_normal((bh, s, hd)).astype(np.float32)
               for _ in range(3))
    want = ref_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, q_block=qb, k_block=kb,
                         interpret=True)
    got = flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=causal, q_block=qb,
                    k_block=kb)
    assert got.dtype == torch.float32 and got.shape == (bh, s, hd)
    assert _max_err(got.numpy(), want) <= 3e-4


def test_flash_mha_bf16_matches_interpreted_pallas():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 512, 64)).astype(np.float32)
               for _ in range(3))
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = ref_flash_mha(*j, q_block=128, k_block=128, interpret=True)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = flash_mha(*t, q_block=128, k_block=128)
    assert got.dtype == torch.bfloat16
    assert _max_err(got.float().numpy(), np.asarray(want, np.float32)) \
        <= 5e-2


def test_flash_mha_divisibility_and_devices():
    x = torch.zeros((1, 256, 16))
    with pytest.raises(ValueError, match="not divisible"):
        flash_mha(x, x, x, q_block=96, k_block=128)
    with pytest.raises(ValueError, match="not divisible"):
        flash_mha(x, x, x, q_block=512, k_block=128)     # larger than s
    with pytest.raises(TypeError):
        flash_mha(x.double(), x.double(), x.double(), q_block=128,
                  k_block=128)
    meta = torch.zeros((1, 256, 16), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_mha(meta, meta, meta, q_block=128, k_block=128)


# ---------------------------------------------------------------------------
# attention and primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_attend_matches_reference(h, kv, masked):
    rng = np.random.default_rng(h * 10 + kv + masked)
    b, sq, sk, hd = 2, 12, 20, 16
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
            for _ in range(2))
    mask = None
    if masked:
        i = np.arange(sq)[:, None] + (sk - sq)
        mask = (np.arange(sk)[None, :] <= i)[None, None]
    want = ref_tf.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         None if mask is None else jnp.asarray(mask))
    got = tf.attend(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v),
                    None if mask is None else torch.from_numpy(mask))
    assert _max_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attend_matches_reference(causal):
    rng = np.random.default_rng(int(causal))
    b, s, h, kv, hd = 2, 256, 4, 2, 16
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    want = ref_tf.flash_attend(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, q_block=64,
                               k_block=128)
    got = tf.flash_attend(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, q_block=64,
                          k_block=128)
    assert got.shape == (b, s, h, hd)
    assert _max_err(got.numpy(), want) <= 2e-4
    # with a sliding window (gemma3's local layers past the threshold)
    want = ref_tf.flash_attend(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               w_eff=jnp.int32(64), q_block=64, k_block=128)
    got = tf.flash_attend(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, w_eff=64,
                          q_block=64, k_block=128)
    assert _max_err(got.numpy(), want) <= 2e-4


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    g = (rng.standard_normal(16) * 0.1).astype(np.float32)
    want = ref_tf.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-6)
    got = tf.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-6)
    assert _max_err(got.numpy(), want) <= 1e-6
    pos = rng.integers(0, 300, (2, 24))
    for theta in (500_000.0, 10_000.0):
        want = ref_tf.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = tf.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        assert _max_err(got.numpy(), want) <= 1e-6
    np.testing.assert_array_equal(tf.rope_freqs(16, 500_000.0).numpy(),
                                  np.asarray(ref_tf.rope_freqs(16, 500_000.0)))


def test_masks_and_repeat_match_reference():
    np.testing.assert_array_equal(tf.causal_mask(9).numpy(),
                                  np.asarray(ref_tf.causal_mask(9)))
    np.testing.assert_array_equal(tf.sliding_mask(9, 3).numpy(),
                                  np.asarray(ref_tf.sliding_mask(9, 3)))
    rng = np.random.default_rng(4)
    k = rng.standard_normal((1, 5, 2, 4)).astype(np.float32)
    want, _ = ref_tf._repeat_kv(jnp.asarray(k), jnp.asarray(k), 6)
    got, _ = tf._repeat_kv(torch.from_numpy(k), torch.from_numpy(k), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cfg = get_config("gemma3-27b")
    np.testing.assert_array_equal(
        tf.global_flags(cfg).numpy(),
        np.asarray(ref_tf.global_flags(ref_get_config("gemma3-27b"))))
    assert tf.layer_window(cfg, 4096, False) == cfg.sliding_window
    assert tf.layer_window(cfg, 4096, True) == 4096
    assert tf.layer_window(get_config(ARCH), 4096, True) is None


# ---------------------------------------------------------------------------
# whole model, carried weights
# ---------------------------------------------------------------------------
def test_params_from_reference_carries_every_leaf(ref_params, port_params):
    cfg = get_smoke(ARCH)
    assert len(port_params.layers) == cfg.n_layers
    assert port_params.lm_head is None            # tied embeddings
    np.testing.assert_array_equal(port_params.embed.detach().numpy(),
                                  ref_params["embed"])
    for i, layer in enumerate(port_params.layers):
        for name in tf.LAYER_LEAVES:
            np.testing.assert_array_equal(
                getattr(layer, name).detach().numpy(),
                ref_params["layers"][name][i])


def test_init_params_has_the_reference_shapes_and_scales(ref_params):
    cfg = get_smoke(ARCH).scaled(d_model=256, d_ff=512, vocab=2048,
                                 n_heads=8, n_kv_heads=2, head_dim=32)
    ref_cfg = ref_get_smoke(ARCH).scaled(d_model=256, d_ff=512, vocab=2048,
                                         n_heads=8, n_kv_heads=2, head_dim=32)
    want = ref_lm.init_params(jax.random.PRNGKey(0), ref_cfg,
                              dtype=jnp.float32)
    got = lm.init_params(torch.Generator().manual_seed(0), cfg,
                         dtype=torch.float32)
    assert got.embed.dtype == torch.float32
    pairs = [(got.embed, want["embed"]), (got.ln_final, want["ln_final"])]
    for i, layer in enumerate(got.layers):
        pairs += [(getattr(layer, n), want["layers"][n][i])
                  for n in tf.LAYER_LEAVES]
    for t, ref in pairs:
        t, ref = t.detach(), np.asarray(ref)
        assert tuple(t.shape) == ref.shape
        if ref.std() == 0:
            assert float(t.abs().max()) == 0.0
        else:
            assert abs(float(t.std()) / float(ref.std()) - 1.0) < 0.05
    bf = lm.init_params(torch.Generator().manual_seed(0), cfg)
    assert bf.embed.dtype == torch.bfloat16


def test_dense_forward_matches_reference(ref_params, port_params):
    cfg, ref_cfg = get_smoke(ARCH), ref_get_smoke(ARCH)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 16))
    want = ref_tf.dense_forward(ref_params, jnp.asarray(tokens), ref_cfg)
    with torch.no_grad():
        got = tf.dense_forward(port_params, torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab)
    assert _max_err(got.numpy(), want) <= LOGIT_TOL


def test_prefill_through_the_flash_branch_matches_reference(
        ref_params, port_params, monkeypatch):
    """s = 9216 > FLASH_THRESHOLD: both sides take their blocked path (the
    port's through flash_mha, once per layer)."""
    cfg, ref_cfg = get_smoke(ARCH), ref_get_smoke(ARCH)
    s = 9216
    assert s > tf.FLASH_THRESHOLD
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (1, s))
    want = ref_lm.prefill_fn(ref_cfg)(ref_params,
                                      {"tokens": jnp.asarray(tokens)})
    calls = []

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw))
        return flash_mha(q, k, v, **kw)

    monkeypatch.setattr(tf, "flash_mha", spy)
    got = lm.prefill_fn(cfg)(port_params,
                             {"tokens": torch.from_numpy(tokens)})
    assert len(calls) == cfg.n_layers
    assert calls[0] == ((cfg.n_heads, s, cfg.hd),
                        dict(causal=True, q_block=tf.Q_BLOCK,
                             k_block=tf.K_BLOCK, window=None))
    assert got.shape == (1, 1, cfg.vocab)
    assert _max_err(got.numpy(), want) <= LOGIT_TOL


def test_decode_steps_match_reference(ref_params, port_params):
    cfg, ref_cfg = get_smoke(ARCH), ref_get_smoke(ARCH)
    b, S = 2, 8
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (b, S))
    ref_cache = ref_lm.init_cache(ref_cfg, b, S, dtype=jnp.float32)
    cache = lm.init_cache(cfg, b, S, dtype=torch.float32, device="cpu")
    ref_step, step = ref_lm.decode_fn(ref_cfg), lm.decode_fn(cfg)
    for t in range(S):
        want, ref_cache = ref_step(ref_params, ref_cache,
                                   jnp.asarray(tokens[:, t:t + 1]),
                                   jnp.int32(t))
        got, cache = step(port_params, cache,
                          torch.from_numpy(tokens[:, t:t + 1]), t)
        assert got.shape == (b, 1, cfg.vocab)
        assert _max_err(got.numpy(), want) <= LOGIT_TOL
        assert _max_err(cache.k.numpy(), ref_cache.k) <= LOGIT_TOL
        assert _max_err(cache.v.numpy(), ref_cache.v) <= LOGIT_TOL


def test_decode_matches_teacher_forced_forward(port_params):
    cfg = get_smoke(ARCH)
    b, s = 2, 16
    tokens = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab, (b, s)))
    full, _ = lm.forward(port_params, {"tokens": tokens}, cfg)
    cache = lm.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    step = lm.decode_fn(cfg)
    outs = []
    for t in range(s):
        lg, cache = step(port_params, cache, tokens[:, t:t + 1], t)
        outs.append(lg[:, 0])
    assert _max_err(torch.stack(outs, 1).detach().numpy(),
                    full.detach().numpy()) <= LOGIT_TOL


def test_server_matches_reference_tokens(ref_params, port_params):
    """test_system.py::test_serve_completes_all_requests's traffic through
    both servers on the same weights: the same greedy tokens.  Every pick's
    top-2 logit margin exceeds 2 · LOGIT_TOL, the most two logits can move
    against each other when each is within LOGIT_TOL of the reference
    (test_decode_steps_match_reference), so no near-tie decides a token."""
    from repro.launch.lm_serve import Request as RefRequest
    from repro.launch.lm_serve import Server as RefServer
    from repro_torch.launch.lm_serve import Request, Server

    ref = RefServer(ARCH, slots=3, max_seq=64)
    srv = Server(ARCH, slots=3, max_seq=64, device="cpu", params=port_params)
    rng = np.random.default_rng(0)
    for i in range(5):
        prompt = rng.integers(0, srv.cfg.vocab, 6).astype(np.int32)
        ref.submit(RefRequest(rid=i, prompt=prompt, max_new=4))
        srv.submit(Request(rid=i, prompt=prompt.copy(), max_new=4))
    margins = []
    decode, step_slot = srv.decode, srv._step_slot
    prefill = []

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
    assert len(srv.completed) == 5
    assert [r.rid for r in srv.completed] == [r.rid for r in ref.completed]
    assert [r.generated for r in srv.completed] \
        == [r.generated for r in ref.completed]
    assert stats["tokens"] == ref_stats["tokens"] == 20
    assert stats["steps"] == ref_stats["steps"]
    assert len(margins) == 20 and min(margins) > 2 * LOGIT_TOL


def test_unported_families_and_default_device():
    """Every family runs now; what still raises: the expert-parallel MoE
    (multi-GPU), a flash-branch length no block divides (FLASH_THRESHOLD +
    1, as the reference's ``flash_attend`` asserts; training past the
    threshold runs where the blocks divide), and the server on the
    encoder-decoder model (as the reference's)."""
    from repro_torch.launch.lm_serve import Server
    from repro_torch.models import moe

    for arch in ("mamba2-1.3b", "zamba2-1.2b", "moonshot-v1-16b-a3b",
                 "seamless-m4t-medium"):
        assert callable(lm.prefill_fn(get_smoke(arch)))
    cfg = get_smoke("moonshot-v1-16b-a3b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.float32)
    with pytest.raises(ValueError, match="current mesh"):
        moe.moe_ffn(torch.zeros((1, 8, cfg.d_model)), params.moe_layers[0],
                    cfg, ep_spec=("data", "model", None))
    s = tf.FLASH_THRESHOLD + 1
    batch = {"tokens": torch.zeros((1, s), dtype=torch.int32),
             "labels": torch.zeros((1, s), dtype=torch.int32)}
    with pytest.raises(ValueError, match="not divisible"):
        lm.lm_loss(params, batch, cfg)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        Server("seamless-m4t-medium", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(get_smoke(ARCH), 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(get_smoke("mamba2-1.3b"), 1, 4)
