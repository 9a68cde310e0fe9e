"""Port vs reference: LM training past ``FLASH_THRESHOLD``, on the CPU.

Both packages' ``FLASH_THRESHOLD`` is lowered to 1024 for the module, so a
2048-token step (both packages' ``Q_BLOCK`` 512 and ``K_BLOCK`` 1024 divide
it) reaches the flash branch: the reference's XLA scan under ``jax.grad``,
the port's ``flash_mha`` through its ``autograd.Function`` (plain forward
and plain backward here; the CUDA kernels in ``chip_smoke.py`` phase 16).

* the first step's loss within 1e-4 and every gradient leaf within the
  reference tests' 2e-3 rtol/atol of ``jax.value_and_grad`` of the
  reference's ``lm_loss``, from the reference's own weights, for the smoke
  configs of llama3.2-1b, gemma3-27b (windowed layers and a global one),
  moonshot-v1-16b-a3b, zamba2-1.2b and seamless-m4t-medium (non-causal
  encoder over 2048 frames and cross-attention, sq 512 != sk 2048); the
  port's attention went through ``flash_mha``;
* ``remat=True`` and ``remat=False`` give bit-equal losses and gradients
  for every family (mamba2 too);
* ``launch/steps.py::build_step``'s train, prefill and decode steps match
  the reference's ``build_step`` steps on the smoke config (the AdamW
  step's parameters within 1e-4, as one step is held in
  ``test_torch_lm_families_train.py``); another kind
  raises ``ValueError``, and so does a MoE step given an ``ep_spec``
  without a current mesh.

The file runs on one intra-op thread.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.data.tokens import make_lm_batch as ref_make_lm_batch  # noqa: E402
from repro.launch.steps import build_step as ref_build_step  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import make_lm_batch  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw, tree_leaves, tree_map  # noqa: E402

THRESHOLD, SEQ = 1024, 2048
CHUNK = 16                 # the SSM scan chunk (train_lm's): at 64 the
                           # reference's SSD gradient is NaN at this length
GRAD_TOL, LOSS_TOL, STEP_TOL = 2e-3, 1e-4, 1e-4
ATTENTION_ARCHS = ("llama3.2-1b", "gemma3-27b", "moonshot-v1-16b-a3b",
                   "zamba2-1.2b", "seamless-m4t-medium")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _low_threshold():
    saved = ref_tf.FLASH_THRESHOLD, tf.FLASH_THRESHOLD
    ref_tf.FLASH_THRESHOLD = tf.FLASH_THRESHOLD = THRESHOLD
    yield
    ref_tf.FLASH_THRESHOLD, tf.FLASH_THRESHOLD = saved


def _batch(cfg, seq=SEQ):
    """One batch of the token stream (encdec: ``seq`` stub frames and
    ``seq // 4`` decoder tokens, as ``train_lm``), equal in both
    packages."""
    frames = seq if cfg.family == "encdec" else 0
    got = make_lm_batch(0, 0, 1, seq, cfg.vocab, enc_frames=frames,
                        d_model=cfg.d_model)
    want = ref_make_lm_batch(0, 0, 1, seq, cfg.vocab, enc_frames=frames,
                             d_model=cfg.d_model)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    if cfg.family == "encdec":
        for k in ("tokens", "labels"):
            got[k] = got[k][:, :seq // 4]
    return got


def _ref_params(arch):
    return jax.tree_util.tree_map(np.asarray, ref_lm.init_params(
        jax.random.PRNGKey(0), ref_get_smoke(arch), dtype=jnp.float32))


@pytest.fixture(scope="module")
def port_run():
    """(arch, remat) → (loss, gradients as the reference's tree, flash
    calls) of the port's ``lm_loss`` on the reference's weights, each
    computed once."""
    cache = {}

    def get(arch, remat):
        if (arch, remat) not in cache:
            cfg = get_smoke(arch)
            params = lm.params_from_reference(_ref_params(arch), cfg,
                                              device="cpu")
            seq = SEQ if cfg.family != "ssm" else 256
            batch = {k: torch.from_numpy(v)
                     for k, v in _batch(cfg, seq).items()}
            calls = []
            flash = tf.flash_mha

            def counting(*args, **kw):
                calls.append(kw.get("window"))
                return flash(*args, **kw)

            tf.flash_mha = counting
            try:
                tree = lm.param_tree(params)
                loss = lm.lm_loss(params, batch, cfg, chunk=CHUNK,
                                  remat=remat)
                grads = iter(torch.autograd.grad(loss, tree_leaves(tree)))
            finally:
                tf.flash_mha = flash
            cache[(arch, remat)] = (
                loss.detach(), lm._tree_to_reference(
                    tree_map(lambda _: next(grads), tree)), calls)
        return cache[(arch, remat)]

    return get


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_training_past_the_threshold_matches_jax_grad(port_run, arch):
    cfg = get_smoke(arch)
    ref_cfg = ref_get_smoke(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.lm_loss(p, b, ref_cfg, chunk=CHUNK)))(
            _ref_params(arch), batch)
    loss, grads, calls = port_run(arch, False)
    assert calls, "the port's attention did not reach flash_mha"
    if arch == "gemma3-27b":                 # 5 windowed layers, 1 global
        assert calls.count(None) == 1 and len(calls) == cfg.n_layers
    assert abs(float(loss) - float(want_loss)) \
        <= LOSS_TOL * abs(float(want_loss))
    got = jax.tree_util.tree_flatten_with_path(grads)[0]
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want_g))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=str(key))


@pytest.mark.parametrize("arch", ATTENTION_ARCHS + ("mamba2-1.3b",))
def test_remat_gives_the_same_bits(port_run, arch):
    loss, grads, calls = port_run(arch, False)
    r_loss, r_grads, r_calls = port_run(arch, True)
    assert torch.equal(loss, r_loss)
    # with remat each layer's attention runs again in the backward (the
    # hybrid's shared block is kept, as the reference's)
    hybrid = get_smoke(arch).family == "hybrid"
    assert len(r_calls) == (1 if hybrid else 2) * len(calls)
    flat = jax.tree_util.tree_leaves(grads)
    r_flat = jax.tree_util.tree_leaves(r_grads)
    assert len(flat) == len(r_flat)
    for a, b in zip(flat, r_flat):
        np.testing.assert_array_equal(a, b)


def test_build_step_matches_the_reference():
    arch, seq = "llama3.2-1b", 64
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    ref_params = _ref_params(arch)
    params = lm.params_from_reference(ref_params, cfg, device="cpu")
    b = _batch(cfg, seq)
    # train: remat on, AdamW at 3e-4 (the reference's defaults)
    want_p, _, want_m = jax.jit(ref_build_step(ref_cfg, "train"))(
        ref_params, ref_adamw(3e-4)[0](ref_params),
        {k: jnp.asarray(v) for k, v in b.items()})
    got_p, _, got_m = build_step(cfg, "train")(
        params, adamw(3e-4)[0](lm.param_tree(params)),
        {k: torch.from_numpy(v) for k, v in b.items()})
    for key in ("loss", "grad_norm"):
        assert abs(float(got_m[key]) - float(want_m[key])) \
            <= LOSS_TOL * abs(float(want_m[key]))
    got = jax.tree_util.tree_leaves(lm.params_to_reference(got_p))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            want_p))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=STEP_TOL, atol=STEP_TOL)
    # prefill: the last position's logits
    tokens = b["tokens"]
    want = jax.jit(ref_build_step(ref_cfg, "prefill"))(
        ref_params, {"tokens": jnp.asarray(tokens)})
    got = build_step(cfg, "prefill")(params,
                                     {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape == (1, 1, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # decode: one token on an empty cache
    cache = ref_lm.init_cache(ref_cfg, 1, 16, dtype=jnp.float32)
    want, _ = jax.jit(ref_build_step(ref_cfg, "decode"))(
        ref_params, cache, jnp.asarray(tokens[:, :1]), jnp.int32(0))
    got, _ = build_step(cfg, "decode")(
        params, lm.init_cache(cfg, 1, 16, torch.float32, device="cpu"),
        torch.from_numpy(tokens[:, :1]), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for bad in ("dryrun", "serve"):
        with pytest.raises(ValueError):
            ref_build_step(ref_cfg, bad)
        with pytest.raises(ValueError, match="kind"):
            build_step(cfg, bad)
    # ep_spec without a current mesh: the MoE layers refuse
    moe_cfg = get_smoke("moonshot-v1-16b-a3b")
    params = lm.init_params(torch.Generator().manual_seed(0), moe_cfg,
                            dtype=torch.float32)
    step = build_step(moe_cfg, "train", ep_spec=("data", "model", None,
                                                 None))
    with pytest.raises(ValueError, match="current mesh"):
        step(params, adamw(3e-4)[0](lm.param_tree(params)),
             {k: torch.from_numpy(v) for k, v in _batch(moe_cfg, seq).items()})
