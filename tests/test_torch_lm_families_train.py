"""Port vs reference: training the MoE, SSM, hybrid and encoder-decoder LM
families (the SMOKE configs of moonshot-v1-16b-a3b,
llama4-maverick-400b-a17b, mamba2-1.3b, zamba2-1.2b and
seamless-m4t-medium), on the reference's own weights carried over by
``params_from_reference``.

* ``lm_loss`` within 1e-5 relative and every gradient leaf within the
  reference tests' 2e-3 rtol/atol of ``jax.value_and_grad``;
* one AdamW step (global-norm clip 1.0): the grad norm within 1e-3
  relative, both moments within 1e-4 of the reference optimizer's, the
  next batch's loss on the new weights within 1e-4 relative of the
  reference's on its new weights, and the AdamW state's round trip
  through the reference layout.  (The new weights are not held leaf by
  leaf: AdamW's first step moves a weight by lr·g/(|g| + 1e-8), so a
  gradient of ~1e-8 within 1e-10 of the reference's moves it by a few
  1e-5 of lr's 1e-3 either way);
* ``train_lm`` trains each family on the CPU (encdec on stub frames), and
  the reference restores the port's zamba2 checkpoint (hybrid's one shared
  block is a single-layer subtree): its loss there within 1e-4.

Each architecture jits one reference function, its loss and gradients.
The file runs on one intra-op thread (the smoke models are tiny).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.data.tokens import make_lm_batch as ref_make_lm_batch  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import apply_updates as ref_apply_updates  # noqa: E402
from repro.optim import clip_by_global_norm as ref_clip  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import make_lm_batch  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw, tree_leaves, tree_map  # noqa: E402

ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b", "mamba2-1.3b",
         "zamba2-1.2b", "seamless-m4t-medium")
GRAD_TOL, STEP_TOL, LOSS_TOL = 2e-3, 1e-4, 1e-5
SEQ, CHUNK = 16, 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, step=0):
    """A step of the token stream (encdec: stub frames of ``SEQ``
    positions and ``SEQ // 4`` decoder tokens, as ``train_lm``), equal in
    both packages."""
    frames = SEQ if cfg.family == "encdec" else 0
    got = make_lm_batch(0, step, 2, SEQ, cfg.vocab, enc_frames=frames,
                        d_model=cfg.d_model)
    want = ref_make_lm_batch(0, step, 2, SEQ, cfg.vocab, enc_frames=frames,
                             d_model=cfg.d_model)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    if cfg.family == "encdec":
        for k in ("tokens", "labels"):
            got[k] = got[k][:, :SEQ // 4]
    return got


@pytest.fixture(scope="module")
def reference():
    """arch → (reference params, loss, gradients on step 0's batch, the
    jitted loss-and-gradients function), each computed once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            ref_cfg = ref_get_smoke(arch)
            params = jax.tree_util.tree_map(np.asarray, ref_lm.init_params(
                jax.random.PRNGKey(0), ref_cfg, dtype=jnp.float32))
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: ref_lm.lm_loss(p, b, ref_cfg, chunk=CHUNK)))
            loss, grads = fn(params, _jnp(_batch(get_smoke(arch))))
            cache[arch] = (params, loss, grads, fn)
        return cache[arch]

    return get


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port(arch, ref_params):
    cfg = get_smoke(arch)
    return cfg, lm.params_from_reference(ref_params, cfg, device="cpu"), \
        _torch(_batch(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_jax_grad(reference, arch):
    ref_params, want_loss, want_g, _ = reference(arch)
    cfg, params, batch = _port(arch, ref_params)
    tree = lm.param_tree(params)
    loss = lm.lm_loss(params, batch, cfg, chunk=CHUNK)
    grads = iter(torch.autograd.grad(loss, tree_leaves(tree)))
    got = jax.tree_util.tree_flatten_with_path(
        lm._tree_to_reference(tree_map(lambda _: next(grads), tree)))[0]
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want_g))[0]
    assert abs(float(loss.detach()) - float(want_loss)) \
        <= LOSS_TOL * abs(float(want_loss))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=str(key))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_reference(reference, arch):
    """The port's ``train_step_fn`` against the reference's own optimizer
    applied as its ``train_step_fn`` applies it (clip, AdamW update,
    ``apply_updates``) to the reference's gradients."""
    ref_params, want_loss, want_g, loss_fn = reference(arch)
    r_opt = ref_adamw(1e-3)

    def r_step(g, p):
        g, norm = ref_clip(g, 1.0)
        updates, state = r_opt[1](g, r_opt[0](p), p)
        return ref_apply_updates(p, updates), state, norm

    r_new, r_state, r_norm = jax.jit(r_step)(want_g, ref_params)
    cfg, params, batch = _port(arch, ref_params)
    opt = adamw(1e-3)
    new, state, m = lm.train_step_fn(cfg, opt, chunk=CHUNK)(
        params, opt[0](lm.param_tree(params)), batch)
    assert abs(float(m["loss"]) - float(want_loss)) \
        <= LOSS_TOL * abs(float(want_loss))
    assert abs(float(m["grad_norm"]) - float(r_norm)) <= 1e-3 * float(r_norm)
    host = lm.opt_state_to_reference(state)
    assert int(host.step) == int(r_state.step) == 1
    for got, want in ((host.mu, r_state.mu), (host.nu, r_state.nu)):
        got, want = (jax.tree_util.tree_leaves(t) for t in (got, want))
        assert len(got) == len(want)
        for a, w in zip(got, want):
            assert float(np.abs(a - np.asarray(w)).max()) <= STEP_TOL
    nxt = _batch(cfg, step=1)
    want_next, _ = loss_fn(r_new, _jnp(nxt))
    with torch.no_grad():
        got_next = lm.lm_loss(new, _torch(nxt), cfg, chunk=CHUNK)
    assert abs(float(got_next) - float(want_next)) \
        <= STEP_TOL * abs(float(want_next))
    back = lm.opt_state_from_reference(host, cfg, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ("moonshot-v1-16b-a3b", "mamba2-1.3b",
                                  "zamba2-1.2b", "seamless-m4t-medium"))
def test_train_lm_trains_every_family_on_the_cpu(arch):
    out = train_mod.train_lm(arch, steps=3, batch=2, seq=32, log_every=0,
                             device="cpu")
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    assert out["survivors"] == [0, 1, 2, 3]


def test_reference_resumes_the_ports_hybrid_checkpoint(reference, tmp_path):
    """The port's zamba2 checkpoint, written at a heartbeat miss, restored
    by the reference's ``CheckpointManager`` into the reference's
    ``(params, AdamWState)`` structure: the reference's loss on it equals
    the port's loss at that step."""
    from repro.checkpoint import CheckpointManager as RefCheckpointManager

    arch, ck = "zamba2-1.2b", str(tmp_path / "ck")
    out = train_mod.train_lm(arch, steps=3, batch=2, seq=SEQ, ckpt_dir=ck,
                             fault_at=1, log_every=0, device="cpu")
    assert CheckpointManager(ck).latest_step() == 2     # the miss at step 1
    params, state, _ = train_mod._lm_restore(CheckpointManager(ck), 2,
                                             get_smoke(arch), "cpu")
    assert int(state.step) == 2 and sorted(lm.param_tree(params)) == [
        "embed", "ln_final", "mamba_layers", "shared"]
    ref_params, _, _, loss_fn = reference(arch)
    (r_params, r_state), extra = RefCheckpointManager(ck).restore(
        2, (ref_params, ref_adamw(1e-3)[0](ref_params)))
    assert int(r_state.step) == 2 and extra["pipeline"]["step"] == 2
    loss, _ = loss_fn(r_params, _jnp(_batch(get_smoke(arch), step=2)))
    assert abs(float(loss) - out["losses"][2]) <= 1e-4 * out["losses"][2]
