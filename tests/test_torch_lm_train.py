"""Port vs reference: LM training on the dense family (llama3.2-1b's smoke
config), with the trainer's fault-recovery path.

* the first step's loss within 1e-4 and every gradient leaf within the
  reference tests' 2e-3 rtol/atol, from the reference's own weights
  (``params_from_reference``) on the same token batch;
* three AdamW steps (global-norm clip 1.0) with losses within 1e-4
  relative and the AdamW state's round trip through the reference layout;
* the port resumes a checkpoint the reference's ``train_lm`` wrote (params,
  AdamW state, token stream) and continues within 1e-4 of the reference's
  uninterrupted run; the reference resumes the port's the same way;
* ``train_lm(fault_at=4)`` on the CPU: survivors ``[0, 1, 2]``, a
  checkpoint at the miss, and a resume equal to an uninterrupted run;
* training at ``FLASH_THRESHOLD + 1`` keys raises the divisibility error
  the reference's ``flash_attend`` raises too (no block divides 8193),
  and trains with finite gradients where the blocks divide (the
  threshold lowered; ``test_torch_lm_long_train.py`` holds those
  gradients against the reference); the ``lm`` CLI trains; the
  elastic-restart example prints the reference example's survivors.

Each case jits at most one reference step.  The file runs on one intra-op
thread (the smoke model's matmuls are tiny; more threads only contend).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.data.tokens import make_lm_batch as ref_make_lm_batch  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import make_lm_batch  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw, tree_leaves, tree_map  # noqa: E402

from conftest import REPO, SRC  # noqa: E402

ARCH = "llama3.2-1b"
SEQ = 32
GRAD_TOL = 2e-3
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_params():
    params = ref_lm.init_params(jax.random.PRNGKey(0), ref_get_smoke(ARCH),
                                dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(step):
    cfg = get_smoke(ARCH)
    b = make_lm_batch(0, step, 2, SEQ, cfg.vocab)
    want = ref_make_lm_batch(0, step, 2, SEQ, cfg.vocab)
    assert all(np.array_equal(b[k], want[k]) for k in want)
    return b


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def test_first_step_gradients_match_reference(ref_params):
    cfg, ref_cfg = get_smoke(ARCH), ref_get_smoke(ARCH)
    b = _batch(0)
    loss_fn = jax.jit(jax.value_and_grad(
        lambda p, bb: ref_lm.lm_loss(p, bb, ref_cfg, chunk=16)))
    want_loss, want_g = loss_fn(ref_params,
                                {k: jnp.asarray(v) for k, v in b.items()})
    params = lm.params_from_reference(ref_params, cfg, device="cpu")
    tree = lm.param_tree(params)
    loss = lm.lm_loss(params, {k: torch.from_numpy(v) for k, v in b.items()},
                      cfg, chunk=16)
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    assert _rel(loss.detach(), want_loss) <= LOSS_TOL
    it = iter(grads)
    got = lm._tree_to_reference(tree_map(lambda _: next(it), tree))
    want = jax.tree_util.tree_map(np.asarray, want_g)
    assert sorted(got) == sorted(want)
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name in ("embed", "ln_final"):
        np.testing.assert_allclose(got[name], want[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    for name, g in want["layers"].items():
        assert got["layers"][name].shape == g.shape
        np.testing.assert_allclose(got["layers"][name], g, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
    # the parameter tree walks the reference's leaf order
    ref_order = [a.shape for a in jax.tree_util.tree_leaves(ref_params)]
    port_order = [a.shape for a in jax.tree_util.tree_leaves(
        lm.params_to_reference(params))]
    assert port_order == ref_order


def test_three_adamw_steps_match_reference(ref_params):
    cfg, ref_cfg = get_smoke(ARCH), ref_get_smoke(ARCH)
    r_opt = ref_adamw(1e-3)
    r_step = jax.jit(ref_lm.train_step_fn(ref_cfg, r_opt, chunk=16,
                                          remat=False))
    r_params, r_state = ref_params, r_opt[0](ref_params)
    opt = adamw(1e-3)
    params = lm.params_from_reference(ref_params, cfg, device="cpu")
    state = opt[0](lm.param_tree(params))
    step = lm.train_step_fn(cfg, opt, chunk=16)
    first = params
    for i in range(3):
        b = _batch(i)
        r_params, r_state, r_m = r_step(
            r_params, r_state, {k: jnp.asarray(v) for k, v in b.items()})
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in b.items()})
        assert _rel(m["loss"], r_m["loss"]) <= LOSS_TOL, i
        assert _rel(m["grad_norm"], r_m["grad_norm"]) <= 1e-3, i
    assert int(state.step) == int(r_state.step) == 3
    # the given params are left untouched (a new module each step)
    assert torch.equal(first.embed, lm.params_from_reference(
        ref_params, cfg, device="cpu").embed)
    # AdamW state round trip through the reference layout
    host = lm.opt_state_to_reference(state)
    assert host.step.dtype == np.int32 and int(host.step) == 3
    back = lm.opt_state_from_reference(host, cfg, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert torch.equal(a, b)
    want_nu = jax.tree_util.tree_map(np.asarray, r_state.nu)
    np.testing.assert_allclose(host.nu["layers"]["wq"],
                               want_nu["layers"]["wq"], rtol=1e-3, atol=1e-9)


def test_port_resumes_a_reference_checkpoint_and_back(tmp_path):
    from repro.launch.train import train_lm as ref_train_lm

    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    want = ref_train_lm(ARCH, smoke=True, steps=6, batch=2, seq=SEQ,
                        ckpt_dir=ref_dir, fault_at=2, log_every=0)
    mgr = CheckpointManager(ref_dir)
    assert mgr.latest_step() == 3                      # saved at the miss
    params, state, extra = train_mod._lm_restore(mgr, 3, get_smoke(ARCH),
                                                 "cpu")
    assert int(state.step) == 3 and extra["pipeline"]["step"] == 3
    got = train_mod.train_lm(ARCH, steps=6, batch=2, seq=SEQ,
                             ckpt_dir=ref_dir, resume=True, log_every=0,
                             device="cpu")
    assert len(got["losses"]) == 3
    for a, b in zip(got["losses"], want["losses"][3:]):
        assert _rel(a, b) <= LOSS_TOL
    # and back: the reference resumes the port's checkpoint
    out = train_mod.train_lm(ARCH, steps=3, batch=2, seq=SEQ,
                             ckpt_dir=port_dir, fault_at=1, log_every=0,
                             device="cpu")
    assert CheckpointManager(port_dir).latest_step() == 2
    back = ref_train_lm(ARCH, smoke=True, steps=3, batch=2, seq=SEQ,
                        ckpt_dir=port_dir, resume=True, log_every=0)
    assert len(back["losses"]) == 1
    assert _rel(back["losses"][0], out["losses"][2]) <= LOSS_TOL


def test_train_lm_fault_path_and_resume_on_the_cpu(tmp_path):
    ck = str(tmp_path / "ck")
    out = train_mod.train_lm(ARCH, steps=8, batch=2, seq=SEQ, ckpt_dir=ck,
                             fault_at=4, log_every=0, device="cpu")
    assert out["survivors"] == [0, 1, 2]
    assert len(out["losses"]) == len(out["step_s"]) == 8
    assert all(np.isfinite(out["losses"]))
    assert CheckpointManager(ck).latest_step() == 5     # the miss at step 4
    resumed = train_mod.train_lm(ARCH, steps=12, batch=2, seq=SEQ,
                                 ckpt_dir=ck, resume=True, log_every=0,
                                 device="cpu")
    whole = train_mod.train_lm(ARCH, steps=12, batch=2, seq=SEQ,
                               log_every=0, device="cpu")
    assert resumed["survivors"] == [0, 1, 2, 3]
    assert np.allclose(resumed["losses"], whole["losses"][5:], rtol=1e-6,
                       atol=0)
    assert CheckpointManager(ck).latest_step() == 10    # save_async
    if not torch.cuda.is_available():       # the card is the default
        with pytest.raises(RuntimeError, match="GPU"):
            train_mod.train_lm(ARCH, steps=1)


def test_training_past_flash_threshold_and_other_families_raise(
        monkeypatch):
    """At ``FLASH_THRESHOLD + 1`` keys no block divides the sequence: the
    flash branch raises the divisibility error (the reference's
    ``flash_attend`` asserts the same), for every family with attention.
    Where the blocks divide, past a lowered threshold, the same calls
    train with finite losses and gradients."""
    cfg = get_smoke(ARCH)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.float32)
    s = lm._dense.FLASH_THRESHOLD + 1

    def batch_of(n):
        return {"tokens": torch.zeros((1, n), dtype=torch.int32),
                "labels": torch.zeros((1, n), dtype=torch.int32)}

    batch = batch_of(s)
    with pytest.raises(ValueError, match="not divisible"):
        lm.lm_loss(params, batch, cfg)
    step = lm.train_step_fn(cfg, adamw(1e-3))
    state = adamw(1e-3)[0](lm.param_tree(params))
    with pytest.raises(ValueError, match="not divisible"):
        step(params, state, batch)
    # the other families with attention raise there too (zamba2's shared
    # block; seamless's encoder over the frames); mamba2 attends nowhere
    others = {}
    for arch in ("zamba2-1.2b", "moonshot-v1-16b-a3b", "seamless-m4t-medium"):
        other = get_smoke(arch)
        p = lm.init_params(torch.Generator().manual_seed(0), other,
                           dtype=torch.float32)
        others[arch] = (other, p)
        b = dict(batch)
        if other.family == "encdec":
            b = {"tokens": batch["tokens"][:, :8],
                 "labels": batch["labels"][:, :8],
                 "frames": torch.zeros((1, s, other.d_model))}
        with pytest.raises(ValueError, match="not divisible"):
            lm.lm_loss(p, b, other)
    ssm = get_smoke("mamba2-1.3b")
    p = lm.init_params(torch.Generator().manual_seed(0), ssm,
                       dtype=torch.float32)
    assert torch.isfinite(lm.lm_loss(p, {k: v[:, :64] for k, v in
                                         batch.items()}, ssm))
    # where the blocks divide (past a lowered threshold), they train
    monkeypatch.setattr(lm._dense, "FLASH_THRESHOLD", 512)
    good = batch_of(1024)
    new, _, metrics = step(params, state, good)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    for arch, (other, p) in others.items():
        b = dict(good)
        if other.family == "encdec":
            b = {"tokens": good["tokens"][:, :512],
                 "labels": good["labels"][:, :512],
                 "frames": torch.zeros((1, 1024, other.d_model))}
        loss = lm.lm_loss(p, b, other)
        grads = torch.autograd.grad(loss, list(p.parameters()))
        assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                            for g in grads), arch


def test_lm_cli_trains_the_smoke_config(capsys):
    train_mod.main(["lm", "--arch", ARCH, "--steps", "2", "--seq", "16",
                    "--device", "cpu"])
    assert re.search(r"final loss \d+\.\d+ survivors=\[0, 1, 2, 3\]",
                     capsys.readouterr().out)


def test_elastic_restart_example_matches_the_reference_example():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    outs = []
    for args in (["torch_elastic_restart.py", "--device", "cpu"],
                 ["elastic_restart.py"]):
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "examples", args[0]),
             *args[1:]], env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout)
    for key in ("survivors:", "survivor mesh plan:", "resuming from step"):
        lines = [[ln for ln in o.splitlines() if ln.startswith(key)]
                 for o in outs]
        assert lines[0] == lines[1] and lines[0], key


def test_chip_smoke_lm_training_phase_rehearsal(tmp_path, monkeypatch,
                                                capsys):
    """Phase 14 end to end on the CPU with the smoke config standing in for
    the published one, host-side memory counters and the elastic example
    replaced by a stub: every gate passes (card vs CPU, the fault path's
    survivors and checkpoint, resume drift) and nothing launches
    ``flash_mha``."""
    import importlib

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    configs = importlib.import_module("repro_torch.configs")
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    monkeypatch.setattr(train_mod, "get_config", configs.get_smoke)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "ELASTIC_EXAMPLE_ARGS",
                        ("-c", "print('survivors: [0, 1, 2]')"))
    out, launches = cs.lm_train_phase(torch, torch.device("cpu"))
    cs.print_lm_train(out, "a host, no card")
    full = out["full"]
    assert len(full["losses"]) == cs.LM_TRAIN_STEPS
    assert full["params"] == sum(
        p.numel() for p in lm.init_params(torch.Generator(), get_smoke(ARCH),
                                          dtype=torch.float32).parameters())
    assert out["gate"]["card_vs_cpu_rel"] == 0.0
    assert out["fault"]["survivors"] == [0, 1, 2]
    assert out["fault"]["checkpoint_step"] == cs.LM_FAULT_AT + 1
    assert out["fault"]["resume_drift"] <= cs.LM_RESUME_TOL
    assert all(v["flash_mha"] == 0 for v in launches.values())
    assert not list(tmp_path.iterdir())        # the checkpoint is removed
    assert "lm training gate" in capsys.readouterr().out
