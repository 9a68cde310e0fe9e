"""Port vs reference: the Weight-Bank gradient sync (int8 error-feedback
hypercube all-reduce), the health monitor, the elastic scale plan, the
token pipeline and the LM optimizers, on the same numpy inputs.

* ``compressed_psum`` and two ``ef_compress_grads`` steps are bit-equal
  to the reference's at P = 2 and 4, the reference executed op by op
  (``jax.vmap`` over the named axis carries its ``axis_index`` and
  ``ppermute``), the port on the stacked core axis.  Rounding is half to
  even in both, and every division, clip and add is the reference's.  ONE
  subprocess with 4 forced CPU devices also runs the reference jitted under
  ``shard_map``, whose compiler rewrites two operations (see that test):
  the port stays within one int8 step of it.
* the ``ValueError``s of both: non-power-of-two core counts, and exactly
  one of ``ndim=`` / ``n_cores=``.
* ``HealthMonitor``: the reference's lifecycle test and randomized
  heartbeat traces give equal actions, logs and survivors.
* ``scale_plan`` equal; ``TokenPipeline`` tokens and resume equal.
* ``adamw`` / ``clip_by_global_norm`` / ``cosine_schedule`` within 1e-6
  of the reference over a few steps.
"""
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import health as ref_health  # noqa: E402
from repro.checkpoint.elastic import scale_plan as ref_scale_plan  # noqa: E402
from repro.data import tokens as ref_tokens  # noqa: E402
from repro.distributed import compress as ref_compress  # noqa: E402
from repro.models.config import ArchConfig as RefArchConfig  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.checkpoint import (Action, HealthMonitor,  # noqa: E402
                                    gather_global, scale_plan)
from repro_torch.data import (TokenPipeline, make_lm_batch,  # noqa: E402
                              synthetic_frames)
from repro_torch.distributed import (compressed_psum,  # noqa: E402
                                     compression_ratio, ef_compress_grads,
                                     init_error_state)
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.optim import (adamw, apply_updates,  # noqa: E402
                               clip_by_global_norm, cosine_schedule)

from conftest import run_subprocess  # noqa: E402

EF_SHAPES = {"w": (33, 7), "b": (5,)}     # 231 and 5: both padded at P = 4


def _inputs(P):
    rng = np.random.default_rng(P)
    x = rng.standard_normal((P, 4096)).astype(np.float32) \
        * rng.uniform(0.1, 10, (P, 1)).astype(np.float32)
    grads = {k: rng.standard_normal((P,) + s).astype(np.float32)
             for k, s in EF_SHAPES.items()}
    return x, grads


def _reference_eager(P):
    """The reference's ``compressed_psum`` and two ``ef_compress_grads``
    steps, executed op by op: ``jax.vmap`` over a named axis carries the
    reference's own collectives (``axis_index``, ``ppermute``)."""
    x, grads = _inputs(P)
    out = {"psum": np.asarray(jax.vmap(
        lambda v: ref_compress.compressed_psum(v, "core", n_cores=P),
        axis_name="core")(jnp.asarray(x)))}
    step = jax.vmap(lambda g, e: ref_compress.ef_compress_grads(
        g, e, "core", n_cores=P), axis_name="core")
    one = ref_compress.init_error_state({k: jnp.zeros(s) for k, s in
                                         EF_SHAPES.items()}, P)
    err = {k: jnp.tile(v[None], (P, 1)) for k, v in one.items()}
    g = {k: jnp.asarray(v) for k, v in grads.items()}
    for i in range(2):
        mean, err = step(g, err)
        for k in g:
            out[f"mean{i}_{k}"] = np.asarray(mean[k])
            out[f"err{i}_{k}"] = np.asarray(err[k])
    return out


def _port(P):
    x, grads = _inputs(P)
    out = {"psum": compressed_psum(torch.from_numpy(x), n_cores=P).numpy()}
    g = {k: torch.from_numpy(v) for k, v in grads.items()}
    err = init_error_state({k: torch.zeros(s) for k, s in
                            EF_SHAPES.items()}, P)
    for i in range(2):
        mean, err = ef_compress_grads(g, err, n_cores=P)
        for k in g:
            assert mean[k].shape == g[k].shape
            out[f"mean{i}_{k}"] = mean[k].numpy()
            out[f"err{i}_{k}"] = err[k].numpy()
    return out


@pytest.mark.parametrize("P", [2, 4])
def test_compressed_psum_and_error_feedback_bit_equal_reference(P):
    """Bit-equal to the reference's arithmetic as its source writes it
    (division by 127, ``mine + dequant`` as a multiply then an add)."""
    got, want = _port(P), _reference_eager(P)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    x, _ = _inputs(P)
    exact = x.astype(np.float64).sum(0)
    rel = np.abs(got["psum"][0] - exact).max() / np.abs(exact).max()
    assert 0 < rel < 0.05, rel
    assert (got["psum"] == got["psum"][:1]).all()        # every core agrees
    ndim_form = compressed_psum(torch.from_numpy(x), P.bit_length() - 1)
    assert np.array_equal(ndim_form.numpy(), got["psum"])


_JITTED = textwrap.dedent("""
    import sys
    import jax, numpy as np, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.distributed.compress import compressed_psum

    d = np.load(sys.argv[1])
    out = {}
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ('core',))
        psum = jax.jit(shard_map(
            lambda xl: compressed_psum(xl[0], 'core', n_cores=n)[None],
            mesh=mesh, in_specs=(P('core'),), out_specs=P('core')))
        out[f'psum{n}'] = np.asarray(psum(jnp.asarray(d[f'x{n}'])))
    np.savez(sys.argv[2], **out)
    print('done')
""")


def test_compressed_psum_near_the_jitted_reference_on_forced_devices(
        tmp_path):
    """The reference jitted under ``shard_map`` on 2 and 4 forced CPU
    devices.  XLA rewrites ``/ 127.0`` into a multiply by the reciprocal
    and fuses ``mine + q·s`` into one FMA, so the compiled program rounds
    a few partial sums one ulp away from the source's arithmetic, and an
    int8 code can flip: the port stays within one code step (the final
    scale) of it."""
    np.savez(tmp_path / "in.npz", **{f"x{P}": _inputs(P)[0] for P in (2, 4)})
    code = (f"import sys; sys.argv = ['-', {str(tmp_path / 'in.npz')!r}, "
            f"{str(tmp_path / 'out.npz')!r}]\n" + _JITTED)
    assert "done" in run_subprocess(code, n_devices=4)
    want = np.load(tmp_path / "out.npz")
    for P in (2, 4):
        x, _ = _inputs(P)
        got = compressed_psum(torch.from_numpy(x), n_cores=P).numpy()
        step = np.abs(got).max() / 127.0 * 1.01
        assert np.abs(got - want[f"psum{P}"]).max() <= step


def test_error_feedback_keeps_the_mean_unbiased():
    """The reference test's bound (``tests/test_distributed.py``) at P = 4
    on the port alone: 8 EF steps from zero residuals, bias < 0.02."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((4, 1024))
                               .astype(np.float32))}
    err = init_error_state({"w": torch.zeros(1024)}, 4)
    acc = torch.zeros(1024)
    for _ in range(8):
        mean, err = ef_compress_grads(g, err, 2)
        acc += mean["w"][0]
        assert torch.equal(mean["w"][0], mean["w"][3])   # all cores agree
    ref_mean = g["w"].mean(0)
    bias = (acc / 8 - ref_mean).abs().max() / ref_mean.abs().max()
    assert bias < 0.02, float(bias)


def test_compress_value_errors_match_reference():
    x = torch.zeros((3, 12))
    for fn in (lambda: compressed_psum(x, n_cores=3),
               lambda: ref_compress.compressed_psum(jnp.zeros(12), "c",
                                                    n_cores=3),
               lambda: ef_compress_grads({}, {}, n_cores=6),
               lambda: ref_compress.ef_compress_grads({}, {}, "c",
                                                      n_cores=6)):
        with pytest.raises(ValueError, match="power-of-two"):
            fn()
    for fn in (lambda: compressed_psum(x),
               lambda: compressed_psum(x, 1, n_cores=2),
               lambda: ref_compress.compressed_psum(jnp.zeros(12), "c"),
               lambda: ef_compress_grads({}, {}),
               lambda: ref_compress.ef_compress_grads({}, {}, "c", 1,
                                                      n_cores=2)):
        with pytest.raises(ValueError, match="exactly one"):
            fn()
    with pytest.raises(ValueError, match="divisible"):
        compressed_psum(torch.zeros((4, 10)), n_cores=4)
    with pytest.raises(ValueError, match=r"\[2, n\]"):
        compressed_psum(torch.zeros((4, 16)), n_cores=2)
    assert compression_ratio() == ref_compress.compression_ratio() == 4.0
    assert compression_ratio(2) == ref_compress.compression_ratio(2)
    for n in (1, 2, 8, 1024):
        assert ref_compress._hypercube_ndim(n) == \
            __import__("repro_torch.distributed.compress", fromlist=["x"]
                       )._hypercube_ndim(n)


# ---------------------------------------------------------------------------
# health monitor, elastic plan
# ---------------------------------------------------------------------------
def _lifecycle(health):
    hm = health.HealthMonitor(4, straggler_factor=1.5, patience=2,
                              miss_limit=2)
    trace = [[1, 1, 1, 1], [1, 1, 1, 4.0], [1, 1, 1, 4.0],
             [1, 1, 1, None], [1, 1, 1, None], [1, 1, 1, 1]]
    acts = [{k: v.value for k, v in hm.report_step(i, t).items()}
            for i, t in enumerate(trace)]
    return acts, hm.log, hm.survivors(), hm.n_alive()


def test_health_lifecycle_equals_reference():
    got = _lifecycle(__import__("repro_torch.checkpoint.health",
                                fromlist=["x"]))
    assert got == _lifecycle(ref_health)
    acts, _, survivors, alive = got
    assert acts[2] == {3: "rebalance"} and acts[3] == {3: "checkpoint_now"}
    assert acts[4] == {3: "evict_and_reshard"} and acts[5] == {}
    assert survivors == [0, 1, 2] and alive == 3
    assert [a.value for a in Action] == [a.value for a in ref_health.Action]


@pytest.mark.parametrize("seed", range(6))
def test_health_random_traces_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    kw = dict(straggler_factor=float(rng.uniform(1.1, 2.5)),
              patience=int(rng.integers(1, 4)),
              miss_limit=int(rng.integers(1, 4)))
    mons = (HealthMonitor(n, **kw), ref_health.HealthMonitor(n, **kw))
    for step in range(40):
        times = [None if rng.random() < 0.08 else
                 float(rng.choice([1.0, 1.2, 3.0, 5.0])) for _ in range(n)]
        a, b = (m.report_step(step, times) for m in mons)
        assert {k: v.value for k, v in a.items()} == \
            {k: v.value for k, v in b.items()}
        assert mons[0].survivors() == mons[1].survivors()
    assert mons[0].log == mons[1].log
    assert [dataclass_tuple(w) for w in mons[0].workers] == \
        [dataclass_tuple(w) for w in mons[1].workers]


def dataclass_tuple(w):
    return (w.worker_id, w.alive, w.missed_heartbeats, w.slow_streak)


def test_scale_plan_and_gather_global_equal_reference():
    for n in (1, 3, 8, 15, 16, 17, 31, 240, 255, 256, 1000):
        for mp in (1, 4, 16):
            for gb in (7, 256, 1024):
                kw = dict(model_parallel=mp, global_batch=gb)
                if gb < n // mp:          # fewer samples than replicas
                    for fn in (scale_plan, ref_scale_plan):
                        with pytest.raises(ZeroDivisionError):
                            fn(n, **kw)
                    continue
                got, want = scale_plan(n, **kw), ref_scale_plan(n, **kw)
                assert (got.mesh_shape, got.axis_names, got.n_devices,
                        got.per_device_batch_scale) == \
                    (want.mesh_shape, want.axis_names, want.n_devices,
                     want.per_device_batch_scale)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    host = gather_global(tree)
    assert isinstance(host["a"], np.ndarray) and isinstance(host["b"], list)
    assert np.array_equal(host["a"], np.arange(6.0).reshape(2, 3))


# ---------------------------------------------------------------------------
# token pipeline
# ---------------------------------------------------------------------------
def test_token_pipeline_equals_reference_and_resumes():
    kw = dict(name="t", family="dense", n_layers=1, d_model=8, n_heads=1,
              n_kv_heads=1, d_ff=16, vocab=100)
    cfg, ref_cfg = ArchConfig(**kw), RefArchConfig(**kw)
    p, rp = (TokenPipeline(cfg, batch=2, seq=16, seed=9),
             ref_tokens.TokenPipeline(ref_cfg, batch=2, seq=16, seed=9))
    for _ in range(3):
        a, b = next(p), next(rp)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert p.state() == rp.state() == {"seed": 9, "step": 3}
    want = next(rp)
    p2 = TokenPipeline(cfg, batch=2, seq=16, seed=0)
    p2.restore(p.state())
    got = next(p2)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    a = make_lm_batch(3, 7, 2, 8, 50, enc_frames=4, d_model=6)
    b = ref_tokens.make_lm_batch(3, 7, 2, 8, 50, enc_frames=4, d_model=6)
    assert a.keys() == b.keys() == {"tokens", "labels", "frames"}
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert np.array_equal(synthetic_frames(4, 2, 3, 5),
                          ref_tokens.synthetic_frames(4, 2, 3, 5))


# ---------------------------------------------------------------------------
# LM optimizers
# ---------------------------------------------------------------------------
def _tree(rng):
    return {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "d": rng.standard_normal((2, 3)).astype(np.float32)}}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def _close(port, ref, tol=1e-6):
    if isinstance(port, dict):
        for k in port:
            _close(port[k], ref[k], tol)
        return
    a = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(a, np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_clip_and_schedule_match_reference(schedule, weight_decay):
    rng = np.random.default_rng(int(schedule) * 2 + int(weight_decay > 0))
    params = _tree(rng)
    p_port, p_ref = _to(params, torch.from_numpy), _to(params, jnp.asarray)
    lr = cosine_schedule(1e-2, 2, 6) if schedule else 1e-2
    ref_lr = ref_opt.cosine_schedule(1e-2, 2, 6) if schedule else 1e-2
    init, update = adamw(lr, weight_decay=weight_decay)
    r_init, r_update = ref_opt.adamw(ref_lr, weight_decay=weight_decay)
    state, r_state = init(p_port), r_init(p_ref)
    assert state.step.dtype == torch.int32
    for step in range(4):
        g = _tree(rng)
        g = _to(g, lambda a: a * (4.0 if step % 2 else 0.05))
        g_port, gnorm = clip_by_global_norm(_to(g, torch.from_numpy), 1.0)
        g_ref, r_gnorm = ref_opt.clip_by_global_norm(_to(g, jnp.asarray),
                                                     1.0)
        _close(gnorm, r_gnorm)
        _close(g_port, g_ref)
        upd, state = update(g_port, state, p_port)
        r_upd, r_state = r_update(g_ref, r_state, p_ref)
        p_port = apply_updates(p_port, upd)
        p_ref = ref_opt.apply_updates(p_ref, r_upd)
        _close(state.mu, r_state.mu)
        _close(state.nu, r_state.nu)
        _close(p_port, p_ref)
        assert int(state.step) == int(r_state.step) == step + 1
    for s in range(9):
        _close(cosine_schedule(1e-2, 2, 6)(torch.tensor(s, dtype=torch.int32)),
               ref_opt.cosine_schedule(1e-2, 2, 6)(jnp.asarray(s, jnp.int32)))
