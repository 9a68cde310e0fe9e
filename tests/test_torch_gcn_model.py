"""Port vs reference: the paper's GCN model and its Table-1 arms.

Both packages get the same numpy inputs, built from a seed:

* the Graph Converter's re-sorts give equal arrays;
* ``gcn_layer`` (ours: the transpose-free written backward) and
  ``gcn_layer_baseline`` (naive: transposed residuals and an ``Aᵀ``
  table), CoAg/AgCo × activate, forward within 1e-5 and gradients within
  rtol 1e-4 / atol 1e-5 of the reference (its own bounds,
  ``tests/test_gcn_dataflow.py``); the port's ours equals its naive; the
  ``coo`` layer's forward is ``torch.equal`` to ``segment_sum_rows`` over
  ``gemm``; ``residual_bytes*`` are equal;
* ``gcn_forward``, ``gcn_loss`` and ``accuracy`` for gcn/sage,
  single-label/multilabel, ours/naive, with padded seed rows;
* momentum SGD over 5 steps (equal bits);
* ``train_gcn``'s naive and sage arms for 5 steps at a small scale,
  resumed by both packages from one reference-layout checkpoint (loss
  histories within 1e-4), and the reference loop's ``ValueError``s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.configs.gcn_paper import gcn_config as ref_gcn_config  # noqa: E402
from repro.core import baseline as ref_baseline  # noqa: E402
from repro.core import gcn as ref_gcn  # noqa: E402
from repro.graph import convert as ref_convert  # noqa: E402
from repro.graph import from_edges as ref_from_edges  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import gcn_model as ref_model  # noqa: E402
from repro.optim import apply_updates as ref_apply  # noqa: E402
from repro.optim import sgd as ref_sgd  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.gcn_paper import gcn_config  # noqa: E402
from repro_torch.core import baseline, gcn  # noqa: E402
from repro_torch.graph import convert, from_edges  # noqa: E402
from repro_torch.kernels import edgeplan, gemm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import gcn_model  # noqa: E402
from repro_torch.optim import SGDState, apply_updates, sgd  # noqa: E402

FWD_TOL = 1e-5                       # the reference's forward bound
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5    # the reference's gradient bound
LOSS_TOL = 1e-4                      # 5-step loss histories
TRAIN = dict(scale=0.004, feat_dim=16, hidden=16, batch_size=40, steps=5,
             lr=0.05, seed=0, log_every=0)


def _edges(rng, n_dst, n_src, e):
    """Random edges with a hub row, a hub column, empty rows and columns,
    duplicates and zero-weight padding."""
    rows = np.concatenate([rng.integers(0, n_dst - 3, e), np.full(12, 1),
                           rng.integers(0, n_dst - 3, 8), np.zeros(4, int)])
    cols = np.concatenate([rng.integers(0, n_src - 5, e),
                           rng.integers(0, n_src - 5, 12), np.full(8, 2),
                           np.zeros(4, int)])
    vals = np.concatenate([rng.standard_normal(e + 20) * 0.3,
                           np.zeros(4)]).astype(np.float32)
    return rows, cols, vals, n_dst, n_src


def _layer_inputs(seed=0, n_dst=24, n_src=40, d=12, h=8, e=120):
    rng = np.random.default_rng(seed)
    edges = _edges(rng, n_dst, n_src, e)
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    w = (rng.standard_normal((d, h)) * 0.3).astype(np.float32)
    ct = rng.standard_normal((n_dst, h)).astype(np.float32)
    return edges, x, w, ct


def _port_layer(fn, A, x, w, ct, **kw):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = fn(A, xt, wt, **kw)
    dx, dw = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), (xt, wt))
    return y.detach(), dx, dw


def _ref_layer(fn, A, x, w, ct, **kw):
    y = fn(A, jnp.asarray(x), jnp.asarray(w), **kw)
    dx, dw = jax.grad(lambda a, b: jnp.vdot(fn(A, a, b, **kw), ct),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(t) for t in (y, dx, dw)]


# ---------------------------------------------------------------------------
# Graph Converter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sort_row_major", "sort_col_major",
                                  "to_backward"])
def test_graph_converter_arrays_equal_the_reference(name):
    edges, _, _, _ = _layer_inputs(seed=3)
    got = getattr(convert, name)(from_edges(*edges))
    want = getattr(ref_convert, name)(ref_from_edges(*edges))
    for a in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, a).numpy(),
                                      np.asarray(getattr(want, a)))
    assert (got.n_dst, got.n_src) == (want.n_dst, want.n_src)


# ---------------------------------------------------------------------------
# The layer, ours and naive
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("activate", [True, False])
@pytest.mark.parametrize("order", ["coag", "agco"])
@pytest.mark.parametrize("dataflow", ["ours", "naive"])
def test_layer_matches_the_reference(dataflow, order, activate):
    edges, x, w, ct = _layer_inputs()
    fn, ref_fn = {"ours": (gcn.gcn_layer, ref_gcn.gcn_layer),
                  "naive": (baseline.gcn_layer_baseline,
                            ref_baseline.gcn_layer_baseline)}[dataflow]
    got = _port_layer(fn, from_edges(*edges), x, w, ct, order=order,
                      activate=activate)
    want = _ref_layer(ref_fn, ref_from_edges(*edges), x, w, ct, order=order,
                      activate=activate)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                               atol=FWD_TOL)
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("activate", [True, False])
@pytest.mark.parametrize("order", ["coag", "agco"])
def test_ours_equals_naive(order, activate):
    """Same forward bits (the same gemm and row sums); gradients equal up
    to the matmuls' operand layouts."""
    edges, x, w, ct = _layer_inputs(seed=1)
    A = from_edges(*edges)
    ours = _port_layer(gcn.gcn_layer, A, x, w, ct, order=order,
                       activate=activate)
    naive = _port_layer(baseline.gcn_layer_baseline, A, x, w, ct,
                        order=order, activate=activate)
    assert torch.equal(ours[0], naive[0])
    for a, b in zip(ours[1:], naive[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("activate", [True, False])
@pytest.mark.parametrize("order", ["coag", "agco"])
def test_coo_layer_forward_keeps_its_bits(order, activate):
    """The written backward leaves the forward as it was: the serving
    contracts (incremental == cold, block == coo) rest on these bits."""
    edges, x, w, _ = _layer_inputs(seed=2)
    A = from_edges(*edges)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if order == "coag":
        z = gcn.segment_sum_rows(A, gemm(xt, wt))
        want = torch.relu(z) if activate else z
    else:
        want = gemm(gcn.segment_sum_rows(A, xt), wt, relu=activate)
    got = gcn.gcn_layer(A, xt, wt, order=order, activate=activate)
    assert torch.equal(got, want)
    # and with a gradient taped
    got = gcn.gcn_layer(A, xt.clone().requires_grad_(True),
                        wt.clone().requires_grad_(True), order=order,
                        activate=activate)
    assert torch.equal(got.detach(), want)


def test_backward_column_grouping_is_built_once_per_coo():
    edges, x, w, ct = _layer_inputs(seed=4)
    A = from_edges(*edges)
    before = edgeplan.cache_stats()["misses"]
    runs = [_port_layer(gcn.gcn_layer, A, x, w, ct, order="coag")
            for _ in range(3)]
    assert edgeplan.cache_stats()["misses"] == before + 1
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r, runs[0]))


def test_naive_layer_walks_the_cached_column_grouping():
    """Naive pays for its copies, not for a sort: its forward builds no
    grouping, a backward that does not walk (AgCo without dX) builds none
    either, and its walk shares the column grouping ours walks."""
    edges, x, w, ct = _layer_inputs(seed=5)
    A = from_edges(*edges)
    before = edgeplan.cache_stats()["misses"]
    wt = torch.from_numpy(w).requires_grad_(True)
    y = baseline.gcn_layer_baseline(A, torch.from_numpy(x), wt, order="agco")
    torch.autograd.grad(y.sum(), wt)
    assert edgeplan.cache_stats()["misses"] == before
    naive = _port_layer(baseline.gcn_layer_baseline, A, x, w, ct,
                        order="coag")
    assert edgeplan.cache_stats()["misses"] == before + 1
    ours = _port_layer(gcn.gcn_layer, A, x, w, ct, order="coag")
    assert edgeplan.cache_stats()["misses"] == before + 1
    assert torch.equal(naive[0], ours[0])


@pytest.mark.parametrize("order", ["coag", "agco"])
def test_residual_bytes_equal_the_reference(order):
    dims = dict(n_dst=1024, n_src=4096, d=256, h=41)
    assert gcn.residual_bytes(order, **dims) \
        == ref_gcn.residual_bytes(order, **dims)
    assert baseline.residual_bytes_naive(order, nnz=40_000, **dims) \
        == ref_baseline.residual_bytes_naive(order, nnz=40_000, **dims)


# ---------------------------------------------------------------------------
# The model: forward, loss, accuracy, weights
# ---------------------------------------------------------------------------
def _model_inputs(multilabel, seed=5):
    """Two hops (16 seeds, 3 of them padding): layer 0 aggregates 40 → 16
    rows, layer 1 80 → 40; features 12 wide, 5 classes."""
    rng = np.random.default_rng(seed)
    e0, e1 = _edges(rng, 16, 40, 60), _edges(rng, 40, 80, 200)
    x = rng.standard_normal((80, 12)).astype(np.float32)
    if multilabel:
        labels = (rng.random((16, 5)) < 0.3).astype(np.float32)
    else:
        labels = rng.integers(0, 5, 16).astype(np.int32)
    return (e0, e1), x, labels


@pytest.mark.parametrize("multilabel", [False, True])
@pytest.mark.parametrize("model,dataflow", [("gcn", "ours"),
                                            ("sage", "ours"),
                                            ("gcn", "naive"),
                                            ("sage", "naive")])
def test_forward_loss_accuracy_and_grads_match_the_reference(
        model, dataflow, multilabel):
    edges, x, labels = _model_inputs(multilabel)
    kw = dict(name="t", feat_dim=12, hidden=8, n_classes=5, model=model,
              dataflow=dataflow, multilabel=multilabel)
    rcfg, cfg = ref_model.GCNConfig(**kw), gcn_model.GCNConfig(**kw)
    orders = ("agco", "coag")
    rparams = ref_model.init_gcn_params(jax.random.PRNGKey(1), rcfg)
    params = gcn_model.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    rlayers = [ref_from_edges(*e) for e in edges]
    layers = [from_edges(*e) for e in edges]

    want_logits = ref_model.gcn_forward(rparams, rlayers, jnp.asarray(x),
                                        rcfg, orders)
    want_loss, want_grads = jax.value_and_grad(ref_model.gcn_loss)(
        rparams, rlayers, jnp.asarray(x), jnp.asarray(labels), rcfg,
        orders, n_valid=13)

    live = {"layers": [{k: v.clone().requires_grad_(True)
                        for k, v in p.items()} for p in params["layers"]]}
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    logits = gcn_model.gcn_forward(live, layers, xt, cfg, orders)
    loss = gcn_model.gcn_loss(live, layers, xt, lt, cfg, orders, n_valid=13)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=0, atol=FWD_TOL)
    assert abs(float(loss.detach()) - float(want_loss)) <= FWD_TOL
    for got_l, want_l in zip(live["layers"], want_grads["layers"]):
        assert set(got_l) == set(want_l)
        for k in got_l:
            np.testing.assert_allclose(got_l[k].grad.numpy(),
                                       np.asarray(want_l[k]),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if not multilabel:
        for n_valid in (None, 13, 0):
            got = gcn_model.accuracy(logits.detach(), lt, n_valid)
            want = ref_model.accuracy(want_logits, jnp.asarray(labels),
                                      n_valid)
            assert float(got) == pytest.approx(float(want), abs=1e-7)


def test_init_gcn_params_shapes_scale_and_shared_weights():
    cfgs = {m: gcn_config("reddit", m) for m in ("gcn", "sage")}
    params = {m: gcn_model.init_gcn_params(torch.Generator().manual_seed(0),
                                           c, device="cpu")
              for m, c in cfgs.items()}
    shapes = [(602, 256), (256, 41)]
    for m, p in params.items():
        assert [tuple(layer["w"].shape) for layer in p["layers"]] == shapes
        assert all(("w_root" in layer) == (m == "sage")
                   for layer in p["layers"])
    for a, b in zip(params["gcn"]["layers"], params["sage"]["layers"]):
        assert torch.equal(a["w"], b["w"])
    w = params["sage"]["layers"][0]["w_root"]
    assert abs(float(w.std()) * 602 ** 0.5 - 1.0) < 0.02


def test_paper_configs_equal_the_reference():
    from repro.configs import gcn_paper as ref_paper
    from repro_torch.configs import gcn_paper

    assert (gcn_paper.FANOUTS, gcn_paper.BATCH, gcn_paper.HIDDEN) \
        == (ref_paper.FANOUTS, ref_paper.BATCH, ref_paper.HIDDEN)
    assert {k: vars(v) for k, v in gcn_paper.CONFIGS.items()} \
        == {k: vars(v) for k, v in ref_paper.CONFIGS.items()}
    from repro_torch.launch import trainer
    assert trainer.FANOUTS is gcn_paper.FANOUTS


# ---------------------------------------------------------------------------
# The optimizer and the checkpoint layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_five_steps_equal_the_reference(momentum):
    rng = np.random.default_rng(6)
    p0 = {"layers": [{"w": rng.standard_normal((5, 3)).astype(np.float32),
                      "w_root": rng.standard_normal((5, 3)).astype(
                          np.float32)}]}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), p0)
        for _ in range(5)]
    rinit, rupdate = ref_sgd(0.05, momentum)
    init, update = sgd(0.05, momentum)
    rp = jax.tree_util.tree_map(jnp.asarray, p0)
    pp = jax.tree_util.tree_map(torch.from_numpy, p0)
    rs, ps = rinit(rp), init(pp)
    for g in grads:
        u, rs = rupdate(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
        rp = ref_apply(rp, u)
        u, ps = update(jax.tree_util.tree_map(torch.from_numpy, g), ps, pp)
        pp = apply_updates(pp, u)
    assert isinstance(ps, SGDState) and int(ps.step) == int(rs.step) == 5
    for k in ("w", "w_root"):
        np.testing.assert_array_equal(pp["layers"][0][k].numpy(),
                                      np.asarray(rp["layers"][0][k]))
        if momentum:
            np.testing.assert_array_equal(
                ps.momentum["layers"][0][k].numpy(),
                np.asarray(rs.momentum["layers"][0][k]))


def test_optimizer_state_checkpoints_in_the_reference_layout(tmp_path):
    """``(params, SGDState)`` saved by the port restores in the reference
    (named-tuple fields by name: ``1/momentum/...``, ``1/step``) and back."""
    rng = np.random.default_rng(7)
    params = {"layers": [{"w": torch.from_numpy(
        rng.standard_normal((4, 2)).astype(np.float32))}]}
    init, update = sgd(0.1, 0.9)
    state = init(params)
    _, state = update(params, state, params)
    CheckpointManager(str(tmp_path)).save(3, (params, state),
                                          extra={"step": 3})
    rp = jax.tree_util.tree_map(lambda t: jnp.zeros(t.shape), params)
    rinit, _ = ref_sgd(0.1, 0.9)
    (rp, rs), extra = RefManager(str(tmp_path)).restore(3, (rp, rinit(rp)))
    assert extra["step"] == 3 and int(rs.step) == 1
    np.testing.assert_array_equal(np.asarray(rs.momentum["layers"][0]["w"]),
                                  params["layers"][0]["w"].numpy())
    (_, back), _ = CheckpointManager(str(tmp_path)).restore(
        3, (params, init(params)))
    assert int(back.step) == 1
    assert torch.equal(back.momentum["layers"][0]["w"],
                       params["layers"][0]["w"])


# ---------------------------------------------------------------------------
# train_gcn: the reference arms
# ---------------------------------------------------------------------------
def _reference_checkpoint(path, dataset, model, dataflow):
    """A step-0 ``(params, opt_state)`` checkpoint in the reference's
    layout, written by the reference, at the small widths of ``TRAIN``."""
    cfg = ref_gcn_config(dataset, model, dataflow)
    cfg = type(cfg)(**{**cfg.__dict__, "feat_dim": TRAIN["feat_dim"],
                       "hidden": TRAIN["hidden"]})
    params = ref_model.init_gcn_params(jax.random.PRNGKey(3), cfg)
    init, _ = ref_sgd(TRAIN["lr"], momentum=0.9)
    RefManager(str(path)).save(0, (params, init(params)), extra={
        "step": 0, "pipeline": {"seed": 0, "epoch": 0, "batch_idx": 0}})


@pytest.mark.parametrize("dataset,model,dataflow", [
    ("reddit", "gcn", "naive"), ("reddit", "sage", "ours"),
    ("yelp", "sage", "naive")])
def test_train_gcn_reference_arms_match_the_reference(tmp_path, dataset,
                                                      model, dataflow):
    _reference_checkpoint(tmp_path, dataset, model, dataflow)
    want = ref_train.train_gcn(dataset, model=model, dataflow=dataflow,
                               ckpt_dir=str(tmp_path), resume=True, **TRAIN)
    got = train.train_gcn(dataset, model=model, dataflow=dataflow,
                          ckpt_dir=str(tmp_path), resume=True, device="cpu",
                          **TRAIN)
    assert got["orders"] == want["orders"]
    assert len(got["loss_history"]) == TRAIN["steps"]
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("engine,match", [
    ("auto", "nothing for the planner"),
    ("ell+pipelined", "builds its layout host-side"),
    ("block+pipelined", "builds its layout host-side")])
def test_reference_loop_rejects_auto_and_layout_formats(engine, match):
    for fn, kw in ((ref_train.train_gcn, {}),
                   (train.train_gcn, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            fn("reddit", model="sage", engine=engine, **TRAIN, **kw)


def test_train_gcn_ours_runs_the_stacked_core_trainer():
    out = train.train_gcn("reddit", n_cores=2, input_pipeline="sync",
                          device="cpu", **{**TRAIN, "steps": 2})
    assert out["spec"] == "coo+serial" and len(out["loss_history"]) == 2
    assert out["orders"] == ("agco", "agco")
    assert np.all(np.isfinite(out["loss_history"]))


def test_cli_trains_on_the_cpu_and_lm_names_its_slice(capsys):
    train.main(["gcn", "--device", "cpu", "--dataset", "reddit",
                "--scale", "0.004", "--feat-dim", "16", "--hidden", "16",
                "--batch-size", "32", "--steps", "2", "--dataflow",
                "naive"])
    assert "final loss" in capsys.readouterr().out
    # the lm command trains every family now, the SSM one among them
    train.main(["lm", "--arch", "mamba2-1.3b", "--device", "cpu",
                "--steps", "2", "--seq", "16"])
    assert "final loss" in capsys.readouterr().out
