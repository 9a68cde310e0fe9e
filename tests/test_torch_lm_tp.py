"""The LM's dense blocks computed split over ``model`` on a ``(data,
model)`` mesh (``launch/steps.py::tp_plan`` and the layers under
``distributed/tensor_parallel.py``'s ``Split``), over gloo ranks on the
CPU, and held against the unsharded port and the reference.

The smoke configs of the five families of ``test_torch_lm_mesh_train.py``
(its batches, weights' seeds and tolerances):

* at (1, 2) the f32 prefill of every family, each rank its rows over
  the whole vocab, equals the unsharded prefill within 1e-5; the two
  float64 AdamW steps of every family equal the unsharded port's float64
  steps (losses within 1e-6 relative, gradient norms within (1e-6, 1e-4)
  relative, params within 1e-5), and the two f32 steps are near the
  unsharded f32 steps within ``test_torch_lm_mesh_train.py``'s ``F32_*``
  bounds (at W > 1 the row blocks' products and the vocab's log-sum-exp
  sum over ``model`` in parts, which f32 rounds);
* at (1, 4) every family's float64 gradient through
  ``mesh_value_and_grad`` equals the unsharded port's within 1e-12 per
  entry (a float64 model that rounded through f32 anywhere would not);
* each rank's compute shapes, read from the model the step runs: ``wq``
  ``[d, h·hd/W]``, ``wo`` ``[h·hd/W, d]``, ``w_gate`` ``[d, f/W]``,
  ``out_proj`` ``[d_inner/W, d]``, the vocab rows ``[V/W, d]``, and the
  leaves that compute whole at their whole shapes (llama's ``wk`` at
  ``model`` = 4);
* the step all-gathers no leaf of a block that splits: only the leaves
  the plan computes whole and the rules store split (none at (1, 2);
  llama's ``wk`` / ``wv`` at (1, 4));
* one dense layer (llama) runs 2 all-reduces forward and 2 backward and
  no all-gather; one Mamba2 layer 2 forward (the norm's sum of squares,
  g) and 4 backward (f of its input, of ``B``, of ``C``, the norm's
  sum); both equal the whole layer within 1e-12 in float64;
* ``tp_plan`` for every smoke and full config at ``model`` = 1, 2, 4, 8,
  16 (a ``"fake"`` process group): which blocks split, llama's whole KV
  at 4, mamba2's whole vocab (50280) and seamless's (256206) where the
  sanitizer drops ``model``;
* against the reference on a (1, 4) JAX mesh built ``AxisType.Auto``
  (its params placed by its ``tree_shardings``, so GSPMD splits them),
  llama3.2-1b (K and V whole) and mamba2-1.3b (the norm over ``model``):
  ``jax.value_and_grad(lm.lm_loss)`` against ``mesh_value_and_grad``, f32,
  the loss within 1e-5 and every gradient within 2e-3 (rtol and atol),
  and within 2e-3 of its leaf's largest |g| (which the atol alone leaves
  open for a leaf whose every |g| is below it);
* the vocab-parallel NLL and embedding at W = 2, with labels and tokens
  at the edges of a vocab block, against ``torch.log_softmax`` and
  ``F.embedding``: values and gradients within 1e-12 in float64, the
  embedding's rows bit-equal.

One ``torch.multiprocessing.spawn`` per mesh (a ``file://`` store under
``tmp_path``, one intra-op thread per rank).  This module imports no JAX
at its top: the reference runs in a subprocess.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402
from test_torch_lm_mesh_train import (ARCHS, B, CHUNK, GNORM_RTOL,  # noqa: E402
                                      LOGIT_TOL, LOSS_RTOL, LR, PARAM_TOL, S,
                                      _batches, _f64, _local_shapes,
                                      _prompt, _stacked, _tensors,
                                      assert_f32_gaps, f32_gaps)

REF_ARCHS = ("llama3.2-1b", "mamba2-1.3b")   # against the reference at (1, 4)
REF_LOSS_TOL, REF_GRAD_TOL = 1e-5, 2e-3
LAYER_TOL = 1e-12                            # float64, one layer
GRAD_F64_TOL = 1e-12       # float64 gradients, split vs unsharded, (1, 4)


def _seed(arch):
    return 10 + ARCHS.index(arch)


class _Calls:
    """Counts the ``torch.distributed`` collectives run while active."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self._saved = [], {n: getattr(dist, n)
                                       for n in self.NAMES}

        def logged(name, fn):
            def call(*args, **kwargs):
                self.calls.append(name)
                return fn(*args, **kwargs)
            return call

        for name, fn in self._saved.items():
            setattr(dist, name, logged(name, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def _one_layer(cfg, mesh, tree, kind):
    """One layer's forward and backward split under ``tp_plan`` and whole,
    float64: (collectives forward, backward, |y| error, |dx| error, |dw|
    error of its first leaf)."""
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.distributed.tensor_parallel import use_split
    from repro_torch.launch.steps import _Placed
    from repro_torch.models import lm, mamba2, transformer

    placed = _Placed(cfg, mesh, None)
    from repro_torch.checkpoint import reshard

    local = reshard(tree, placed.params)
    comp = lm.params_from_tree(gather_tree(local, placed.params,
                                           placed.compute)).layers[0]
    whole = lm.params_from_tree(tree).layers[0]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((B, S, cfg.d_model), generator=gen, dtype=torch.float64)
    pos = torch.arange(S)[None, :]

    def run(layer, split):
        xi = x.clone().requires_grad_(True)
        with use_split(split), _Calls() as fwd:
            if kind == "dense":
                y = transformer.dense_block(xi, layer, cfg, None, pos)
            else:
                y = mamba2.mamba_block(xi, layer, cfg, chunk=CHUNK)
        first = getattr(layer, layer.LEAVES[0])
        with use_split(split), _Calls() as bwd:
            dx, dw = torch.autograd.grad((y * y).sum(), (xi, first))
        return fwd.calls, bwd.calls, y.detach(), dx, dw

    f_calls, b_calls, y, dx, dw = run(comp, placed.split)
    _, _, y0, dx0, dw0 = run(whole, None)
    first = layer_leaf(kind)
    dw0 = dw0[placed.compute["layers"][first][0].block(tuple(dw0.shape))]
    return (f_calls, b_calls, float((y - y0).abs().max()),
            float((dx - dx0).abs().max()), float((dw - dw0).abs().max()))


def layer_leaf(kind):
    """The first leaf of the layer kind's ``LEAVES``."""
    return "wq" if kind == "dense" else "w_z"


def _vocab_case(mesh):
    """The vocab-parallel NLL and lookup at W = 2 against the whole ones,
    float64: (nll error, dlogits error, rows bit-equal, dembed error)."""
    import torch.nn.functional as F

    from repro_torch.distributed.tensor_parallel import (Split, vocab_embed,
                                                         vocab_nll)

    split = Split.over(mesh, {})
    v, d = 64, 8
    lo, hi = split.rank * v // 2, (split.rank + 1) * v // 2
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn((3, 8, v), generator=gen, dtype=torch.float64) * 4
    edges = torch.tensor([0, v // 2 - 1, v // 2, v - 1, 1, v // 2 + 1, 31, 33])
    labels = torch.stack([edges, edges.flip(0), edges.roll(3)])
    embed = torch.randn((v, d), generator=gen, dtype=torch.float64)
    mine = logits[..., lo:hi].clone().requires_grad_(True)
    full = logits.clone().requires_grad_(True)
    got = vocab_nll(mine, labels, split)
    want = -torch.gather(torch.log_softmax(full, -1), -1,
                         labels[..., None])[..., 0]
    w = torch.linspace(0.5, 2.0, labels.numel(),
                       dtype=torch.float64).reshape(labels.shape)
    (g_mine,) = torch.autograd.grad((got * w).sum(), mine)
    (g_full,) = torch.autograd.grad((want * w).sum(), full)
    e_mine = embed[lo:hi].clone().requires_grad_(True)
    e_full = embed.clone().requires_grad_(True)
    rows = vocab_embed(labels, e_mine, split)
    rows0 = F.embedding(labels, e_full)
    (de_mine,) = torch.autograd.grad((rows * rows).sum(), e_mine)
    (de_full,) = torch.autograd.grad((rows0 * rows0).sum(), e_full)
    return (float((got - want).abs().max()),
            float((g_mine - g_full[..., lo:hi]).abs().max()),
            bool(torch.equal(rows, rows0)),
            float((de_mine - de_full[lo:hi]).abs().max()))


def _worker(rank, shape, store, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.distributed.sharding as sharding
    from repro_torch.checkpoint import gather_global, reshard
    from repro_torch.configs import Shape, get_smoke
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.steps import (build_step, ep_spec_for,
                                          mesh_value_and_grad, tp_plan,
                                          tree_shardings)
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=shape[0] * shape[1])
    seen, gathered = [], []
    forward, all_gather = lm.forward, sharding._all_gather

    def spy_forward(model, *args, **kwargs):
        seen.append(_local_shapes(lm.param_tree(model)))
        return forward(model, *args, **kwargs)

    def spy_gather(t, dim, group, size):
        gathered.append((tuple(t.shape), dim))
        return all_gather(t, dim, group, size)

    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        res = {}
        for arch in ARCHS:
            cfg = get_smoke(arch)
            tree = torch.load(os.path.join(tmp, f"{arch}.pt"))
            ep_spec = ep_spec_for(cfg, Shape("t", "train", S, B), mesh)
            batches = _batches(cfg)
            out = res[arch] = {"plan": tp_plan(cfg, mesh, ep_spec=ep_spec)}
            with use_mesh(mesh):
                sh_p = tree_shardings(tree, mesh)
                step = build_step(cfg, "train", lr=LR, chunk=CHUNK,
                                  ep_spec=ep_spec)
                prefill = build_step(cfg, "prefill", chunk=CHUNK,
                                     ep_spec=ep_spec)
                value_and_grad = mesh_value_and_grad(cfg, mesh, chunk=CHUNK,
                                                     ep_spec=ep_spec)
            if shape == (1, 2):
                out["logits"] = prefill(
                    lm.params_from_tree(reshard(tree, sh_p)),
                    _prompt(batches[0])).numpy()
                for tag, t in (("", tree), ("f64_", _f64(tree))):
                    opt = reshard(adamw(LR)[0](t), tree_shardings(
                        adamw(LR)[0](t), mesh, zero1=True))
                    params = lm.params_from_tree(reshard(t, sh_p))
                    losses, gnorms = [], []
                    for b in batches:
                        lm.forward, sharding._all_gather = spy_forward, \
                            spy_gather
                        try:
                            params, opt, m = step(params, opt, _tensors(b))
                        finally:
                            lm.forward, sharding._all_gather = forward, \
                                all_gather
                        losses.append(float(m["loss"]))
                        gnorms.append(float(m["grad_norm"]))
                    out.update({tag + "losses": losses,
                                tag + "grad_norms": gnorms,
                                tag + "params": _stacked(gather_global(
                                    lm.param_tree(params), sh_p))})
            else:
                _, grads = value_and_grad(lm.params_from_tree(reshard(
                    _f64(tree), sh_p)), _tensors(batches[0]))
                out["f64_grads"] = _stacked(gather_global(grads, sh_p))
                if arch not in REF_ARCHS:
                    continue
                params = lm.params_from_tree(reshard(tree, sh_p))
                lm.forward, sharding._all_gather = spy_forward, spy_gather
                try:
                    loss, grads = value_and_grad(params, _tensors(batches[0]))
                finally:
                    lm.forward, sharding._all_gather = forward, all_gather
                out.update(loss=float(loss), grads=_stacked(
                    gather_global(grads, sh_p)))
            out.update(compute=seen[0], gathered=list(gathered))
            seen.clear()
            gathered.clear()
        if shape == (1, 2):
            for arch, kind in (("llama3.2-1b", "dense"),
                               ("mamba2-1.3b", "mamba")):
                tree = _f64(torch.load(os.path.join(tmp, f"{arch}.pt")))
                res[arch]["layer"] = _one_layer(get_smoke(arch), mesh, tree,
                                                kind)
            res["vocab"] = _vocab_case(mesh)
        with open(os.path.join(tmp, f"{shape[0]}x{shape[1]}_r{rank}.pkl"),
                  "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_REF = """
import functools, pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.compat import set_mesh
from repro.configs import get_smoke
from repro.launch import steps
from repro.models import lm

with open({inp!r}, "rb") as f:
    inp = pickle.load(f)
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {{}}
for arch, (tree, batch) in inp.items():
    cfg = get_smoke(arch)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    with set_mesh(mesh):
        params = jax.device_put(params, steps.tree_shardings(params, mesh))
        fn = jax.jit(jax.value_and_grad(functools.partial(
            lm.lm_loss, cfg=cfg, chunk={chunk}, remat=True)))
        loss, grads = fn(params, {{k: jnp.asarray(v) for k, v in batch.items()}})
    out[arch] = {{"loss": float(loss),
                 "grads": jax.tree_util.tree_map(np.asarray, grads)}}
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
print("REF ok")
"""


def _grads(cfg, tree, batch):
    """The unsharded port's gradient of ``lm_loss`` at ``tree``, as
    :func:`_stacked` arrays."""
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves, tree_map

    params = lm.params_from_tree(tree)
    tree = lm.param_tree(params)
    with torch.enable_grad():
        loss = lm.lm_loss(params, batch, cfg, chunk=CHUNK, remat=True)
        grads = iter(torch.autograd.grad(loss, tree_leaves(tree)))
    return _stacked(tree_map(lambda t: next(grads), tree))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Seeded f32 weights per arch; the unsharded port's f32 and float64
    steps and float64 gradients; the reference's (1, 4) gradients in a
    subprocess; one spawn per mesh ((1, 2) and (1, 4))."""
    import torch.multiprocessing as mp

    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import build_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    tmp = str(tmp_path_factory.mktemp("lm_tp"))
    torch.set_num_threads(1)
    ref_in, plain = {}, {}
    for arch in ARCHS:
        cfg = get_smoke(arch)
        params = lm.init_params(torch.Generator().manual_seed(_seed(arch)),
                                cfg, dtype=torch.float32)
        torch.save(lm.param_tree(params), os.path.join(tmp, f"{arch}.pt"))
        batches = _batches(cfg)
        if arch in REF_ARCHS:
            ref_in[arch] = (lm.params_to_reference(params), batches[0])
        plain[arch] = {"logits": build_step(cfg, "prefill", chunk=CHUNK)(
            params, _prompt(batches[0])).numpy(),
            "init": _stacked(lm.param_tree(params)),
            "f64_grads": _grads(cfg, _f64(lm.param_tree(params)),
                                _tensors(batches[0]))}
        for tag, tree in (("", lm.param_tree(params)),
                          ("f64_", _f64(lm.param_tree(params)))):
            p, state = lm.params_from_tree(tree), adamw(LR)[0](tree)
            step = build_step(cfg, "train", lr=LR, chunk=CHUNK)
            losses, gnorms = [], []
            for b in batches:
                p, state, m = step(p, state, _tensors(b))
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            plain[arch].update({tag + "losses": losses,
                                tag + "grad_norms": gnorms,
                                tag + "params": _stacked(lm.param_tree(p))})
    inp, out = os.path.join(tmp, "ref_in.pkl"), os.path.join(tmp, "ref.pkl")
    with open(inp, "wb") as f:
        pickle.dump(ref_in, f)
    assert "REF ok" in run_subprocess(_REF.format(inp=inp, out=out,
                                                  chunk=CHUNK), n_devices=4)
    with open(out, "rb") as f:
        ref = pickle.load(f)
    got = {}
    for shape in ((1, 2), (1, 4)):
        mp.spawn(_worker, args=(shape, os.path.join(
            tmp, f"store{shape[0]}x{shape[1]}"), tmp),
            nprocs=shape[0] * shape[1], join=True)
        got[shape] = []
        for r in range(shape[0] * shape[1]):
            with open(os.path.join(tmp, f"{shape[0]}x{shape[1]}_r{r}.pkl"),
                      "rb") as f:
                got[shape].append(pickle.load(f))
    return {"mesh": got, "plain": plain, "ref": ref}


@pytest.mark.parametrize("arch", ARCHS)
def test_split_step_equals_the_unsharded_step_at_1x2(runs, arch):
    want = runs["plain"][arch]
    for r in runs["mesh"][(1, 2)]:
        got = r[arch]
        rel = np.abs(np.subtract(got["f64_losses"], want["f64_losses"])) \
            / np.abs(want["f64_losses"])
        assert rel.max() <= LOSS_RTOL, (got["f64_losses"],
                                        want["f64_losses"])
        rel = np.abs(np.subtract(got["f64_grad_norms"],
                                 want["f64_grad_norms"])) \
            / np.abs(want["f64_grad_norms"])
        assert (rel <= GNORM_RTOL).all(), (got["f64_grad_norms"],
                                           want["f64_grad_norms"])
        assert got["f64_params"].keys() == want["f64_params"].keys()
        for k, v in want["f64_params"].items():
            assert np.abs(got["f64_params"][k] - v).max() <= PARAM_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_split_step_near_the_unsharded_step_at_1x2(runs, arch):
    want = runs["plain"][arch]
    for r in runs["mesh"][(1, 2)]:
        assert_f32_gaps(arch, f32_gaps(r[arch], want, want["init"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_f64_split_gradients_equal_the_unsharded_at_1x4(runs, arch):
    want = runs["plain"][arch]["f64_grads"]
    assert max(np.abs(v).max() for v in want.values()) > 0
    for r in runs["mesh"][(1, 4)]:
        got = r[arch]["f64_grads"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == np.float64, k
            err = np.abs(got[k] - v).max()
            assert err <= GRAD_F64_TOL, (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_prefill_equals_the_unsharded_prefill_at_1x2(runs, arch):
    want = runs["plain"][arch]["logits"]
    for r in runs["mesh"][(1, 2)]:           # every rank: the whole vocab
        got = r[arch]["logits"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= LOGIT_TOL


def _want_compute(cfg, w, plan):
    """The compute shapes of the leaves that show the split (a stack's:
    its layers by one layer's shape)."""
    from repro_torch.models.lm import _stack_lengths

    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    split = {b: (w if plan.get(b) == "split" else 1) for b in plan}
    out = {"embed": (cfg.vocab // split["embed"], d)}
    stacks = _stack_lengths(cfg)
    for key, n in stacks.items():
        if key in ("layers", "dense_layers", "moe_layers", "enc_layers",
                   "dec_layers") and cfg.family != "ssm":
            a, k = split["attn"], split["kv"]
            out.update({f"{key}/wq": (n, d, h * hd // a),
                        f"{key}/wo": (n, h * hd // a, d),
                        f"{key}/wk": (n, d, kv * hd // k),
                        f"{key}/wv": (n, d, kv * hd // k)})
        if key in ("layers", "dense_layers", "enc_layers", "dec_layers") \
                and cfg.family != "ssm":
            f = split["ffn"]
            out.update({f"{key}/w_gate": (n, d, cfg.d_ff // f),
                        f"{key}/w_down": (n, cfg.d_ff // f, d)})
        if key == "moe_layers":
            e = split["experts"]
            out.update({f"{key}/router": (n, d, cfg.moe_experts),
                        f"{key}/w_up": (n, cfg.moe_experts // e, d,
                                        cfg.d_ff)})
        if cfg.family in ("ssm", "hybrid") and key in ("layers",
                                                       "mamba_layers"):
            m, di = split["mamba"], cfg.d_inner
            out.update({f"{key}/w_z": (n, d, di // m),
                        f"{key}/out_proj": (n, di // m, d),
                        f"{key}/conv_wx": (n, cfg.ssm_conv, di // m),
                        f"{key}/dt_bias": (n, cfg.ssm_heads // m),
                        f"{key}/norm_g": (n, di // m),
                        f"{key}/w_B": (n, d, cfg.ssm_state)})
        if key == "dec_layers":
            a = split["attn"]
            out.update({f"{key}/x_wq": (n, d, h * hd // a),
                        f"{key}/x_wo": (n, h * hd // a, d)})
    if cfg.family == "hybrid":
        a = split["attn"]
        out.update({"shared/wq": (d, h * hd // a),
                    "shared/w_down": (cfg.d_ff // split["ffn"], d)})
    return out


@pytest.mark.parametrize("arch,shape", [(a, (1, 2)) for a in ARCHS]
                         + [(a, (1, 4)) for a in REF_ARCHS])
def test_each_rank_computes_its_split_of_the_leaves(runs, arch, shape):
    from repro_torch.configs import get_smoke

    cfg = get_smoke(arch)
    for r in runs["mesh"][shape]:
        got = r[arch]
        want = _want_compute(cfg, shape[1], got["plan"])
        assert {k: got["compute"][k] for k in want} == want


def test_llama_whole_kv_at_4_and_every_block_split_at_2(runs):
    for r in runs["mesh"][(1, 2)]:
        for arch in ARCHS:
            assert set(r[arch]["plan"].values()) == {"split"}, arch
    for r in runs["mesh"][(1, 4)]:
        assert r["llama3.2-1b"]["plan"] == {
            "embed": "split", "attn": "split", "kv": "whole",
            "ffn": "split", "head": "split"}
        assert set(r["mamba2-1.3b"]["plan"].values()) == {"split"}


def test_the_step_gathers_no_split_leaf(runs):
    from repro_torch.configs import get_smoke

    for r in runs["mesh"][(1, 2)]:
        for arch in ARCHS:
            assert r[arch]["gathered"] == [], arch
    cfg = get_smoke("llama3.2-1b")
    kv_block = (cfg.d_model, cfg.n_kv_heads * cfg.hd // 4)
    for r in runs["mesh"][(1, 4)]:        # one step: wk, wv per layer
        assert r["llama3.2-1b"]["gathered"] \
            == [(kv_block, 1)] * (2 * cfg.n_layers)
        assert r["mamba2-1.3b"]["gathered"] == []


@pytest.mark.parametrize("arch,fwd,bwd", [("llama3.2-1b", 2, 2),
                                          ("mamba2-1.3b", 2, 4)])
def test_one_layer_collectives_and_values(runs, arch, fwd, bwd):
    for r in runs["mesh"][(1, 2)]:
        f_calls, b_calls, y_err, dx_err, dw_err = r[arch]["layer"]
        assert f_calls == ["all_reduce"] * fwd
        assert b_calls == ["all_reduce"] * bwd
        assert max(y_err, dx_err, dw_err) <= LAYER_TOL, (y_err, dx_err,
                                                         dw_err)


def test_vocab_parallel_nll_and_embedding_at_2(runs):
    for r in runs["mesh"][(1, 2)]:
        nll_err, grad_err, rows_equal, embed_err = r["vocab"]
        assert nll_err <= LAYER_TOL and grad_err <= LAYER_TOL
        assert rows_equal and embed_err <= LAYER_TOL


def _ref_flat(tree):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = np.asarray(node)

    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_split_gradients_equal_the_reference_at_1x4(runs, arch):
    ref = runs["ref"][arch]
    want = _ref_flat(ref["grads"])
    for r in runs["mesh"][(1, 4)]:
        got = r[arch]
        assert abs(got["loss"] - ref["loss"]) <= REF_LOSS_TOL
        assert got["grads"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got["grads"][k], v, rtol=REF_GRAD_TOL,
                                       atol=REF_GRAD_TOL, err_msg=k)
            # and within a share of the leaf's own largest |g|, which
            # the atol alone leaves open where every |g| is below it
            scale = np.abs(v).max()
            err = np.abs(got["grads"][k] - v).max()
            assert scale > 0 and err <= REF_GRAD_TOL * scale, (k, err, scale)


@pytest.fixture
def fake_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(shape):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(shape)))
        return init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


S_, W_ = "split", "whole"
# (arch, smoke?) → plan at model = 1, 2, 4, 8, 16 (ep_spec given for MoE)
PLANS = {
    ("llama3.2-1b", True): {
        4: dict(embed=S_, attn=S_, kv=W_, ffn=S_, head=S_),
        8: dict(embed=S_, attn=W_, kv=W_, ffn=S_, head=S_)},
    ("mamba2-1.3b", True): {16: dict(embed=S_, mamba=W_, head=S_)},
    ("moonshot-v1-16b-a3b", True): {
        8: dict(embed=S_, attn=W_, kv=W_, experts=S_, head=S_),
        16: dict(embed=S_, attn=W_, kv=W_, experts=W_, head=S_)},
    ("mamba2-1.3b", False): {2: dict(embed=S_, mamba=S_, head=S_),
                             4: dict(embed=S_, mamba=S_, head=S_),
                             16: dict(embed=W_, mamba=S_, head=W_)},
    ("seamless-m4t-medium", False): {
        2: dict(embed=S_, attn=S_, kv=S_, ffn=S_, head=S_),
        4: dict(embed=W_, attn=S_, kv=S_, ffn=S_, head=W_)},
    ("llama3.2-1b", False): {16: dict(embed=S_, attn=S_, kv=W_, ffn=S_,
                                      head=S_)},
}


@pytest.mark.parametrize("key", sorted(PLANS), ids=lambda k: f"{k[0]}"
                         f"-{'smoke' if k[1] else 'full'}")
def test_tp_plan(fake_mesh, key):
    from repro_torch.configs import Shape, get_config, get_smoke
    from repro_torch.launch.steps import ep_spec_for, tp_plan

    arch, smoke = key
    cfg = (get_smoke if smoke else get_config)(arch)
    for w, want in PLANS[key].items():
        mesh = fake_mesh((1, w))
        ep = ep_spec_for(cfg, Shape("t", "train", 4096, 8), mesh)
        assert tp_plan(cfg, mesh, ep_spec=ep) == want, w
    mesh = fake_mesh((1, 1))
    assert set(tp_plan(cfg, mesh, ep_spec=ep_spec_for(
        cfg, Shape("t", "train", 4096, 8), mesh)).values()) == {S_}


@pytest.mark.parametrize("w", [1, 2])
def test_chip_smoke_dense_layer_wire(fake_mesh, monkeypatch, w):
    """Phase 19's (d') on a ``"fake"`` group: moonshot's plan, and one
    dense layer at its width through the split — no collective on one
    rank, g's two all-reduces of the ``[b, s, d]`` activation at W = 2."""
    import sys

    from repro_torch.configs import Shape, get_smoke
    from repro_torch.launch.steps import ep_spec_for

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = get_smoke(ARCHS[0])
    mesh = fake_mesh((1, w))
    b, s = 1, 64
    ep = ep_spec_for(cfg, Shape("t", "train", s, b), mesh)
    out = chip_smoke.lm_mesh_split(torch, torch.device("cpu"), cfg, mesh, ep,
                                   b, s)
    assert out["plan"] == dict(embed=S_, attn=S_, kv=S_, experts=S_,
                               head=S_)
    assert set(out["dense_plan"].values()) == {S_}
    assert [c[0] for c in out["dense_wire"]] == ["all_reduce"] * (w - 1) * 2
    assert out["dense_wire_bytes"] == (w - 1) * 2 * b * s * cfg.d_model * 4
