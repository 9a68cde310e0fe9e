"""The LM's train and prefill steps on a ``(data, model)`` mesh
(``launch/steps.py::build_step`` under ``use_mesh``), over gloo ranks on
the CPU.

The smoke configs of moonshot-v1-16b-a3b (its MoE layers
expert-parallel, ``ep_spec_for``), llama3.2-1b, mamba2-1.3b, zamba2-1.2b
and seamless-m4t-medium, the same weights and token batches on every
side, two AdamW steps.  The steps compute each dense block in its
stored ``model`` split (``launch/steps.py::tp_plan``: at ``model`` = 4
llama's K and V whole), so at W > 1 the row blocks' products and the
vocab's log-sum-exp sum over ``model`` in parts, and a mesh step is not
bit-equal to the unsharded one.  Each step runs in float64, the port's
yardstick type, where that reordering moves nothing the bounds can see,
and in f32, where it moves the results by f32 rounding:

* on (1, 4) and (2, 2) ranks the float64 steps of all five families
  (moonshot on (1, 4) only: at dp = 2 its aux loss is per shard) equal
  the unsharded port's float64 step: losses within 1e-6 relative, the
  first step's gradient norm within 1e-6 relative (the second's, after
  an update whose rounding differs, within 1e-4), params within 1e-5;
* on the same meshes the f32 steps are near the unsharded port's f32
  step: losses within 1e-6 relative, gradient norms within (2e-6, 1e-4)
  relative, and each leaf's params within a share of the unsharded
  step's largest update of that leaf (1e-2; mamba2 4e-2, zamba2 1e-1:
  ``F32_UPDATE_TOL`` says why);
* on (2, 2) the f32 steps of moonshot and llama equal the reference's
  ``lm.train_step_fn(..., ep_spec=...)`` on a (2, 2) JAX mesh (a
  subprocess): losses within
  1e-5, gradient norms within 1e-5 relative, and each leaf's update
  (params after the two steps less the initial params) within 1e-2 of
  the reference's largest update of that leaf (moonshot's aux loss there
  is the mean of the two data shards' values, as the reference's).  The
  update, not the params, is compared: two AdamW steps at lr 3e-4 move a
  parameter by at most about 6e-4, so a step that moved nothing would be
  within any parameter tolerance that absorbs the two programs'
  rounding;
* each rank's parts of the params and AdamW moments have the shapes of
  the reference's ``NamedSharding(mesh, spec).shard_shape`` leaf by leaf
  (a stack's: the layers the rank holds, by its shape), and the step
  returns them in the placements it was given;
* the f32 prefill's logits, each rank its rows over the whole vocab
  (the vocab blocks of a split head gathered), equal the unsharded
  prefill's within 1e-5;
* decode under a mesh raises, naming ROADMAP item 10.4; a MoE step over
  data shards without ``ep_spec`` and a step given whole params on a
  mesh that shards them refuse.

One ``torch.multiprocessing.spawn`` per mesh (a ``file://`` store under
``tmp_path``, one intra-op thread per rank).  This module imports no JAX
at its top: the spawned ranks import it.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402

ARCHS = ("moonshot-v1-16b-a3b", "llama3.2-1b", "mamba2-1.3b", "zamba2-1.2b",
         "seamless-m4t-medium")
REF_ARCHS = ARCHS[:2]            # held against the reference at (2, 2)
MESHES = ((1, 4), (2, 2))
B, S, STEPS, LR = 4, 32, 2, 3e-4
CHUNK = 16                                   # the SSM scan chunk
LOSS_RTOL, PARAM_TOL = 1e-6, 1e-5            # vs the unsharded port
# the gradient norm of each step: the first from the same params on both
# sides; the second after an update whose rounding differs (AdamW's eps
# amplifies it where a gradient is tiny: zamba2's second norm moves 6e-6)
GNORM_RTOL = (1e-6, 1e-4)
REF_LOSS_TOL, REF_GNORM_RTOL = 1e-5, 1e-5    # vs the reference
REF_UPDATE_TOL = 1e-2       # share of the reference's max |Δp| per leaf
# the f32 mesh step against the unsharded f32 step, where the split sums
# the row blocks and the vocab's log-sum-exp in parts: bounds from this
# file's readings (printed by assert_f32_gaps).  The first gradient norm:
# zamba2's moves 1.25e-6 at (1, 4).  Each leaf's params as a share of the
# unsharded step's largest update of that leaf, as against the reference:
# AdamW's first update g / (|g| + eps) turns f32 rounding of a gradient
# near eps (1e-8) into a share of lr, so the Mamba2 families' w_B / w_z /
# out_proj move 1.93e-2 (mamba2, (1, 4)) and 5.22e-2 (zamba2, (2, 2));
# zamba2's unsharded f32 step itself sits 6.12e-2 from its float64 step
F32_LOSS_RTOL, F32_GNORM_RTOL = LOSS_RTOL, (2e-6, GNORM_RTOL[1])
F32_UPDATE_TOL = {"mamba2-1.3b": 4e-2, "zamba2-1.2b": 1e-1}
F32_UPDATE_TOL_ELSE = REF_UPDATE_TOL
LOGIT_TOL = 1e-5


def _batches(cfg):
    """The token batches (encdec: ``S`` stub frames and ``S // 4``
    decoder tokens, as ``train_lm``)."""
    from repro_torch.data import make_lm_batch

    out = []
    for i in range(STEPS):
        if cfg.family == "encdec":
            b = make_lm_batch(0, i, B, S, cfg.vocab, enc_frames=S,
                              d_model=cfg.d_model)
            b.update({k: b[k][:, :S // 4] for k in ("tokens", "labels")})
        else:
            b = make_lm_batch(0, i, B, S, cfg.vocab)
        out.append(b)
    return out


def _prompt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if k != "labels"}


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _stacked(tree):
    """A :func:`lm.param_tree` -shaped tree of arrays as flat
    ``{path: array}``, each stack's layers stacked."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            out["/".join(path)] = np.stack([_host(t) for t in node])
        else:
            out["/".join(path)] = _host(node)

    walk(tree, ())
    return out


def _f64(tree):
    """A param tree's every leaf in float64 (the yardstick type)."""
    from repro_torch.optim import tree_map

    return tree_map(lambda t: t.double(), tree)


def _host(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _local_shapes(tree):
    """``{path: shape}`` of a rank's parts: a stack's is the layers it
    holds by one such layer's shape."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            held = [t for t in node if t.shape[:1] != (0,) or t.ndim == 0]
            out["/".join(path)] = (len(held),) + tuple(held[0].shape)
        else:
            out["/".join(path)] = tuple(node.shape)

    walk(tree, ())
    return out


def _worker(rank, shape, store, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import gather_global, reshard
    from repro_torch.configs import Shape, get_smoke
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.steps import build_step, ep_spec_for, \
        tree_shardings
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=shape[0] * shape[1])
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        res = {"coords": (mesh.get_local_rank("data"),
                          mesh.get_local_rank("model"))}
        for arch in ARCHS:
            cfg = get_smoke(arch)
            tree32 = torch.load(os.path.join(tmp, f"{arch}.pt"))
            ep_spec = ep_spec_for(cfg, Shape("t", "train", S, B), mesh)
            with use_mesh(mesh):
                sh_p = tree_shardings(tree32, mesh)
                sh_z = tree_shardings(adamw(LR)[0](tree32), mesh,
                                      zero1=True)
                step = build_step(cfg, "train", lr=LR, chunk=CHUNK,
                                  ep_spec=ep_spec)
                prefill = build_step(cfg, "prefill", chunk=CHUNK,
                                     ep_spec=ep_spec)
            batches = _batches(cfg)
            res[arch] = {"logits": prefill(
                lm.params_from_tree(reshard(tree32, sh_p)),
                _prompt(batches[0])).numpy()}
            for tag, tree in (("", tree32), ("f64_", _f64(tree32))):
                state = adamw(LR)[0](tree)
                params = lm.params_from_tree(reshard(tree, sh_p))
                opt = reshard(state, sh_z)
                given = (_local_shapes(lm.param_tree(params)),
                         _local_shapes(opt.mu))
                losses, gnorms = [], []
                for b in batches:
                    params, opt, m = step(params, opt, _tensors(b))
                    losses.append(float(m["loss"]))
                    gnorms.append(float(m["grad_norm"]))
                res[arch].update({
                    tag + "losses": losses, tag + "grad_norms": gnorms,
                    tag + "given": given,
                    tag + "returned": (_local_shapes(lm.param_tree(params)),
                                       _local_shapes(opt.mu)),
                    tag + "params": _stacked(gather_global(
                        lm.param_tree(params), sh_p))})
        with open(os.path.join(tmp, f"{shape[0]}x{shape[1]}_r{rank}.pkl"),
                  "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_REF = """
import pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs import get_smoke
from repro.models import lm
from repro.optim import adamw

with open({inp!r}, "rb") as f:
    inp = pickle.load(f)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {{}}
for arch, (tree, batches) in inp.items():
    cfg = get_smoke(arch)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = adamw({lr})
    state = opt[0](params)
    ep = P("data", "model", None, None) if cfg.family == "moe" else None
    losses, gnorms = [], []
    with set_mesh(mesh):
        step = jax.jit(lm.train_step_fn(cfg, opt, ep_spec=ep))
        for b in batches:
            params, state, m = step(params, state,
                                    {{k: jnp.asarray(v) for k, v in b.items()}})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    out[arch] = {{"losses": losses, "grad_norms": gnorms,
                 "params": jax.tree_util.tree_map(np.asarray, params)}}
with open({out!r}, "wb") as f:
    pickle.dump(out, f)
print("REF ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Seeded f32 weights per arch; the reference's (2, 2) steps in a
    subprocess; one spawn per mesh; the unsharded port's prefill, and its
    f32 and float64 steps."""
    import torch.multiprocessing as mp

    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import build_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    tmp = str(tmp_path_factory.mktemp("lm_mesh"))
    torch.set_num_threads(1)
    ref_in, plain = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = get_smoke(arch)
        params = lm.init_params(torch.Generator().manual_seed(10 + i), cfg,
                                dtype=torch.float32)
        torch.save(lm.param_tree(params), os.path.join(tmp, f"{arch}.pt"))
        batches = _batches(cfg)
        if arch in REF_ARCHS:
            ref_in[arch] = (lm.params_to_reference(params), batches)
        logits = build_step(cfg, "prefill", chunk=CHUNK)(
            params, _prompt(batches[0]))
        plain[arch] = {"logits": logits.numpy(),
                       "init": _stacked(lm.param_tree(params))}
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
    assert "REF ok" in run_subprocess(_REF.format(inp=inp, out=out, lr=LR),
                                      n_devices=4)
    with open(out, "rb") as f:
        ref = pickle.load(f)
    got = {}
    for shape in MESHES:
        mp.spawn(_worker, args=(shape, os.path.join(
            tmp, f"store{shape[0]}x{shape[1]}"), tmp),
            nprocs=shape[0] * shape[1], join=True)
        got[shape] = []
        for r in range(shape[0] * shape[1]):
            with open(os.path.join(tmp, f"{shape[0]}x{shape[1]}_r{r}.pkl"),
                      "rb") as f:
                got[shape].append(pickle.load(f))
    return {"mesh": got, "plain": plain, "ref": ref}


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


@pytest.mark.parametrize("arch,shape", [(a, m) for a in ARCHS for m in MESHES
                                        if (a, m) != (ARCHS[0], (2, 2))])
def test_mesh_step_equals_the_unsharded_step(runs, arch, shape):
    want = runs["plain"][arch]
    for r in runs["mesh"][shape]:
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


def f32_gaps(got, want, init):
    """The f32 mesh step's distance from the unsharded f32 step: the
    losses' largest relative gap, each step's gradient norm's, and the
    leaf whose params moved furthest as a share of the unsharded step's
    largest update of that leaf (``(leaf, share)``)."""
    assert got["params"].keys() == want["params"].keys()
    share = {}
    for k, v in want["params"].items():
        moved = np.abs(v - init[k]).max()
        assert moved > 0, k
        share[k] = float(np.abs(got["params"][k] - v).max() / moved)
    return {"loss": float((np.abs(np.subtract(got["losses"], want["losses"]))
                           / np.abs(want["losses"])).max()),
            "grad_norm": (np.abs(np.subtract(got["grad_norms"],
                                             want["grad_norms"]))
                          / np.abs(want["grad_norms"])).tolist(),
            "update": max(share.items(), key=lambda kv: kv[1])}


def assert_f32_gaps(arch, gaps):
    """``arch``'s f32 gaps within ``F32_*`` (printed: the readings the
    bounds were set from)."""
    print(arch, gaps)
    assert gaps["loss"] <= F32_LOSS_RTOL, gaps
    assert (np.asarray(gaps["grad_norm"]) <= F32_GNORM_RTOL).all(), gaps
    assert gaps["update"][1] <= F32_UPDATE_TOL.get(
        arch, F32_UPDATE_TOL_ELSE), gaps


@pytest.mark.parametrize("arch,shape", [(a, m) for a in ARCHS for m in MESHES
                                        if (a, m) != (ARCHS[0], (2, 2))])
def test_f32_mesh_step_near_the_unsharded_step(runs, arch, shape):
    want = runs["plain"][arch]
    for r in runs["mesh"][shape]:
        assert_f32_gaps(arch, f32_gaps(r[arch], want, want["init"]))


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_mesh_step_equals_the_reference_at_2x2(runs, arch):
    ref = runs["ref"][arch]
    init = runs["plain"][arch]["init"]
    want = {k: v - init[k] for k, v in _ref_flat(ref["params"]).items()}
    assert max(np.abs(v).max() for v in want.values()) > 0
    for r in runs["mesh"][(2, 2)]:
        got = r[arch]
        assert np.abs(np.subtract(got["losses"], ref["losses"])).max() \
            <= REF_LOSS_TOL, (got["losses"], ref["losses"])
        rel = np.abs(np.subtract(got["grad_norms"], ref["grad_norms"])) \
            / np.abs(ref["grad_norms"])
        assert rel.max() <= REF_GNORM_RTOL, (got["grad_norms"],
                                             ref["grad_norms"])
        assert got["params"].keys() == want.keys()
        for k, v in want.items():
            err = np.abs(got["params"][k] - init[k] - v).max()
            assert err <= REF_UPDATE_TOL * np.abs(v).max(), \
                (k, err, np.abs(v).max())
    if arch == ARCHS[0]:        # the per-shard aux: not the whole batch's
        assert abs(runs["mesh"][(2, 2)][0][arch]["losses"][0]
                   - runs["plain"][arch]["losses"][0]) > 1e-6


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_equal_the_reference(runs, arch, shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs import get_smoke as ref_get_smoke
    from repro.launch import steps as ref_steps
    from repro.models import lm as ref_lm
    from repro.optim import adamw as ref_adamw

    cfg = ref_get_smoke(arch)
    mesh = AbstractMesh(shape, ("data", "model"))
    params = jax.eval_shape(lambda k: ref_lm.init_params(
        k, cfg, dtype=jnp.float32), jax.random.PRNGKey(0))
    state = jax.eval_shape(ref_adamw(LR)[0], params)
    want = []
    for tree, zero1 in ((params, False), (state.mu, True)):
        sh = ref_steps.tree_shardings(tree, mesh, zero1=zero1)
        want.append(_ref_flat(jax.tree_util.tree_map(
            lambda s, x: NamedSharding(mesh, s.spec).shard_shape(x.shape),
            sh, tree, is_leaf=lambda x: isinstance(x, NamedSharding))))
    for r in runs["mesh"][shape]:
        given_p, given_mu = r[arch]["given"]
        assert given_p == {k: tuple(v) for k, v in want[0].items()}
        assert given_mu == {k: tuple(v) for k, v in want[1].items()}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_returns_the_placements_it_was_given(runs, arch, shape):
    for r in runs["mesh"][shape]:
        assert r[arch]["returned"] == r[arch]["given"]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_equals_the_unsharded_prefill(runs, arch, shape):
    dp = shape[0]
    ranks = {r["coords"]: r for r in runs["mesh"][shape]}
    for j in range(shape[1]):          # every model rank: the same rows
        got = np.concatenate([ranks[(i, j)][arch]["logits"]
                              for i in range(dp)])
        want = runs["plain"][arch]["logits"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= LOGIT_TOL


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


def test_mesh_refusals(fake_mesh):
    from repro_torch.checkpoint import reshard
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.steps import build_step, tree_shardings
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    mesh = fake_mesh((2, 2))
    cfg = get_smoke(ARCHS[0])
    with use_mesh(mesh), pytest.raises(NotImplementedError, match="10.4"):
        build_step(cfg, "decode")
    tree = lm.param_tree(lm.init_params(torch.Generator().manual_seed(0),
                                        cfg, dtype=torch.float32))
    state = adamw(LR)[0](tree)
    with use_mesh(mesh):
        step = build_step(cfg, "train")
        params = lm.params_from_tree(reshard(tree, tree_shardings(tree,
                                                                  mesh)))
        opt = reshard(state, tree_shardings(state, mesh, zero1=True))
    batch = _tensors(_batches(cfg)[0])
    with pytest.raises(ValueError, match="ep_spec"):
        step(params, opt, batch)
    with pytest.raises(ValueError, match="this rank's part"):
        step(lm.params_from_tree(tree), opt, batch)
