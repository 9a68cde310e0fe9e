"""The expert-parallel MoE (``repro_torch.models.moe.moe_ffn_ep``) over
gloo ranks on the CPU, against the unsharded ``moe_ffn`` and the
reference's ``moe_ffn_ep``.

moonshot-v1-16b-a3b's smoke config (8 experts, top-2) at
``capacity_factor=2.0`` on a ``(data, model)`` mesh of (1, 2), (1, 4) and
(2, 2) ranks, the same numpy weights and input on every side:

* at dp = 1 ``y`` and ``aux`` equal ``moe_ffn``'s within 1e-5, and the
  gradients of x, the router and the three expert stacks under the loss
  ``sum(y²) + aux`` within the reference test's 2e-3 (the router's and
  x's summed over ``model`` once, the aux loss's share counted once);
* at (2, 2) each data shard routes its own rows, so ``aux`` is the mean
  of the two shards' values: ``y``, ``aux`` and ``dx`` equal the
  reference's ``moe_ffn_ep`` on a (2, 2) JAX mesh (a subprocess), and
  the router's gradient summed over the data ranks equals the
  reference's; ``y`` and the expert stacks' gradients (summed over the
  data ranks, each model rank its block) equal ``moe_ffn``'s and the
  reference's;
* the forward's collectives: one ``all_gather`` and one
  ``reduce_scatter`` of the ``[b_l, s, d]`` activation, whatever top-k
  (at dp = 2 also the scalar aux's ``all_reduce`` over ``data``);
* the refusals: no current mesh, experts or tokens that ``model`` does
  not divide, a whole expert stack where this rank's block belongs.

One ``torch.multiprocessing.spawn`` per mesh (a ``file://`` store under
``tmp_path``, one intra-op thread per rank); each rank writes what it
saw.  This module imports no JAX: the spawned ranks import it.
"""
import os
import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
CF = 2.0
B, S = 4, 32
MESHES = ((1, 2), (1, 4), (2, 2))
Y_TOL, GRAD_TOL = 1e-5, 2e-3
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _inputs(cfg):
    """numpy weights of one MoE layer (f32) and x ``[B, S, d]``."""
    rng = np.random.default_rng(3)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    x = rng.standard_normal((B, S, d))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _loss_grads(fn, x, p):
    """(y, aux, {name: grad}) of ``sum(y²) + aux`` w.r.t. x, the router
    and the expert stacks."""
    leaves = {"x": x, "router": p["router"],
              **{k: p[k] for k in EXPERT_LEAVES}}
    leaves = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    y, aux = fn(leaves["x"], {k: v for k, v in leaves.items() if k != "x"})
    grads = torch.autograd.grad((y * y).sum() + aux, list(leaves.values()))
    return (y.detach(), aux.detach(),
            {k: g for k, g in zip(leaves, grads)})


class _Wire:
    """Counts the collectives (and the elements each moves) that
    ``torch.distributed`` runs while it is entered."""

    NAMES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce")

    def __enter__(self):
        import torch.distributed as dist

        self.calls = []
        self.saved = {n: getattr(dist, n) for n in self.NAMES}

        def counting(name, fn):
            def call(*args, **kwargs):
                self.calls.append((name, int(args[0].numel())))
                return fn(*args, **kwargs)
            return call

        for n, fn in self.saved.items():
            setattr(dist, n, counting(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self.saved.items():
            setattr(dist, n, fn)


def _worker(rank, shape, store, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import Shape, get_smoke
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.steps import ep_spec_for
    from repro_torch.models import moe

    torch.set_num_threads(1)
    world = shape[0] * shape[1]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        cfg = get_smoke(ARCH)
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        p, x = _inputs(cfg)
        ep_spec = ep_spec_for(cfg, Shape("t", "train", S, B), mesh)
        dr, mr = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        bl, el = B // shape[0], cfg.moe_experts // shape[1]
        xt = torch.from_numpy(x[dr * bl:(dr + 1) * bl])
        pt = {"router": torch.from_numpy(p["router"]),
              **{k: torch.from_numpy(p[k][mr * el:(mr + 1) * el])
                 for k in EXPERT_LEAVES}}

        def ep(xx, pp):
            with _Wire() as wire:
                out = moe.moe_ffn_ep(xx, types.SimpleNamespace(**pp), cfg, CF,
                                     ep_spec)
            ep.wire = wire.calls
            return out

        with use_mesh(mesh):
            y, aux, grads = _loss_grads(ep, xt, pt)
        res = {"coords": (dr, mr), "y": y.numpy(), "aux": float(aux),
               "grads": {k: v.numpy() for k, v in grads.items()},
               "wire": ep.wire, "ep_spec": ep_spec}
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


_REF = """
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs import get_smoke
from repro.models.moe import moe_ffn_ep

d = dict(np.load({path!r}))
cfg = get_smoke({arch!r})
p = {{k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up", "w_down")}}
x = jnp.asarray(d["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
ep_spec = P("data", "model", None, None)

def loss(x, q):
    y, aux = moe_ffn_ep(x, q, cfg, {cf}, ep_spec)
    return jnp.sum(y * y) + aux, (y, aux)

with set_mesh(mesh):
    (_, (y, aux)), (dx, dp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(x, p)
np.savez({out!r}, y=np.asarray(y), aux=np.asarray(aux), dx=np.asarray(dx),
         drouter=np.asarray(dp["router"]),
         **{{"d" + k: np.asarray(dp[k]) for k in ("w_gate", "w_up",
                                                 "w_down")}})
print("REF ok")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's (2, 2) run in a subprocess, one spawn per mesh, and
    the unsharded port's ``moe_ffn`` on the whole input."""
    import torch.multiprocessing as mp

    from repro_torch.configs import get_smoke
    from repro_torch.models import moe

    cfg = get_smoke(ARCH)
    p, x = _inputs(cfg)
    tmp = str(tmp_path_factory.mktemp("moe_ep"))
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, x=x, **p)
    ref_out = os.path.join(tmp, "ref.npz")
    assert "REF ok" in run_subprocess(
        _REF.format(path=path, arch=ARCH, cf=CF, out=ref_out), n_devices=4)
    got = {}
    for shape in MESHES:
        out = str(tmp_path_factory.mktemp(f"moe_ep_{shape[0]}x{shape[1]}"))
        mp.spawn(_worker, args=(shape, os.path.join(out, "store"), out),
                 nprocs=shape[0] * shape[1], join=True)
        got[shape] = []
        for r in range(shape[0] * shape[1]):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                got[shape].append(pickle.load(f))
    torch.set_num_threads(1)
    y, aux, grads = _loss_grads(
        lambda xx, pp: moe.moe_ffn(xx, types.SimpleNamespace(**pp), cfg, CF),
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    plain = {"y": y.numpy(), "aux": float(aux),
             "grads": {k: v.numpy() for k, v in grads.items()}}
    return {"mesh": got, "plain": plain, "ref": dict(np.load(ref_out)),
            "cfg": cfg}


def _assembled(ranks, shape, key):
    """A gradient or output over the mesh: rows of x over the data ranks,
    expert blocks over the model ranks, the router's summed over data."""
    dp, w = shape
    at = {r["coords"]: r for r in ranks}
    if key == "y":
        return np.concatenate([at[(i, 0)]["y"] for i in range(dp)])
    if key == "x":
        return np.concatenate([at[(i, 0)]["grads"]["x"] for i in range(dp)])
    if key == "router":
        return sum(at[(i, 0)]["grads"]["router"] for i in range(dp))
    return sum(np.concatenate([at[(i, j)]["grads"][key] for j in range(w)])
               for i in range(dp))


@pytest.mark.parametrize("shape", [s for s in MESHES if s[0] == 1])
def test_moe_ffn_ep_equals_moe_ffn_at_dp1(runs, shape):
    ranks, plain = runs["mesh"][shape], runs["plain"]
    for r in ranks:
        assert np.abs(r["y"] - plain["y"]).max() <= Y_TOL
        assert abs(r["aux"] - plain["aux"]) <= Y_TOL
        # x's and the router's gradients are whole on every model rank
        for k in ("x", "router"):
            np.testing.assert_allclose(r["grads"][k], plain["grads"][k],
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
    for k in EXPERT_LEAVES:
        np.testing.assert_allclose(_assembled(ranks, shape, k),
                                   plain["grads"][k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_moe_ffn_ep_equals_the_reference_ep_at_2x2(runs):
    ranks, ref = runs["mesh"][(2, 2)], runs["ref"]
    shape = (2, 2)
    assert np.abs(_assembled(ranks, shape, "y") - ref["y"]).max() <= Y_TOL
    for r in ranks:
        assert abs(r["aux"] - float(ref["aux"])) <= Y_TOL
    np.testing.assert_allclose(_assembled(ranks, shape, "x"), ref["dx"],
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(_assembled(ranks, shape, "router"),
                               ref["drouter"], rtol=GRAD_TOL, atol=GRAD_TOL)
    # the per-shard aux: not moe_ffn's aux over the whole batch
    assert abs(ranks[0]["aux"] - runs["plain"]["aux"]) > 1e-6


def test_moe_ffn_ep_equals_moe_ffn_outputs_at_2x2(runs):
    """At dp = 2 ``y`` is still ``moe_ffn``'s, row for row (the routing
    is per sample), and so are the expert gradients summed over data (the
    aux loss does not reach the experts), as are the reference's."""
    ranks, plain, ref = runs["mesh"][(2, 2)], runs["plain"], runs["ref"]
    assert np.abs(_assembled(ranks, (2, 2), "y") - plain["y"]).max() <= Y_TOL
    for k in EXPERT_LEAVES:
        got = _assembled(ranks, (2, 2), k)
        np.testing.assert_allclose(got, plain["grads"][k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
        np.testing.assert_allclose(got, ref["d" + k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("shape", MESHES)
def test_moe_ffn_ep_wire_is_one_gather_and_one_scatter(runs, shape):
    cfg = runs["cfg"]
    act = B // shape[0] * S * cfg.d_model
    for r in runs["mesh"][shape]:
        wire = r["wire"]
        names = [n for n, _ in wire]
        assert names.count("all_gather_into_tensor") == 1
        assert names.count("reduce_scatter_tensor") == 1
        assert ("reduce_scatter_tensor", act // shape[1]) in wire
        assert ("all_gather_into_tensor", act) in wire
        others = [n for n in wire if n[0] == "all_reduce"]
        assert others == ([("all_reduce", 1)] if shape[0] > 1 else [])


@pytest.fixture
def fake_mesh():
    """One-process ``DeviceMesh``es as rank 0 of a fake process group,
    torn down after the test."""
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


def test_moe_ffn_ep_refusals(fake_mesh):
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import moe

    cfg = get_smoke(ARCH)
    p, x = _inputs(cfg)
    layer = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                     for k, v in p.items()})
    xt = torch.from_numpy(x)
    spec = (None, "model", None, None)
    with pytest.raises(ValueError, match="current mesh"):
        moe.moe_ffn_ep(xt, layer, cfg, CF, spec)
    with pytest.raises(ValueError, match="current mesh"):
        moe.moe_ffn(xt, layer, cfg, CF, ep_spec=spec)
    with use_mesh(fake_mesh((1, 3))):               # 8 experts over 3
        with pytest.raises(ValueError, match="divide"):
            moe.moe_ffn_ep(xt, layer, cfg, CF, spec)
    with use_mesh(fake_mesh((1, 2))):
        with pytest.raises(ValueError, match="divide"):
            moe.moe_ffn_ep(xt[:, :S - 1], layer, cfg, CF, spec)
        with pytest.raises(ValueError, match="this rank's 4 of 8"):
            moe.moe_ffn_ep(xt, layer, cfg, CF, spec)
