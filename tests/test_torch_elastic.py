"""Elastic placement over gloo ranks on the CPU:
``repro_torch.checkpoint.elastic`` (``reshard``, ``make_mesh_from_plan``,
``shardings_like``) and ``CheckpointManager.restore(shardings=)``.

Four ranks, each a rank of the default process group:

* the port of the reference's ``test_elastic_reshard_across_meshes``: a
  ``[12, 4]`` tensor placed ``("data", "model")`` on a (2, 2) mesh,
  resharded onto a (3, 1) mesh over ranks [0, 1, 2], holds the same
  values (each rank its block, gathered back whole), the new mesh's data
  size is 3, and rank 3, outside it, holds nothing;
* ``make_mesh_from_plan(scale_plan(...))`` gives the plan's shape, names
  and ranks (``devices=`` picks them); ``shardings_like`` one spec for
  every leaf;
* moonshot-v1-16b-a3b's smoke model trained one step on (2, 2), its
  params and AdamW state saved from there (``save(shardings=)``: rank 0
  writes the global arrays) and restored onto a smaller (1, 2) mesh over
  ranks [0, 1] (``restore_latest(like, shardings=)``): every leaf has the
  bits of the live state resharded onto (1, 2) (``reshard(source=)``),
  and one more step from each gives the same loss and params bit for
  bit; the restored params equal the saved ones.

One ``torch.multiprocessing.spawn`` (a ``file://`` store under
``tmp_path``, one intra-op thread per rank); this module imports no JAX.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCH = "moonshot-v1-16b-a3b"
WORLD = 4
B, S, LR = 4, 32, 3e-4


def _equal_trees(a, b) -> bool:
    from repro_torch.optim import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def _worker(rank, store, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import (CheckpointManager, gather_global,
                                        make_mesh_from_plan, reshard,
                                        scale_plan, shardings_like)
    from repro_torch.configs import Shape, get_smoke
    from repro_torch.data import make_lm_batch
    from repro_torch.distributed.sharding import NamedSharding, use_mesh
    from repro_torch.launch.steps import build_step, ep_spec_for, \
        tree_shardings
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    res = {}
    try:
        # the reference test's reshard, (2, 2) → (3, 1) over [0, 1, 2]
        mesh_a = init_device_mesh("cpu", (2, 2),
                                  mesh_dim_names=("data", "model"))
        mesh_b = make_mesh_from_plan(scale_plan(3, model_parallel=1),
                                     device_type="cpu")
        x = torch.arange(48.0).reshape(12, 4)
        sh_a = {"x": NamedSharding(mesh_a, ("data", "model"))}
        sh_b = {"x": NamedSharding(mesh_b, ("data", "model"))}
        xa = reshard({"x": x}, sh_a)
        xb = reshard(xa, sh_b, source=sh_a)["x"]
        res["reshard"] = {
            "a_block": tuple(xa["x"].shape), "b": None if xb is None
            else (tuple(xb.shape), bool(torch.equal(
                xb, x[sh_b["x"].block((12, 4))]))),
            "b_data": mesh_b.size(0), "b_shape": tuple(mesh_b.shape),
            "b_names": mesh_b.mesh_dim_names,
            "b_ranks": mesh_b.mesh.flatten().tolist()}
        plan = scale_plan(2, model_parallel=2)
        small = make_mesh_from_plan(plan, devices=[0, 1], device_type="cpu")
        res["plan"] = (tuple(small.shape), small.mesh_dim_names,
                       small.mesh.flatten().tolist(),
                       small.get_coordinate() is not None)
        like = shardings_like({"a": x, "b": [x, x]}, small, lambda _: ())
        res["like"] = [s.spec for s in (like["a"], *like["b"])]
        # train on (2, 2), save, restore onto (1, 2) over ranks [0, 1]
        cfg = get_smoke(ARCH)
        tree = lm.param_tree(lm.init_params(
            torch.Generator().manual_seed(4), cfg, dtype=torch.float32))
        state = adamw(LR)[0](tree)
        cell = Shape("t", "train", S, B)
        batches = [{k: torch.from_numpy(v) for k, v in
                    make_lm_batch(1, i, B, S, cfg.vocab).items()}
                   for i in range(2)]
        with use_mesh(mesh_a):
            sp_a = (tree_shardings(tree, mesh_a),
                    tree_shardings(state, mesh_a, zero1=True))
            step_a = build_step(cfg, "train", lr=LR,
                                ep_spec=ep_spec_for(cfg, cell, mesh_a))
        with use_mesh(small):
            sp_b = (tree_shardings(tree, small),
                    tree_shardings(state, small, zero1=True))
            step_b = build_step(cfg, "train", lr=LR,
                                ep_spec=ep_spec_for(cfg, cell, small)) \
                if rank < 2 else None
        params = lm.params_from_tree(reshard(tree, sp_a[0]))
        opt = reshard(state, sp_a[1])
        params, opt, _ = step_a(params, opt, batches[0])
        live = (lm.param_tree(params), opt)
        mgr = CheckpointManager(os.path.join(out, "ckpt"))
        mgr.save(1, live, extra={"step": 1}, shardings=sp_a)
        dist.barrier()
        saved = gather_global(live[0], sp_a[0])
        moved = reshard(live, sp_b, source=sp_a)
        got = mgr.restore_latest(live, shardings=sp_b)
        restored, extra, step = got
        res["restore"] = {"extra": extra, "step": step}
        if rank < 2:
            res["restore"]["bits"] = _equal_trees(restored, moved)
            res["restore"]["saved"] = all(
                np.array_equal(a, b) for a, b in zip(
                    _leaves(saved), _leaves(gather_global(restored[0],
                                                          sp_b[0]))))
            outs = []
            for p, o in (restored, moved):
                p2, o2, m = step_b(lm.params_from_tree(p), o, batches[1])
                outs.append((float(m["loss"]), lm.param_tree(p2), o2))
            res["restore"]["loss"] = (outs[0][0], outs[1][0])
            res["restore"]["next"] = _equal_trees(outs[0][1:], outs[1][1:])
        else:
            res["restore"]["none"] = all(
                v is None for v in _leaves(restored))
        with open(os.path.join(out, f"r{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    out = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            out.append(node)

    walk(tree)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    out = str(tmp_path_factory.mktemp("elastic"))
    mp.spawn(_worker, args=(os.path.join(out, "store"), out), nprocs=WORLD,
             join=True)
    got = []
    for r in range(WORLD):
        with open(os.path.join(out, f"r{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return got


def test_reshard_across_meshes(ranks):
    for r, res in enumerate(ranks):
        rs = res["reshard"]
        assert rs["a_block"] == (6, 2)
        assert rs["b_data"] == 3 and rs["b_shape"] == (3, 1)
        assert rs["b_names"] == ("data", "model")
        assert rs["b_ranks"] == [0, 1, 2]
        if r < 3:
            assert rs["b"] == ((4, 4), True)
        else:
            assert rs["b"] is None


def test_make_mesh_from_plan_and_shardings_like(ranks):
    for r, res in enumerate(ranks):
        assert res["plan"] == ((1, 2), ("data", "model"), [0, 1], r < 2)
        assert res["like"] == [(), (), ()]


def test_restore_onto_a_smaller_mesh_then_step(ranks):
    for r, res in enumerate(ranks):
        got = res["restore"]
        assert got["extra"] == {"step": 1} and got["step"] == 1
        if r < 2:
            assert got["bits"] and got["saved"]
            assert got["loss"][0] == got["loss"][1]
            assert np.isfinite(got["loss"][0])
            assert got["next"]
        else:
            assert got["none"]
