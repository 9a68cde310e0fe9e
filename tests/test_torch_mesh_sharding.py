"""Port vs reference: ``distributed/sharding.py``'s placement rules.

Every spec function of the reference returns a JAX ``PartitionSpec``; the
port's returns the same content as a plain tuple (an axis name, a tuple of
names or ``None`` per tensor dimension).  They are held equal on meshes of
the same names and sizes: the reference's ``jax.sharding.AbstractMesh``
``(2, 4)`` over ``("data", "model")`` and ``(2, 2, 4)`` over ``("pod",
"data", "model")``, the port's CPU ``DeviceMesh``es of one process each
(the ``fake`` process-group backend, which places nothing and starts no
process).  Also: ``named``'s ``DTensor`` placements, ``leading_axis_put``'s
block on every rank, ``use_mesh`` nesting, and ``sharding`` leaving
``NOT_PORTED``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.distributed import sharding as ref  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402

MESHES = [((2, 4), ("data", "model")), ((2, 2, 4), ("pod", "data", "model")),
          ((4,), ("model",))]


@pytest.fixture
def fake_mesh():
    """A factory of one-process CPU ``DeviceMesh``es as rank ``rank`` of a
    world of the mesh's size; the fake process group is torn down after
    the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(shape, names, rank=0):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=int(np.prod(shape)))
        return init_device_mesh("cpu", shape, mesh_dim_names=names)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _cases(mesh):
    """(name, reference call, port call) for every spec function."""
    a = np.zeros((8, 3, 2))
    return [
        ("act_batch", lambda m: ref.act_batch(m), lambda m: sharding
         .act_batch(m)),
        ("act_batch trailing", lambda m: ref.act_batch(m, None, "model"),
         lambda m: sharding.act_batch(m, None, "model")),
        ("act_batch_seq", lambda m: ref.act_batch_seq(m),
         lambda m: sharding.act_batch_seq(m)),
        ("act_batch_seq sp", lambda m: ref.act_batch_seq(m, True),
         lambda m: sharding.act_batch_seq(m, True)),
        *[(f, getattr(ref, f), getattr(sharding, f)) for f in (
            "w_col", "w_row", "w_replicated", "embed_vocab", "moe_expert",
            "kv_cache", "node_features", "edge_shards", "gcn_weights")],
        ("leading_axis_spec", lambda m: ref.leading_axis_spec(a),
         lambda m: sharding.leading_axis_spec(a)),
        ("leading_axis_spec data", lambda m: ref.leading_axis_spec(a, "data"),
         lambda m: sharding.leading_axis_spec(a, "data")),
    ]


@pytest.mark.parametrize("shape,names", MESHES)
def test_specs_equal_the_reference_partition_specs(fake_mesh, shape, names):
    ref_mesh = AbstractMesh(shape, names)
    mesh = fake_mesh(shape, names)
    assert sharding.batch_axes(mesh) == ref.batch_axes(ref_mesh)
    assert sharding.dp_size(mesh) == ref.dp_size(ref_mesh)
    assert sharding.axis_size(mesh, "model") == 4
    for name, ref_fn, port_fn in _cases(mesh):
        assert port_fn(mesh) == tuple(ref_fn(ref_mesh)), name
    assert (sharding.MODEL, sharding.DATA, sharding.POD) == (
        ref.MODEL, ref.DATA, ref.POD)


@pytest.mark.parametrize("shape,names", MESHES[:2])
def test_named_gives_the_placements_of_the_spec(fake_mesh, shape, names):
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake_mesh(shape, names)
    dp = [Shard(0) if n != "model" else Replicate() for n in names]
    assert sharding.named(mesh, sharding.act_batch(mesh)) == dp
    assert sharding.named(mesh, sharding.w_col(mesh)) == [
        Shard(1) if n == "model" else Replicate() for n in names]
    assert sharding.named(mesh, sharding.kv_cache(mesh)) == [
        Shard(1) if n == "model" else Shard(0) for n in names]
    assert sharding.named(mesh, sharding.gcn_weights(mesh)) == [
        Replicate()] * len(names)


@pytest.mark.parametrize("shape,names", MESHES)
def test_leading_axis_put_places_each_ranks_block(fake_mesh, shape, names):
    a = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    seen = []
    for rank in range(int(np.prod(shape))):
        mesh = fake_mesh(shape, names, rank)
        r = mesh.get_local_rank("model")
        got = sharding.leading_axis_put(mesh, a)
        assert got.device.type == "cpu" and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), a[4 * r:4 * r + 4])
        # a tensor goes the same way
        assert torch.equal(sharding.leading_axis_put(
            mesh, torch.from_numpy(a)), got)
        seen.append(r)
    assert sorted(set(seen)) == [0, 1, 2, 3]
    mesh = fake_mesh(shape, names)
    with pytest.raises(ValueError, match="does not split"):
        sharding.leading_axis_put(mesh, np.zeros((6, 2)))


def test_use_mesh_nests_and_unwinds():
    assert sharding.current_mesh() is None
    with sharding.use_mesh("outer"):
        with sharding.use_mesh("inner"):
            assert sharding.current_mesh() == "inner"
        assert sharding.current_mesh() == "outer"
    assert sharding.current_mesh() is None


def test_grad_accum_over_axes_needs_a_current_mesh():
    from repro_torch.distributed import grad_accum

    params = {"w": torch.ones(2)}
    batch = {"x": torch.ones(4, 2)}
    with pytest.raises(ValueError, match="use_mesh"):
        grad_accum(lambda p, b: (b["x"] @ p["w"]).sum(), params, batch,
                   n_micro=2, axis_names=("data",))


def test_sharding_is_exported_and_no_longer_unported():
    import repro_torch.distributed as dist_pkg
    from test_torch_port_rules import NOT_PORTED

    assert "sharding" in dist_pkg.__all__
    assert dist_pkg.sharding is sharding
    assert "sharding" not in NOT_PORTED.get("distributed", set())


def test_the_engine_refuses_a_mesh_with_a_second_axis(fake_mesh):
    from repro_torch.engine import Engine

    mesh = fake_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="no data parallelism"):
        Engine("ell+pipelined").build(4, mesh=mesh)
    mesh = fake_mesh((2,), ("data",))
    with pytest.raises(ValueError, match="no 'model' axis"):
        Engine("ell+pipelined").build(4, mesh=mesh)
