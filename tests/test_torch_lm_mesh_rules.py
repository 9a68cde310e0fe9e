"""Port vs reference: ``launch/steps.py``'s placement rules.

On the reference's pod meshes, (16, 16) over ``("data", "model")`` and
(2, 16, 16) over ``("pod", "data", "model")`` — the reference's
``AbstractMesh``es, the port's one-process ``fake``-backend
``DeviceMesh``es of the same shapes:

* for every arch of the grid at its FULL config (shapes only: meta
  tensors), every leaf's ``param_spec`` and ``zero1_spec`` (through
  ``tree_shardings``) equal the reference's; a stack's per-layer
  shardings carry the reference's spec of the stacked leaf
  (``NamedSharding.stacked_spec``), the same for every layer;
* ``sanitize`` on the odd dims the reference's module docstring names
  (llama4's 40 heads, seamless' 256206 and mamba2's 50280 vocabularies,
  long_500k's batch of 1) and on entries of several axes;
* ``sp_spec_for`` and ``ep_spec_for`` for every cell of the grid;
* ``abstract_inputs``' shapes, dtypes and specs for a cell of each kind
  (train, prefill, decode) equal the reference's ``ShapeDtypeStruct``s,
  leaf by leaf, with each stack's layers stacked;
* ``NamedSharding.shard_shape`` equals the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as RefSharding  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import steps as ref  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config  # noqa: E402
from repro_torch.distributed.sharding import NamedSharding  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CELLS = [("moonshot-v1-16b-a3b", "train_4k"),
         ("seamless-m4t-medium", "prefill_32k"),
         ("zamba2-1.2b", "decode_32k"), ("llama3.2-1b", "decode_32k")]


@pytest.fixture
def fake_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(shape, names):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(shape)))
        return init_device_mesh("cpu", shape, mesh_dim_names=names)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _ref_leaves(tree, is_leaf=None):
    """``[(path names, leaf)]`` of a reference tree."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        names = tuple(str(getattr(p, "key", getattr(p, "name", "")))
                      for p in path)
        out.append((names, leaf))
    return out


def _port_leaves(tree, shardings):
    """``[(shape, dtype, stacked spec)]`` of a port tree and its shardings,
    each stack as the reference's stacked leaf."""
    out = []

    def walk(node, sh):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], sh[k])
        elif isinstance(node, list):
            specs = {s.stacked_spec for s in sh}
            assert len(specs) == 1, specs
            assert [s.layer[1:] for s in sh] == [(i, len(sh))
                                               for i in range(len(sh))]
            out.append(((len(node),) + tuple(node[0].shape),
                        str(node[0].dtype), specs.pop()))
        elif isinstance(node, tuple) and not hasattr(node, "_fields") \
                and not isinstance(node, torch.Tensor):
            for a, s in zip(node, sh):
                walk(a, s)
        elif hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), getattr(sh, f))
        elif hasattr(node, "__dataclass_fields__"):
            for f in node.__dataclass_fields__:
                walk(getattr(node, f), getattr(sh, f))
        else:
            assert isinstance(sh, NamedSharding)
            out.append((tuple(node.shape), str(node.dtype),
                        sh.stacked_spec))

    walk(tree, shardings)
    return out


def _ref_triples(args):
    return [(tuple(leaf.shape), "torch." + str(leaf.dtype),
             tuple(leaf.sharding.spec)) for _, leaf in _ref_leaves(args)]


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("shape,names", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_zero1_specs_equal_the_reference(fake_mesh, arch, shape,
                                                   names):
    ref_mesh = AbstractMesh(shape, names)
    mesh = fake_mesh(shape, names)
    cfg = get_config(arch)
    ref_p, _ = ref._abstract_params(ref_get_config(arch), ref_mesh)
    ref_o, _ = ref._abstract_opt(ref_get_config(arch), ref_p, ref_mesh)
    tree, sh = steps._abstract_params(cfg, mesh)
    opt, sh_o = steps._abstract_opt(cfg, tree, mesh)
    for port, want in ((_port_leaves(tree, sh), _ref_triples(ref_p)),
                       (_port_leaves(opt, sh_o), _ref_triples(ref_o))):
        assert len(port) == len(want)
        for (p_shape, _, p_spec), (r_shape, _, r_spec) in zip(port, want):
            assert p_shape == r_shape
            assert _pad(p_spec, len(p_shape)) == _pad(r_spec, len(r_shape)), \
                (arch, p_shape)
    # the functions themselves, on a stacked expert leaf and a scalar
    if cfg.family == "moe":
        e_shape = (cfg.moe_experts, cfg.d_model, cfg.d_ff)
        path = ("moe_layers", "w_gate", 0)
        spec = steps.param_spec(path, e_shape, mesh)
        want = ref.param_spec((jax.tree_util.DictKey("moe_layers"),
                               jax.tree_util.DictKey("w_gate")),
                              (cfg.n_layers // cfg.moe_interleave,)
                              + e_shape, ref_mesh)
        assert (None,) + spec == tuple(want)
    assert steps.zero1_spec((), (), mesh) == tuple(ref.zero1_spec(
        jax.sharding.PartitionSpec(), (), ref_mesh))


ODD = [((40, 128), ("model", None)),                # llama4's 40 heads
       ((256206, 1024), ("model", None)),           # seamless' vocab
       ((50280, 2048), ("model", None)),            # mamba2's vocab
       ((1, 524288), (("pod", "data"), None)),      # long_500k's batch
       ((1, 524288), ("data", None)),
       ((16, 48), (("pod", "data"), "model")),
       ((64, 48), (("pod", "data"), "model")),
       ((32, 32), ("nope", "model")),
       ((8,), ())]


@pytest.mark.parametrize("shape,names", MESHES)
def test_sanitize_equals_the_reference(fake_mesh, shape, names):
    ref_mesh = AbstractMesh(shape, names)
    mesh = fake_mesh(shape, names)
    for dims, spec in ODD:
        assert steps.sanitize(spec, dims, mesh) == tuple(
            ref.sanitize(spec, dims, ref_mesh)), (dims, spec)
    assert steps.dp_axes(mesh) == ref.dp_axes(ref_mesh)


@pytest.mark.parametrize("shape,names", MESHES)
def test_sp_and_ep_specs_equal_the_reference_for_every_cell(fake_mesh, shape,
                                                            names):
    ref_mesh = AbstractMesh(shape, names)
    mesh = fake_mesh(shape, names)
    for arch in ARCH_NAMES:
        for name, cell in SHAPES.items():
            cfg, rcfg, rcell = (get_config(arch), ref_get_config(arch),
                                REF_SHAPES[name])
            assert steps.sp_spec_for(cfg, cell, mesh) == tuple(
                ref.sp_spec_for(rcfg, rcell, ref_mesh)), (arch, name)
            want = ref.ep_spec_for(rcfg, rcell, ref_mesh)
            got = steps.ep_spec_for(cfg, cell, mesh)
            assert got == (None if want is None else tuple(want)), (arch,
                                                                   name)


@pytest.mark.parametrize("arch,cell", CELLS)
def test_abstract_inputs_equal_the_reference(fake_mesh, arch, cell):
    shape, names = MESHES[0]
    ref_mesh = AbstractMesh(shape, names)
    mesh = fake_mesh(shape, names)
    want_args, want_info = ref.abstract_inputs(ref_get_config(arch),
                                               REF_SHAPES[cell], ref_mesh)
    args, info = steps.abstract_inputs(get_config(arch), SHAPES[cell], mesh)
    assert all(t.device.type == "meta" for t in _tensors(args))
    got = _port_leaves(args, info["shardings"])
    want = _ref_triples(want_args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert _pad(g[2], len(g[0])) == _pad(w[2], len(w[0])), g
    out, ref_out = info["out_shardings"], want_info["out_shardings"]
    if SHAPES[cell].kind == "prefill":
        assert out is None and ref_out is None
    else:
        got_out = [s.stacked_spec for s in _flat_shardings(out)]
        want_out = [tuple(s.spec) for _, s in _ref_leaves(
            ref_out, is_leaf=lambda x: isinstance(x, RefSharding))]
        assert got_out == want_out


def _tensors(tree):
    out = []
    steps._walk(lambda _, t: out.append(t), tree)
    return out


def _flat_shardings(tree):
    out = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, NamedSharding):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list) and node \
                and isinstance(node[0], NamedSharding):
            out.append(node[0])          # a stack: one stacked leaf
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            for f in node.__dataclass_fields__:
                walk(getattr(node, f))

    walk(tree)
    return out


@pytest.mark.parametrize("shape,names", MESHES)
def test_shard_shape_equals_the_reference(fake_mesh, shape, names):
    ref_mesh = AbstractMesh(shape, names)
    mesh = fake_mesh(shape, names)
    for dims, spec in ((( 64, 2048, 1408), ("model", ("pod", "data"), None)),
                       ((163840, 2048), ("model", None)),
                       ((256, 4096), (("pod", "data"), None)),
                       ((7,), (None,))):
        spec = steps.sanitize(spec, dims, mesh)
        assert NamedSharding(mesh, spec).shard_shape(dims) == \
            RefSharding(ref_mesh, jax.sharding.PartitionSpec(*spec)
                        ).shard_shape(dims)
