"""Port vs reference: the Engine's interconnect axis (``ring``,
``allpairs``, ``torus2d`` beside ``hypercube``) on stacked cores.

* ``reduce_scatter``, ``allgather``, their feature-wave variants and
  ``fold_pipelined`` at P = 2, 4, 8 and d = 1, 7, 8 are ``np.array_equal``
  to the reference's under ``shard_map`` on P forced CPU devices (one
  ``conftest.run_subprocess`` per P, the three at once, meshes
  ``AxisType.Auto``): the same adds in the same order;
* the autograd mirrors: the gradient of a reduce-scatter is the same
  topology's all-gather of the cotangent and vice versa (``torch.equal``),
  and every all-gather is ``torch.equal`` to the hypercube's (a gather
  moves bytes only), so the mirror backward keeps its bits on any wires;
* ``ExchangePlan`` fields equal the reference's for every topology and
  P ∈ {1, 2, 4, 8, 16}, with and without a measured ``wire_rows``;
* ``fold_bits`` / ``unfold_bits`` in the hypercube's bit order are
  ``torch.equal`` to the hypercube's fold and gather;
* a topology registered at run time is reachable from Engine specs.
"""
import dataclasses
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess  # noqa: E402
from repro.engine import get_topology as ref_get_topology  # noqa: E402
from repro_torch.engine import (Engine, EngineConfig,  # noqa: E402
                                available_topologies, format_topologies,
                                get_topology, register_format,
                                register_topology, supported_specs,
                                supported_topology_specs)
from repro_torch.engine.formats import CooFormat  # noqa: E402
from repro_torch.engine.registry import _FORMATS, _TOPOLOGIES  # noqa: E402
from repro_torch.graph import from_edges  # noqa: E402
from repro_torch.topology import (ExchangePlan, HypercubeTopology,  # noqa
                                  allgather, exchange, reduce_scatter)
from repro_torch.topology.hypercube import (fold_bits,  # noqa: E402
                                            hypercube_allgather,
                                            hypercube_reduce_scatter,
                                            unfold_bits)

TOPOLOGIES = ["ring", "allpairs", "torus2d"]
CORES = [2, 4, 8]
WIDTHS = [1, 7, 8]
T = 3                       # rows per owner block
N_CHUNKS = 2                # feature waves of the pipelined variants


def _inputs(P):
    """Per width: partials ``[P, P, T, d]``, owned blocks ``[P, T, d]`` and
    fold inputs ``[P, P·T, d]``, from one seed."""
    rng = np.random.default_rng(100 + P)
    out = {}
    for d in WIDTHS:
        out[f"part_{d}"] = rng.standard_normal((P, P, T, d)).astype(
            np.float32)
        out[f"x_{d}"] = rng.standard_normal((P, T, d)).astype(np.float32)
        out[f"xl_{d}"] = rng.standard_normal((P, P * T, d)).astype(
            np.float32)
    return out


_REF = """
import os
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as PS
from repro.compat import shard_map
from repro.engine import get_topology

P, out, T, NC = {P}, {out!r}, {T}, {nc}
mesh = jax.make_mesh((P,), ("model",), axis_types=(AxisType.Auto,))
inp = np.load(os.path.join(out, "in.npz"))


def body(topo):
    def f(*arrays):
        out = {{}}
        for d, part, x, xl in zip({widths!r}, *(
                [a[0] for a in arrays[i::3]] for i in range(3))):
            out[f"rs_{{d}}"] = topo.reduce_scatter(part, "model", P)
            out[f"ag_{{d}}"] = topo.allgather(x, "model", P)
            out[f"rsp_{{d}}"] = topo.reduce_scatter_pipelined(
                part, "model", P, NC)
            out[f"agp_{{d}}"] = topo.allgather_pipelined(x, "model", P, NC)
            out[f"fold_{{d}}"] = topo.fold_pipelined(
                "model", P, NC,
                lambda xc: (xc * 2.0).reshape(P, T, xc.shape[-1]), xl)
        return {{k: v[None] for k, v in out.items()}}
    return f


arrays = [jnp.asarray(inp[f"{{k}}_{{d}}"]) for d in {widths!r}
          for k in ("part", "x", "xl")]
res = {{}}
for name in {names!r}:
    fn = jax.jit(shard_map(body(get_topology(name)), mesh=mesh,
                           in_specs=(PS("model"),) * len(arrays),
                           out_specs=PS("model")))
    for k, v in fn(*arrays).items():
        res[f"{{name}}_{{k}}"] = np.asarray(v)
np.savez(os.path.join(out, "out.npz"), **res)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per P: the reference's collectives on the seeded inputs."""
    outs = {P: str(tmp_path_factory.mktemp(f"topo_p{P}")) for P in CORES}
    results, errors = {}, []

    def run(P):
        out = outs[P]
        np.savez(os.path.join(out, "in.npz"), **_inputs(P))
        code = _REF.format(P=P, out=out, T=T, nc=N_CHUNKS,
                           names=TOPOLOGIES, widths=WIDTHS)
        try:
            run_subprocess(code, n_devices=P)
        except AssertionError as e:          # re-raised on the test thread
            errors.append(e)
            return
        results[P] = dict(np.load(os.path.join(out, "out.npz")))

    threads = [threading.Thread(target=run, args=(P,)) for P in CORES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    assert sorted(results) == CORES, "a reference subprocess did not finish"
    return results


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("P", CORES)
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_collectives_equal_the_reference(reference, name, P, d):
    want = reference[P]
    inp = {k: torch.from_numpy(v) for k, v in _inputs(P).items()}
    part, x, xl = inp[f"part_{d}"], inp[f"x_{d}"], inp[f"xl_{d}"]
    topo = get_topology(name)
    got = {
        "rs": topo.reduce_scatter(part, P),
        "ag": topo.allgather(x, P),
        "rsp": topo.reduce_scatter_pipelined(part, P, N_CHUNKS),
        "agp": topo.allgather_pipelined(x, P, N_CHUNKS),
        "fold": topo.fold_pipelined(
            P, N_CHUNKS,
            lambda xc: (xc * 2.0).reshape(P, P, T, xc.shape[-1]), xl),
    }
    for op, y in got.items():
        ref = want[f"{name}_{op}_{d}"]
        assert y.shape == ref.shape, (op, y.shape, ref.shape)
        assert np.array_equal(y.numpy(), ref), (op, name, P, d)


@pytest.mark.parametrize("P", CORES)
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_mirrors_and_gathers_keep_the_hypercube_bits(name, P):
    rng = np.random.default_rng(P)
    t, d = 2, 5
    part = torch.from_numpy(rng.standard_normal((P, P, t, d)).astype(
        np.float32)).requires_grad_(True)
    ct = torch.from_numpy(rng.standard_normal((P, t, d)).astype(np.float32))
    (reduce_scatter(name, P, part) * ct).sum().backward()
    assert torch.equal(part.grad, allgather(name, P, ct))
    x = ct.clone().requires_grad_(True)
    ct2 = part.detach()
    (allgather(name, P, x) * ct2).sum().backward()
    assert torch.equal(x.grad, reduce_scatter(name, P, ct2))
    # every core receives the same blocks: the hypercube's gather bits
    assert torch.equal(allgather(name, P, ct), allgather("hypercube", P, ct))
    assert torch.equal(
        get_topology(name).allgather_pipelined(ct, P, 2),
        get_topology("hypercube").allgather_pipelined(ct, P, 2))
    # the fold reorders adds only: within fp32 roundoff of the hypercube
    dense = ct2.double().sum(0)
    assert (reduce_scatter(name, P, ct2).double() - dense).abs().max() \
        <= 1e-6
    plan = get_topology(name).plan(P * t, d, P)
    assert torch.equal(exchange(ct2, plan), reduce_scatter(name, P, ct2))
    assert torch.equal(exchange(ct, plan, "allgather"),
                       allgather(name, P, ct))
    with pytest.raises(ValueError, match="unknown exchange op"):
        exchange(ct, plan, "broadcast")


@pytest.mark.parametrize("name", TOPOLOGIES + ["hypercube"])
def test_exchange_plans_equal_the_reference(name):
    fields = ("topology", "n_cores", "steps", "bytes_per_core",
              "max_step_rows", "link_parallelism", "predicted_seconds")
    assert [f.name for f in dataclasses.fields(ExchangePlan)] == list(fields)
    topo, ref = get_topology(name), ref_get_topology(name)
    assert topo.description == ref.description

    class Model:                      # duck-typed on .predict(plan)
        def predict(self, plan):
            return 1e-3 + 2e-4 * plan.steps + 3e-9 * (
                plan.bytes_per_core / plan.link_parallelism)

    for P in (1, 2, 4, 8, 16):
        for n_rows, d in ((256, 32), (1040, 41)):
            for wire_rows in (None, 0, 97, n_rows * P):
                for model in (None, Model()):
                    got = topo.plan(n_rows, d, P, wire_rows=wire_rows,
                                    cost_model=model)
                    want = ref.plan(n_rows, d, P, wire_rows=wire_rows,
                                    cost_model=model)
                    for f in fields:
                        assert getattr(got, f) == getattr(want, f), \
                            (name, P, n_rows, wire_rows, f)
    with pytest.raises(ValueError, match="power-of-two"):
        topo.plan(64, 8, 6)


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16])
def test_fold_bits_in_hypercube_order_is_the_hypercube(P):
    rng = np.random.default_rng(P)
    part = torch.from_numpy(rng.standard_normal((P, P, 3, 4)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((P, 3, 4)).astype(np.float32))
    order = list(reversed(range(max(P.bit_length() - 1, 0))))
    assert torch.equal(fold_bits(part, P, order),
                       hypercube_reduce_scatter(part, P))
    assert torch.equal(unfold_bits(x, P, order), hypercube_allgather(x, P))


def test_register_new_topology_is_reachable():
    """A topology registered at run time is reachable from every spec
    string, and a hypercube under another name gives the hypercube's
    bits."""
    rng = np.random.default_rng(0)

    @register_topology("hypercube-twin")
    class HypercubeTwin(HypercubeTopology):
        """Same wires as hypercube — registered under a new name."""

    try:
        assert "hypercube-twin" in available_topologies()
        assert "ell+pipelined+hypercube-twin" in supported_topology_specs()
        coo = from_edges(rng.integers(0, 32, 300), rng.integers(0, 64, 300),
                         rng.uniform(0.1, 1.0, 300).astype(np.float32),
                         32, 64)
        x = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
        assert torch.equal(
            Engine("coo+serial+hypercube-twin").layer(coo, x, w,
                                                      device="cpu"),
            Engine("coo+serial").layer(coo, x, w, device="cpu"))
        for spec in ("ell+pipelined", "coo+serial"):
            got = Engine(f"{spec}+hypercube-twin").build(4, device="cpu")
            want = Engine(spec).build(4, device="cpu")
            assert got.topology.name == "hypercube-twin"
            g = torch.from_numpy(rng.standard_normal((32, 8)).astype(
                np.float32))
            ys = []
            for bundle in (got, want):
                xt = x.clone().requires_grad_(True)
                y = bundle.aggregate(xt, coo)
                (y * g).sum().backward()
                ys.append((y.detach(), xt.grad))
            assert torch.equal(ys[0][0], ys[1][0])
            assert torch.equal(ys[0][1], ys[1][1])
    finally:
        _TOPOLOGIES.pop("hypercube-twin", None)
    with pytest.raises(ValueError, match="registered topologies"):
        Engine("coo+serial+hypercube-twin")


def test_format_topology_restriction_enforced():
    """A format that restricts its topologies lists only those in the
    spec tables and gets the same loud ValueError as a bad schedule pair
    (the reference's ``test_format_topology_restriction_enforced``)."""

    @register_format("coo-hyperonly")
    class CooHyperOnly(CooFormat):
        topologies = ("hypercube",)

    try:
        assert format_topologies("coo-hyperonly") == ["hypercube"]
        assert format_topologies("coo") == available_topologies()
        assert "coo-hyperonly+serial+allpairs" not in \
            supported_topology_specs()
        assert "coo-hyperonly+serial+hypercube" in supported_topology_specs()
        assert supported_specs(three_part=True) == supported_topology_specs()
        EngineConfig.from_spec("coo-hyperonly+serial")          # default ok
        for name in TOPOLOGIES:
            with pytest.raises(ValueError, match="does not support topology"):
                EngineConfig.from_spec(f"coo-hyperonly+serial+{name}")
    finally:
        _FORMATS.pop("coo-hyperonly", None)
    assert "coo-hyperonly+serial+hypercube" not in supported_topology_specs()
