"""Rules of the port that no parity test would notice.

* Neither the port package nor ``chip_smoke.py`` imports ``jax`` or the
  reference package ``repro`` (an ``ast`` scan of every import).
* The kernels are the lowest layer: no module of ``repro_torch.kernels``
  imports a package above it (the engine, the trainers and CLIs, serving)
  when it loads.  A function may (the autotuner times the engine's
  aggregate), since that import cannot cycle back through the kernels.
* Entry points run on the card by default and raise on a machine without
  one; a kernel wrapper given a tensor that is not on the CPU launches its
  kernel or raises, never quietly takes the plain version.
* Every function of the LM modules with a reference counterpart (and
  ``launch/steps.py::build_step``) accepts every keyword the reference's
  signature has, but the documented decisions (``sp_spec``).
"""
import ast
import importlib
import inspect
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_reference(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


KERNEL_FILES = sorted((REPO / "src" / "repro_torch" / "kernels").glob("*.py"))
ABOVE_KERNELS = ("repro_torch.engine", "repro_torch.launch",
                 "repro_torch.serving", "repro_torch.distributed",
                 "repro_torch.models", "repro_torch.topology")


def _load_time_imports(node):
    """Every absolute module imported when the module loads: imports in
    its body, outside any function."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        if isinstance(child, ast.Import):
            yield from (alias.name for alias in child.names)
        elif isinstance(child, ast.ImportFrom) and child.level == 0:
            yield child.module
        else:
            yield from _load_time_imports(child)


@pytest.mark.parametrize("path", KERNEL_FILES, ids=lambda p: p.name)
def test_kernels_import_no_layer_above_them(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(m for m in _load_time_imports(tree)
                 if m.startswith(ABOVE_KERNELS))
    assert not bad, f"kernels/{path.name} imports {bad}"


def test_kernel_sources_ship_with_the_package():
    csrc = REPO / "src" / "repro_torch" / "kernels" / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    assert {p.stem for p in sources} >= {"spmm_ell", "spmm_coo", "gemm",
                                         "flash_mha"}
    for path in sources:
        text = path.read_text()
        assert "Replaces:" in text and 'extern "C"' in text, path.name


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_inference_engine_defaults_to_cuda_and_raises():
    from repro_torch.graph import make_dataset
    from repro_torch.serving import InferenceEngine, params_from_reference

    _no_cuda()
    ds = make_dataset("flickr", scale=0.004, feat_dim=4)
    params = [{"w": np.ones((4, 3), np.float32)},
              {"w": np.ones((3, 2), np.float32)}]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine("ell+pipelined", ds.graph, ds.features, params=params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference(params)
    eng = InferenceEngine("ell+pipelined", ds.graph, ds.features,
                          params=params, device="cpu")
    assert eng.query([0]).shape == (1, 2)


def test_engine_layer_defaults_to_cuda_and_raises():
    from repro_torch.engine import Engine
    from repro_torch.graph import from_edges

    _no_cuda()
    coo = from_edges([0, 1], [1, 0], [0.5, 0.5], 2, 2)
    x, w = torch.ones((2, 3)), torch.ones((3, 2))
    for spec in ("ell+pipelined", "coo+serial"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(spec).layer(coo, x, w)
        assert Engine(spec).layer(coo, x, w, device="cpu").shape == (2, 2)


def test_kernel_wrappers_never_fall_back_off_the_cpu():
    from repro_torch.kernels import _build, flash_mha, gemm, spmm_ell

    _no_cuda()
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        spmm_ell(torch.zeros((2, 2), dtype=torch.int32, **meta),
                 torch.zeros((2, 2), **meta), torch.zeros((3, 4), **meta))
    with pytest.raises(RuntimeError, match="CUDA"):
        gemm(torch.zeros((2, 3), **meta), torch.zeros((3, 4), **meta))
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_mha(*(torch.zeros((1, 64, 16), **meta),) * 3, q_block=64,
                  k_block=64)
    for name in ("spmm_ell", "gemm", "spmm_coo", "flash_mha"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.load(name)


def test_unported_parts_name_their_slice(monkeypatch, tmp_path):
    for var in ("REPRO_TORCH_PLANNER_PATH", "REPRO_TORCH_TOPOLOGY_PATH"):
        monkeypatch.setenv(var, str(tmp_path / f"{var}.json"))
    from repro_torch.engine import Engine, EngineConfig

    # the Block-Message format is ported (block slice): a CPU bundle builds
    assert Engine("block+pipelined").build(n_cores=2,
                                           device="cpu").n_cores == 2
    # the planner is ported (planner slice): "auto" parses and resolves
    assert EngineConfig.from_spec("auto").is_auto
    assert not Engine("auto").resolve(2, device="cpu").is_auto
    # the distributed bundle is ported (training slice), and so are the
    # reference's other interconnects
    assert Engine("ell+pipelined").build(n_cores=2, device="cpu").n_cores == 2
    assert Engine("ell+pipelined+ring").build(n_cores=2,
                                              device="cpu").n_cores == 2
    with pytest.raises(ValueError, match="registered topologies"):
        Engine("ell+pipelined+mesh3d")
    with pytest.raises(ValueError, match="registered formats"):
        EngineConfig.from_spec("csr+serial")
    cfg = EngineConfig.from_spec("ell+pipelined+hypercube+mincom")
    assert cfg.spec == "ell+pipelined+hypercube+mincom"
    assert EngineConfig.from_spec("ell").spec == "ell+pipelined"
    assert EngineConfig.from_spec("coo+serial+ring").spec == "coo+serial+ring"
    with pytest.raises(ValueError, match="does not support schedule"):
        EngineConfig.from_spec("coo+pipelined")


# ---------------------------------------------------------------------------
# The reference's public API: every ported package exports what the
# reference's exports, less the unported modules of ROADMAP Queue 1 and the
# documented decisions.
# ---------------------------------------------------------------------------
NOT_PORTED = {
    # Queue 1 item 10: placing trees on a JAX device mesh; their
    # counterpart is a torch.distributed device mesh (multi-GPU backend)
    "checkpoint": {"make_mesh_from_plan", "reshard", "shardings_like"},
    # the jax-only gcn_layer_blocked / gcn_layer_ell shims (a documented
    # decision)
    "core": {"gcn_layer_blocked", "gcn_layer_ell"},
    # Queue 1 item 9: lm_batch_specs is the dry run's (launch/dryrun.py)
    "data": {"lm_batch_specs"},
    # Queue 1 item 9: distributed/sharding.py (GSPMD rules, a documented
    # decision)
    "distributed": {"sharding"},
}
PORTED_PACKAGES = ("checkpoint", "core", "data", "distributed", "engine",
                   "featurestore", "graph", "kernels", "models", "optim",
                   "serving", "topology")


@pytest.mark.parametrize("pkg", PORTED_PACKAGES)
def test_ported_packages_export_the_reference_api(pkg):
    import importlib

    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = set(ref.__all__) - set(port.__all__) - NOT_PORTED.get(pkg,
                                                                    set())
    assert not missing, f"repro_torch.{pkg} lacks {sorted(missing)}"
    stale = NOT_PORTED.get(pkg, set()) & set(port.__all__)
    assert not stale, f"ported now, drop from NOT_PORTED: {sorted(stale)}"
    for name in port.__all__:
        assert hasattr(port, name), f"repro_torch.{pkg}.{name}"


def test_engine_config_has_the_reference_fields_and_precision():
    import dataclasses

    from repro.engine import EngineConfig as RefConfig
    from repro_torch.engine import EngineConfig
    from repro_torch.engine.config import PRECISIONS

    ref = {f.name for f in dataclasses.fields(RefConfig)}
    port = {f.name for f in dataclasses.fields(EngineConfig)}
    # the mesh axis has no counterpart on the stacked cores (a decision)
    assert ref - port == {"axis"}
    assert PRECISIONS == ("fp32",)
    cfg = EngineConfig.from_spec("ell+pipelined", precision="fp32")
    assert cfg.precision == "fp32" == cfg.with_spec("coo+serial").precision
    for pkg in (RefConfig, EngineConfig):
        with pytest.raises(ValueError, match="precision"):
            pkg.from_spec("ell+pipelined", precision="fp8")


def test_spmm_t_ref_matches_reference(rng):
    import jax.numpy as jnp

    from repro.kernels.ref import spmm_t_ref as ref_spmm_t_ref
    from repro_torch.kernels import spmm_t_ref

    n_dst, n_src, nnz = 30, 45, 300
    rows = rng.integers(0, n_dst, nnz)
    cols = rng.integers(0, n_src, nnz)
    vals = rng.uniform(-1, 1, nnz).astype(np.float32)
    vals[:10] = 0.0                          # padding entries
    e = rng.standard_normal((n_dst, 7)).astype(np.float32)
    want = np.asarray(ref_spmm_t_ref(jnp.asarray(rows), jnp.asarray(cols),
                                     jnp.asarray(vals), jnp.asarray(e),
                                     n_src))
    got = spmm_t_ref(torch.from_numpy(rows.astype(np.int32)),
                     torch.from_numpy(cols.astype(np.int32)),
                     torch.from_numpy(vals), torch.from_numpy(e), n_src)
    assert got.shape == (n_src, 7)
    assert np.abs(got.numpy() - want).max() <= 1e-5


def test_edgeplan_cache_clear_empties_the_plan_lru():
    from repro_torch.graph import from_edges
    from repro_torch.kernels import edgeplan

    coo = from_edges([0, 1, 1], [1, 0, 2], [0.5, 0.5, 1.0], 2, 3)
    plan = edgeplan.build_plan(coo)
    assert edgeplan.build_plan(coo) is plan  # cached
    edgeplan.cache_clear()
    assert not edgeplan._cache
    misses = edgeplan.cache_stats()["misses"]
    assert edgeplan.build_plan(coo) is not plan
    assert edgeplan.cache_stats()["misses"] == misses + 1


# ---------------------------------------------------------------------------
# The reference's keywords on the LM side: a dropped keyword (remat, before
# it was restored) changes what a caller's step computes without an error.
# ---------------------------------------------------------------------------
#: keywords the port does not take, each a documented decision: the GSPMD
#: constraints are not ported (ROADMAP Queue 1 item 9)
SIGNATURE_DECISIONS = {"sp_spec"}
LM_MODULES = ("models.transformer", "models.moe", "models.mamba2",
              "models.hybrid", "models.encdec", "models.lm")


def _keywords(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind is p.KEYWORD_ONLY or p.default is not p.empty]


@pytest.mark.parametrize("mod", LM_MODULES + ("launch.steps",))
def test_lm_functions_take_the_reference_keywords(mod):
    ref = importlib.import_module(f"repro.{mod}")
    port = importlib.import_module(f"repro_torch.{mod}")
    names = ["build_step"] if mod == "launch.steps" else [
        n for n, f in vars(ref).items()
        if inspect.isfunction(f) and f.__module__ == ref.__name__]
    checked = 0
    for name in names:
        fn = getattr(port, name, None)
        if not inspect.isfunction(fn):
            continue                # not ported (ROADMAP Queue 1)
        missing = set(_keywords(getattr(ref, name))) \
            - set(inspect.signature(fn).parameters) - SIGNATURE_DECISIONS
        assert not missing, f"repro_torch.{mod}.{name} lacks {sorted(missing)}"
        checked += 1
    assert checked
