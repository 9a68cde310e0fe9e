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
"""
import ast
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
