"""Rules of the port that no parity test would notice.

* Neither the port package nor ``chip_smoke.py`` imports ``jax`` or the
  reference package ``repro`` (an ``ast`` scan of every import).
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


def test_kernel_sources_ship_with_the_package():
    csrc = REPO / "src" / "repro_torch" / "kernels" / "csrc"
    for name in ("spmm_ell", "gemm"):
        text = (csrc / f"{name}.cu").read_text()
        assert "Replaces:" in text and 'extern "C"' in text


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
    from repro_torch.kernels import _build, gemm, spmm_ell

    _no_cuda()
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        spmm_ell(torch.zeros((2, 2), dtype=torch.int32, **meta),
                 torch.zeros((2, 2), **meta), torch.zeros((3, 4), **meta))
    with pytest.raises(RuntimeError, match="CUDA"):
        gemm(torch.zeros((2, 3), **meta), torch.zeros((3, 4), **meta))
    for name in ("spmm_ell", "gemm"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.load(name)


def test_unported_parts_name_their_slice():
    from repro_torch.engine import Engine, EngineConfig

    # the Block-Message format is ported (block slice): a CPU bundle builds
    assert Engine("block+pipelined").build(n_cores=2,
                                           device="cpu").n_cores == 2
    with pytest.raises(NotImplementedError, match="planner"):
        EngineConfig.from_spec("auto")
    # the distributed bundle is ported (training slice); the reference's
    # other interconnects are not
    assert Engine("ell+pipelined").build(n_cores=2, device="cpu").n_cores == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine("ell+pipelined+ring").build(n_cores=2, device="cpu")
    with pytest.raises(ValueError, match="registered formats"):
        EngineConfig.from_spec("csr+serial")
    cfg = EngineConfig.from_spec("ell+pipelined+hypercube+mincom")
    assert cfg.spec == "ell+pipelined+hypercube+mincom"
    assert EngineConfig.from_spec("ell").spec == "ell+pipelined"
    assert EngineConfig.from_spec("coo+serial+ring").spec == "coo+serial+ring"
    with pytest.raises(ValueError, match="does not support schedule"):
        EngineConfig.from_spec("coo+pipelined")
