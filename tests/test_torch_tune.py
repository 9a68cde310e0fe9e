"""The port's bucket-scheme autotuner (:mod:`repro_torch.kernels.tune`) on
the CPU.

* a caps sweep at the reference's toy size (n 512, deg 8, d 64) writes a
  ``"cpu"`` record that :func:`get_config` then reads, and a second call
  returns it without measuring;
* a record for another backend (the reference's ``"tpu"``, or a card's on
  a machine without it), a corrupt one and a malformed config block give
  the defaults;
* ``build_plan(caps=None)`` follows the record;
* the sweep's skewed graph is the reference's (the same draws in the same
  order), and ``autotune`` needs the card unless the CPU is asked for.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph import from_edges  # noqa: E402
from repro_torch.kernels import edgeplan, tune  # noqa: E402


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    monkeypatch.setenv(tune.ENV_PATH, str(tmp_path / "autotune.json"))
    tune.reset()
    yield tmp_path
    tune.reset()


def _record(tmp_path, obj):
    (tmp_path / "autotune.json").write_text(
        obj if isinstance(obj, str) else json.dumps(obj))
    tune.reset()


def test_defaults_without_a_record():
    assert tune.get_config() == tune.DEFAULTS == {"caps": "pow2"}
    cfg = tune.get_config()
    cfg["caps"] = "single"                 # callers get a copy
    assert tune.get_config()["caps"] == "pow2"
    assert tune.cache_path().endswith("autotune.json")


def test_caps_sweep_writes_a_cpu_record_that_get_config_reads(tmp_path):
    rec = tune.autotune(device="cpu", n_reps=1)
    assert rec["backend"] == "cpu"
    assert [r["caps"] for r in rec["sweep"]["caps"]] == tune.CAPS_CANDIDATES
    assert all(r["s_per_fwdbwd"] > 0 for r in rec["sweep"]["caps"])
    assert rec["sweep"]["tiles"] == []
    best = min(rec["sweep"]["caps"], key=lambda r: r["s_per_fwdbwd"])
    assert rec["config"] == {"caps": best["caps"]}
    on_disk = json.loads((tmp_path / "autotune.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert tune.get_config()["caps"] == best["caps"]
    # idempotent per file: the existing record comes back unmeasured
    assert tune.autotune(device="cpu", n_reps=1) is not rec
    assert tune.autotune(device="cpu", n_reps=1) == on_disk


@pytest.mark.parametrize("record", [
    {"backend": "tpu", "config": {"br": 64, "caps": "single"}},
    {"backend": "cuda:NVIDIA H100 80GB HBM3", "config": {"caps": "single"}},
    "{not json", "[1, 2]", {"backend": "cpu", "config": [["caps"]]}])
def test_other_backend_corrupt_or_malformed_record_gives_defaults(
        tmp_path, record):
    if torch.cuda.is_available() and isinstance(record, dict) \
            and record["backend"].startswith("cuda:"):
        pytest.skip("this machine has a card: its own record may apply")
    _record(tmp_path, record)
    assert tune.get_config() == tune.DEFAULTS


@pytest.mark.parametrize("caps", ["single", [2, 8, 32]])
def test_build_plan_without_caps_follows_the_record(tmp_path, caps):
    if torch.cuda.is_available():
        pytest.skip("this machine's records are keyed by its card")
    _record(tmp_path, {"backend": "cpu", "config": {"caps": caps}})
    rng = np.random.default_rng(1)
    rows = np.concatenate([rng.integers(0, 64, 400),
                           rng.integers(0, 4, 200)])
    coo = from_edges(rows, rng.integers(0, 64, 600),
                     rng.uniform(0.1, 1, 600).astype(np.float32), 64, 64)
    got = edgeplan.build_plan(coo)
    want = edgeplan.build_plan(coo, caps=caps)
    default = edgeplan.build_plan(coo, caps="pow2")
    shapes = [c.shape for c in got.fwd.cols]
    assert shapes == [c.shape for c in want.fwd.cols]
    assert shapes != [c.shape for c in default.fwd.cols]


def test_skewed_graph_is_the_references():
    """The sweep draws the reference's graph (``_bench_plan_caps``'s rng
    calls in its order), rebuilt here from the same seed."""
    coo, rng = tune.skewed_graph(256, 4, 3)
    want = np.random.default_rng(3)
    rows = np.concatenate([want.integers(0, 256, 1024),
                           want.integers(0, 16, 512)])
    cols = want.integers(0, 256, 1536)
    vals = np.abs(want.standard_normal(1536)).astype(np.float32) + 0.1
    assert np.array_equal(coo.rows.numpy(), rows)
    assert np.array_equal(coo.cols.numpy(), cols)
    assert np.array_equal(coo.vals.numpy(), vals)
    assert np.array_equal(rng.standard_normal(4), want.standard_normal(4))


def test_autotune_needs_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.autotune()
    assert tune.backend_key("cpu") == "cpu"
