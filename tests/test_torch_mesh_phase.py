"""``chip_smoke.py``'s phase 18 (the ``torch.distributed`` mesh on one
rank), rehearsed on the CPU: a one-rank gloo group in place of NCCL, a
``cpu`` mesh in place of ``cuda``, reddit at scale 0.01, batch 64, hidden
32, the kernel wrappers' plain versions made to report launches (as the
card's kernels count them), host-clock CUDA events and a stub profiler.
Phase 7's ``ell+pipelined`` losses and launches come from the stacked
Trainer on the same seeded checkpoint, so the phase's gates — losses
equal to phase 7's bit for bit, ``spmm_ell`` / ``spmm_ell_t`` launches
equal each step, ``grad_accum`` over ``model`` the local call's bits —
hold the one-rank mesh path to the stacked one here as on the card, in
every run of the phase's stacked, mesh, mesh, stacked sequence.  The
torus2d arm (``ell+pipelined+torus2d`` stacked, then on the mesh
``make_topology_mesh(16, "torus2d")`` builds) and the int8
``compressed_psum`` over the mesh's layout are held to their stacked runs
the same way.
"""
import importlib
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph import make_dataset  # noqa: E402


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def query(self):
        return False

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_mesh_phase_rehearsal(tmp_path, monkeypatch, capsys):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    spmm_mod = importlib.import_module("repro_torch.kernels.spmm")
    run, walk, coo = spmm_mod._run, spmm_mod._walk, spmm_mod._coo_walk
    monkeypatch.setattr(spmm_mod, "_run", lambda name, c, v, x, out: (
        run(name, c, v, x, out)[0], c.shape[-2] > 0))
    monkeypatch.setattr(spmm_mod, "_walk", lambda name, w, x, out: (
        walk(name, w, x, out) or bool(w.cols and len(w.items))))
    monkeypatch.setattr(spmm_mod, "_coo_walk",
                        lambda *a: (coo(*a)[0], True))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(cs, "profiled", lambda torch_, fn: (
        [], (lambda t0: (fn(), time.perf_counter() - t0)[1])(
            time.perf_counter())))
    monkeypatch.setattr(cs, "TRAIN_BATCH", 64)
    monkeypatch.setattr(cs, "HIDDEN", 32)
    monkeypatch.setattr(cs, "REPS", 2)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "MESH_BACKEND", "gloo")
    monkeypatch.setattr(cs, "MESH_DEVICE", "cpu")
    cpu = torch.device("cpu")

    tds = make_dataset("reddit", scale=0.01)
    spec = "ell+pipelined"
    tr = cs.seeded_trainer(tds, cs.train_params(tds), spec)(
        spec, "card", input_pipeline="prefetch", device=cpu)
    losses, per_step = [], []
    for _ in range(cs.MESH_WARMUP + cs.MESH_STEPS):
        counts = dict.fromkeys(cs.KERNELS, 0)
        losses += cs.counted(counts, tr.train_steps, 1)
        per_step.append(counts)
    train = {spec: {"losses": losses, "launches_each_step": per_step,
                    "ms_per_step_median": 1.0,
                    "host_stall_ms_per_step": tr.stall_per_step * 1e3,
                    "place_ms_per_step": tr.place_per_step * 1e3}}
    tr.close()

    out, launches = cs.mesh_phase(torch, cpu, tds, train)
    cs.print_mesh(out, "cpu rehearsal")
    assert out["losses"] == losses and out["equal_to_phase7"]
    assert out["grad_accum_equal"] and out["ranks"] == 1
    assert launches[f"mesh {spec}"]["spmm_ell"] > 0
    assert launches[f"mesh {spec}"]["spmm_ell_t"] > 0
    assert out["weight_bank_all_reduce"]["floats"] > 1
    assert np.isfinite(out["ms_per_step_median"])
    assert list(out["arms"]) == ["stacked, no group", "stacked 1", "mesh 1",
                                 "mesh 2", "stacked 2"]
    for arm in out["arms"].values():
        assert arm["losses"] == losses
        assert np.isfinite(arm["place_ms_per_step"])
    assert np.isfinite(out["stacked_ms_per_step_median"])
    torus = out["torus2d"]
    assert len(torus["losses"]) == cs.MESH_TORUS_STEPS
    assert np.all(np.isfinite(torus["losses"]))
    assert 0 < torus["arm_s"] <= cs.MESH_TORUS_S
    assert np.isfinite(torus["ms_per_step_median"])
    assert np.isfinite(torus["stacked_ms_per_step_median"])
    for k in ("spmm_ell", "spmm_ell_t"):
        assert launches[f"mesh {cs.MESH_TORUS_SPEC}"][k] > 0
        assert all(step[k] > 0 for step in torus["launches_each_step"])
    assert out["compressed_psum_equal"]
    import torch.distributed as dist
    assert not dist.is_initialized()
    printed = capsys.readouterr().out
    assert "mesh training ell+pipelined (" in printed
    assert "mesh training ell+pipelined+torus2d" in printed
