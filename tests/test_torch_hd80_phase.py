"""``chip_smoke.py``'s phase 17 (head dim 80, the one-device dry run, the
last two examples) rehearsed on the CPU at smoke sizes, with the kernels'
plain versions.

``FLASH_THRESHOLD`` is lowered to 1024 and every sequence to 2048;
stablelm-3b is its smoke config at head dim 80; the CPU launches of
``flash_mha`` / ``flash_mha_bwd`` are counted as the card's would be; the
CUDA clocks and memory calls are host-side stand-ins; the dry run's and
the CPU halves' processes run in this one (the dry run over stablelm-3b's
cells at its smoke config, on the CPU's path); the examples run with
``--device cpu`` and few steps.  What it shows: the phase's control flow,
its launch gates and its records, and that the dry-run helper's count of
each reduced cell equals ``count_work`` of the real call — not a time or
a memory size (the CPU has no allocator peak to hold the trace's against,
so that gate is the card's alone).
"""
import ast
import contextlib
import io
import json
import os
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


class _InProcess:
    """``subprocess.Popen`` for the phase's two processes, run in this one
    when the phase waits for them: the CPU halves' ``hd80_cpu_side`` call,
    or the dry run's ``main`` over stablelm-3b's cells on the CPU."""

    def __init__(self, args, **_):
        self.args = list(args)
        self.returncode = None

    def communicate(self, timeout=None):
        from repro_torch.launch import dryrun

        if "-m" in self.args:
            argv = self.args[self.args.index("-m") + 2:]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                dryrun.main(argv + ["--device", "cpu", "--arch",
                                    chip_smoke.STABLELM_ARCH])
            self.returncode = 0
            return buf.getvalue(), None
        chip_smoke.hd80_cpu_side(ast.literal_eval(
            self.args[-1].split("hd80_cpu_side", 1)[1]))
        self.returncode = 0
        return None, ""

    def poll(self):
        return self.returncode

    def kill(self):
        pass

    def wait(self):
        pass


def test_chip_smoke_hd80_phase_rehearsal(monkeypatch, tmp_path):
    import torch._dynamo  # noqa: F401  (the checkpoint imports it)
    import torch.nn.attention as attention

    import repro_torch.configs as configs
    from repro_torch.kernels import flash
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf

    cs = chip_smoke

    def smoke_hd80(name):
        return configs.get_smoke(name).scaled(head_dim=80)

    monkeypatch.setattr(tf, "FLASH_THRESHOLD", 1024)
    monkeypatch.setattr(configs, "get_config", smoke_hd80)
    monkeypatch.setattr(dryrun, "get_config", smoke_hd80)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "HD80_EDGES", (
        (2, 100, 70, True, None, "float32"),
        (2, 64, 128, False, None, "float32"),
        (2, 128, 128, True, 20, "bfloat16")))
    for name in ("HD80_S", "HD80_GATE_S"):
        monkeypatch.setattr(cs, name, 2048)
    out = tmp_path / "dryrun.json"
    monkeypatch.setattr(cs, "DRYRUN_ARGS", (
        "-m", "repro_torch.launch.dryrun", "--out", str(out)))
    monkeypatch.setattr(cs, "DRYRUN_RECORDS", 3)      # stablelm-3b's cells
    monkeypatch.setattr(cs, "DRYRUN_SKIPS", 1)
    monkeypatch.setattr(cs, "DRYRUN_PEAK_RTOL", float("inf"))
    monkeypatch.setattr(cs, "HD80_EXAMPLES", (
        ("examples/torch_quickstart.py",
         ("--device", "cpu", "--steps", "2"), ()),
        ("examples/torch_distributed_gcn.py",
         ("--device", "cpu", "--epochs", "1", "--steps-per-epoch", "1",
          "--n-cores", "2"), ())))
    forward, backward = flash.mha_ref, flash.mha_bwd_ref

    def count(wrapper, q, kw):
        wrapper.launches += 1
        if kw.get("window") is not None:
            wrapper.window_launches += 1
        elif q.shape[-1] == 80:
            wrapper.hd80_launches += 1

    def counted_forward(*args, **kw):
        count(flash.flash_mha, args[0], kw)
        return forward(*args, **kw)

    def counted_backward(*args, **kw):
        count(flash.flash_mha_bwd, args[0], kw)
        return backward(*args, **kw)

    monkeypatch.setattr(flash, "mha_ref", counted_forward)
    monkeypatch.setattr(flash, "mha_bwd_ref", counted_backward)
    for name, fake in (("Event", _Event), ("synchronize", lambda *a: None),
                       ("reset_peak_memory_stats", lambda *a: None),
                       ("max_memory_allocated", lambda *a: 10 ** 9),
                       ("memory_allocated", lambda *a: 0),
                       ("empty_cache", lambda: None),
                       ("get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")):
        monkeypatch.setattr(torch.cuda, name, fake)

    def kernel_ms(torch_, fn, wrapper, launches=1):
        before = wrapper.launches
        fn()
        return 1.0, (wrapper.launches - before) * cs.REPS

    monkeypatch.setattr(cs, "kernel_ms", kernel_ms)
    monkeypatch.setattr(cs, "time_ms", lambda torch_, fn, reps=None: (
        fn(), 1.0)[1])
    monkeypatch.setattr(cs, "host_ms", lambda torch_, fn: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "queued_ms",
                        lambda torch_, fn, c=None: (fn(), (1.0, None))[1])
    monkeypatch.setattr(attention, "sdpa_kernel",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(cs, "subprocess", types.SimpleNamespace(
        Popen=_InProcess, DEVNULL=None, PIPE=None, STDOUT=None))

    rec, rec_b, detail, launches = cs.hd80_phase(
        torch, torch.device("cpu"), np.random.default_rng(0))

    for r in (rec, rec_b):
        assert r["kernel_only_count"] == cs.REPS and r["bound_by"]
        assert set(r) >= {"max_abs_err", "max_abs_err_bf16", "ms",
                          "plain_ms", "bound_ms", "library_ms",
                          "library_kernel_only_ms", "host_ms"}
    assert detail["kernels"]["shape"] == [4, 2048, 80]
    assert len(detail["kernels"]["edges"]) == 3
    layers = cs.STABLELM_LAYERS
    hd80 = {k: {n: c for n, c in v.items() if c} for k, v in launches.items()}
    # 1 warm-up and 1 measured prefill; 1 warm-up and 1 measured step
    assert hd80["stablelm prefill s=16384"] == {"flash_mha_hd80": 2 * layers}
    assert hd80["stablelm training s=16384"] == {
        "flash_mha_hd80": 2 * 2 * layers, "flash_mha_bwd_hd80": 2 * layers}
    assert hd80["stablelm dry-run check train"] == {
        "flash_mha_hd80": 2 * layers, "flash_mha_bwd_hd80": layers}
    gate_layers = configs.get_smoke("stablelm-3b").n_layers
    assert hd80["stablelm gates"] == {
        "flash_mha_hd80": cs.HD80_GATE_LAYERS + 2 * gate_layers,
        "flash_mha_bwd_hd80": gate_layers}
    assert all(not any(v.get(k, 0) for k in ("flash_mha", "flash_mha_bwd"))
               for v in launches.values())
    for kind, r in detail["dryrun_vs_card"].items():
        assert (r["traced_flops"], r["traced_bytes"]) == (
            r["card_flops"], r["card_bytes"]), kind
    assert detail["gates"]["prefill"]["card_vs_cpu_max_abs"] == 0.0
    assert detail["gates"]["train"]["card_vs_cpu_rel"] == 0.0
    assert "stablelm-3b x prefill_32k" in detail["dryrun"]
    assert len(json.loads(out.read_text())) == 4
    assert set(detail["examples"]) == {p for p, _, _ in cs.HD80_EXAMPLES}
    assert not list(tmp_path.glob("*.npz"))
    cs.print_hd80(rec, rec_b, detail, "NVIDIA H100 80GB HBM3, 700.00 W")
