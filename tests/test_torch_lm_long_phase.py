"""``chip_smoke.py``'s phase 16 (LM training past ``FLASH_THRESHOLD``)
rehearsed on the CPU at smoke sizes, with the kernels' plain versions.

The threshold is lowered to 1024 and every sequence to 2048, the kernel
gates run at small shapes, the CPU launches of ``flash_mha`` /
``flash_mha_bwd`` are counted as the card's would be, the CUDA clocks and
memory calls are host-side stand-ins, and the CPU halves' processes run
in this one.  What it shows: the phase's control flow, its launch gates (2
forward and 1 backward launches a layer under remat, windowed ones apart),
its card-vs-CPU comparisons and its records — not a time or a memory size.
"""
import ast
import contextlib
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
    """``subprocess.Popen`` for the phase's CPU halves: runs its
    ``long_cpu_side`` call when the phase waits for it."""

    def __init__(self, args, **_):
        self.call = ast.literal_eval(args[-1].split("long_cpu_side", 1)[1])
        self.returncode = None

    def communicate(self, timeout=None):
        chip_smoke.long_cpu_side(*self.call)
        self.returncode = 0
        return None, ""

    def poll(self):
        return self.returncode

    def kill(self):
        pass

    def wait(self):
        pass


def test_chip_smoke_long_train_phase_rehearsal(monkeypatch, tmp_path):
    import torch._dynamo  # noqa: F401  (the checkpoint imports it)
    import torch.nn.attention as attention

    import repro_torch.configs as configs
    from repro_torch.kernels import flash
    from repro_torch.models import transformer as tf

    cs = chip_smoke
    monkeypatch.setattr(tf, "FLASH_THRESHOLD", 1024)
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "BWD_SHAPES", {
        "llama3.2-1b": (2, 256, 16, None), "gemma3-27b": (2, 256, 32, 64)})
    monkeypatch.setattr(cs, "BWD_EDGES", (
        (2, 256, 256, 16, True, 7, "float32"),
        (2, 128, 256, 16, False, None, "float32"),
        (2, 256, 256, 16, False, None, "bfloat16"),
        (2, 300, 100, 16, False, 50, "bfloat16")))   # rows >= 149: no key
    for name in ("LONG_TRAIN_S", "LONG_GATE_S"):
        monkeypatch.setattr(cs, name, 2048)
    monkeypatch.setattr(cs, "LONG_FAMILY_S", {cs.ENCDEC_ARCH: 2048})
    monkeypatch.setattr(cs, "LONG_TRAIN_STEPS", 1)
    forward, backward = flash.mha_ref, flash.mha_bwd_ref

    def counted_forward(*args, **kw):
        flash.flash_mha.launches += 1
        flash.flash_mha.window_launches += kw.get("window") is not None
        return forward(*args, **kw)

    def counted_backward(*args, **kw):
        flash.flash_mha_bwd.launches += 1
        flash.flash_mha_bwd.window_launches += kw.get("window") is not None
        return backward(*args, **kw)

    monkeypatch.setattr(flash, "mha_ref", counted_forward)
    monkeypatch.setattr(flash, "mha_bwd_ref", counted_backward)
    peaks = iter(range(10 ** 9, 10 ** 12, 10 ** 7))    # rises call by call
    for name, fake in (("Event", _Event), ("synchronize", lambda *a: None),
                       ("reset_peak_memory_stats", lambda *a: None),
                       ("max_memory_allocated", lambda *a: next(peaks)),
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
        Popen=_InProcess, DEVNULL=None, PIPE=None))

    rec, rec_w, detail, launches = cs.lm_long_train_phase(
        torch, torch.device("cpu"), np.random.default_rng(0))

    for r in (rec, rec_w):
        assert r["kernel_only_count"] == cs.REPS and r["bound_by"]
        assert set(r) >= {"max_abs_err", "max_abs_err_bf16", "ms",
                          "plain_ms", "bound_ms", "library_ms",
                          "library_kernel_only_ms", "host_ms"}
    assert detail["edges"]["bh2_sq300_sk100_hd16_full_w50_bfloat16"][
        "rows_without_keys"] == 2 * (300 - 149)
    layers = configs.get_smoke("llama3.2-1b").n_layers
    # the measured steps, then the profiled step and its warm-up step
    steps = cs.LONG_TRAIN_WARMUP + cs.LONG_TRAIN_STEPS + 2
    assert {k: v for k, v in launches["lm long training s=2048"].items()
            if v} == {"flash_mha": 2 * layers * steps,
                      "flash_mha_bwd": layers * steps}
    prof = detail["full"]["profiled"]
    assert prof["flash_mha_bwd_share"] is None    # no device records here
    assert prof["step_ms"] > 0
    fam = launches["lm long family training"]
    assert fam["flash_mha_bwd_window"] > 0 and fam["flash_mha_bwd"] > 0
    assert detail["gate"]["card_vs_cpu_rel"] == 0.0
    assert all(f["card_vs_cpu_rel"] == 0.0
               for f in detail["families"].values())
    assert not list(tmp_path.glob("*.npz"))
    cs.print_lm_long_train(rec, rec_w, detail, "NVIDIA H100 80GB HBM3, "
                           "700.00 W")
