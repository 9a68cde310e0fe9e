"""``chip_smoke.py``'s phase 15 (the LM families) rehearsed on the CPU at
smoke widths: the window kernel's checks on gemma3's layer-0 q, k, v, the
families' prefills with their ``flash_mha`` launch counts, the servers,
the MoE gate's route comparison, seamless's encoder / cross-attention
calls and decode, and card-vs-CPU training, with the card's timers and
memory counters replaced by host stand-ins.  One intra-op thread: the
smoke models are small, and more threads only contend.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import REPO  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_lm_families_phase_rehearsal(monkeypatch, capsys):
    """Phase 15 end to end on the CPU with each family's smoke config
    standing in for the published one, ``FLASH_THRESHOLD`` lowered to 1024
    keys so that 2048-token prompts take the flash branch (gemma3's
    1024-key window then masks), ``flash_mha``'s plain version counting
    its launches as the kernel would, host clocks for the card's timers
    and a null SDPA backend choice: every gate passes (the launch counts,
    card vs CPU, no route flips, decode vs forward, the training losses)."""
    import contextlib
    import importlib
    import types

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from repro_torch.kernels import flash_mha
    from repro_torch.models import transformer as tf

    configs = importlib.import_module("repro_torch.configs")
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    monkeypatch.setattr(tf, "FLASH_THRESHOLD", 1024)

    def counting(q, k, v, **kw):          # the kernel's counters, on a host
        flash_mha.launches += 1
        flash_mha.window_launches += kw.get("window") is not None
        return flash_mha(q, k, v, **kw)

    monkeypatch.setattr(tf, "flash_mha", counting)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    nn_attention = importlib.import_module("torch.nn.attention")
    monkeypatch.setattr(nn_attention, "sdpa_kernel",
                        lambda *a: contextlib.nullcontext())
    monkeypatch.setattr(cs, "time_ms",
                        lambda torch_, fn, reps=None: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "host_ms", lambda torch_, fn: (fn(), 0.5)[1])
    monkeypatch.setattr(cs, "queued_ms",
                        lambda torch_, fn, c=None: (fn(), (1.0, None))[1])
    monkeypatch.setattr(cs, "kernel_ms", lambda torch_, fn, w, n=1: (
        fn(), (1.0, cs.REPS * n))[1])
    monkeypatch.setattr(cs, "device_peaks", lambda torch_: types.SimpleNamespace(
        bw=3.35e12, tf32=4.95e14, fp32=6.7e13, bf16=9.89e14))
    for name, value in (("FAMILY_S", 2048), ("FAMILY_GATE_S", 3072),
                        ("ENC_FRAMES", 2048), ("DEC_TOKENS", 512),
                        ("MOE_GATE_ROWS", 64),
                        ("LM_FAMILIES_PHASE_S", 900.0),
                        ("WINDOW_EDGES", cs.WINDOW_EDGES[:2]
                         + cs.WINDOW_EDGES[4:7] + cs.WINDOW_EDGES[-1:]),
                        ("SERVE_EXAMPLE_ARGS", cs.SERVE_EXAMPLE_ARGS
                         + ("--device", "cpu"))):
        monkeypatch.setattr(cs, name, value)
    rec, fam, launches = cs.lm_families_phase(torch, torch.device("cpu"),
                                              np.random.default_rng(0))
    cs.print_lm_families(rec, fam, "a host, no card")
    assert launches["gemma3 prefill s=16384"]["flash_mha_window"] \
        == 5 * (1 + cs.FAMILY_PREFILL_REPS)
    assert launches["gemma3 prefill s=16384"]["flash_mha"] \
        == 1 + cs.FAMILY_PREFILL_REPS
    assert launches["ssm prefill s=16384"]["flash_mha"] == 0
    assert launches["hybrid prefill s=16384"]["flash_mha"] \
        == 1 + cs.FAMILY_PREFILL_REPS          # the smoke's 7 layers: 1
    assert fam["encdec"]["encoder_calls"] == fam["encdec"]["cross_calls"] \
        == 2
    assert fam["moe"]["gate"]["flipped_token_layer_slots"] == 0
    assert fam["moe"]["gate"]["card_vs_cpu_max_abs"] == 0.0
    assert len(fam["moe"]["drop_fraction_per_layer"]) == cs.MOE_LAYERS
    assert rec["max_abs_err"] <= cs.FLASH_TOL
    assert all(t["card_vs_cpu_rel"] == 0.0
               for t in fam["training"].values())
    assert "lm families seamless" in capsys.readouterr().out
