"""``chip_smoke.py``'s phase 19 (the LM on a ``(data, model)`` mesh)
rehearsed on the CPU: a one-rank gloo group in place of NCCL, a ``cpu``
mesh in place of ``cuda``, moonshot-v1-16b-a3b's smoke config (at the
phase's ``MOE_LAYERS`` layers) at s = 2048 with ``FLASH_THRESHOLD``
lowered to 1024, the plain versions of ``flash_mha`` / ``flash_mha_bwd``
made to count launches as the card's kernels do, and host-side stand-ins
for the CUDA clocks and memory calls.  What it shows: the phase's
control flow and gates — the mesh step's loss and params against the
unsharded step's (bit-equal on one rank), no flipped route, the same
launches in both arms, the prefill's logits, one MoE layer's wire of one
all-gather and one reduce-scatter, the elastic restore's leaf and loss
bits — not a time or a memory size.
"""
import os
import sys

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


def test_chip_smoke_lm_mesh_phase_rehearsal(monkeypatch, tmp_path, capsys):
    import torch._dynamo  # noqa: F401  (the checkpoint imports it)
    import torch.distributed as dist

    import repro_torch.configs as configs
    from repro_torch.kernels import flash
    from repro_torch.models import transformer as tf

    cs = chip_smoke
    monkeypatch.setattr(tf, "FLASH_THRESHOLD", 1024)
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    monkeypatch.setattr(cs, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "LONG_GATE_S", 2048)
    monkeypatch.setattr(cs, "MESH_BACKEND", "gloo")
    monkeypatch.setattr(cs, "MESH_DEVICE", "cpu")
    forward, backward = flash.mha_ref, flash.mha_bwd_ref

    def counted_forward(*args, **kw):
        flash.flash_mha.launches += 1
        return forward(*args, **kw)

    def counted_backward(*args, **kw):
        flash.flash_mha_bwd.launches += 1
        return backward(*args, **kw)

    monkeypatch.setattr(flash, "mha_ref", counted_forward)
    monkeypatch.setattr(flash, "mha_bwd_ref", counted_backward)
    for name, fake in (("synchronize", lambda *a: None),
                       ("reset_peak_memory_stats", lambda *a: None),
                       ("max_memory_allocated", lambda *a: 10 ** 9),
                       ("memory_allocated", lambda *a: 0),
                       ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fake)
    cpu = torch.device("cpu")

    out, launches = cs.lm_mesh_phase(torch, cpu, np.random.default_rng(0))
    cs.print_lm_mesh(out, "cpu rehearsal")
    tr = out["train"]
    assert tr["loss_bits_equal"] and tr["params_bit_equal"]
    assert tr["flipped_routes"] == 0 and tr["route_calls"] == 2 * 4
    assert tr["mesh"]["launches"] == {"flash_mha": 8, "flash_mha_bwd": 4}
    assert out["placed_in_place"]
    assert out["prefill_bit_equal"]
    assert sorted(c[0] for c in out["wire"]["calls"]) == [
        "all_gather_into_tensor", "reduce_scatter_tensor"]
    assert out["wire"]["bytes"] == 2 * out["wire"]["activation_bytes"]
    el = out["elastic"]
    assert el["leaves_bit_equal"] and el["loss_bits_equal"]
    assert el["leaves"] == 3 * 12 + 1 and el["bytes"] > 0
    assert launches["lm mesh train s=2048"]["flash_mha_bwd"] == 4
    assert launches["lm mesh prefill s=2048"]["flash_mha"] == 4
    assert not dist.is_initialized()
    assert not os.listdir(tmp_path)
    assert "lm mesh: moonshot-v1-16b-a3b" in capsys.readouterr().out
