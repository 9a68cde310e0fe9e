"""The one-device dry run's record of ``stablelm-3b × prefill_32k`` at its
published config, traced on fake CPU tensors: the grid cell that reached
``flash_mha`` at head dim 80 (stablelm-3b's), which the card's checks
refused before they took it.  (A file of its own: the CPU's path runs the
plain attention block by block, ~30 s of tracing.)"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

from test_torch_dryrun import RECORD_KEYS  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stablelm_prefill_32k_traces_at_its_published_config():
    """The grid cell that reached ``flash_mha`` at head dim 80."""
    rec = dryrun.dryrun_cell("stablelm-3b", "prefill_32k", device="cpu",
                             verbose=False)
    assert set(rec) >= RECORD_KEYS
    assert get_config("stablelm-3b").hd == 80
    assert (rec["mesh"], rec["n_chips"], rec["kind"]) == ("1", 1, "prefill")
    assert rec["collective_wire_bytes_per_device"] == 0
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "peak_bytes"}
    assert rec["fits"] == (mem["peak_bytes"] <= dryrun.H100_MEMORY)
    assert rec["roofline"]["dominant"] == "compute"
    assert rec["hlo_flops_per_device"] > rec["model_flops_global"] > 0
