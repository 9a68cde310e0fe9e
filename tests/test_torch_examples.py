"""The last two examples of the port, run on the CPU (``--device cpu``) with
few steps:

* ``examples/torch_quickstart.py`` (``train_gcn`` on flickr, ``coo+serial``,
  the ours dataflow, a checkpoint directory) prints the sequence
  estimator's per-layer orders that the reference's ``train_gcn`` reports
  for the same configuration (its example's 100 steps take a minute here,
  so the reference runs none) and its loss line;
* ``examples/torch_distributed_gcn.py`` (the Trainer on stacked cores,
  the reference example's defaults and flags) trains and reports each
  epoch; the reference's example needs 16 forced XLA devices and is not
  cheap, so its output is not compared;
* without ``--device`` an example runs on the card, and raises on a
  machine without one.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, SRC  # noqa: E402


def _start(script, *args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", script), *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=180):
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def test_quickstart_example_prints_the_references_orders():
    proc = _start("torch_quickstart.py", "--device", "cpu", "--steps", "3")
    from repro.launch.train import train_gcn as ref_train_gcn

    ref = ref_train_gcn("flickr", model="gcn", dataflow="ours",
                        engine="coo+serial", scale=0.01, batch_size=64,
                        steps=0, lr=0.05, log_every=0)
    rc, out, err = _finish(proc)
    assert rc == 0, err
    assert f"estimator chose per-layer orders: {ref['orders']}" in out
    assert "loss: " in out.splitlines()[-1]


def test_distributed_example_trains_on_stacked_cores():
    procs = [_start("torch_distributed_gcn.py", "--device", "cpu",
                    "--epochs", "2", "--steps-per-epoch", "2",
                    "--n-cores", "4"),
             _start("torch_distributed_gcn.py", "coo+serial", "--device",
                    "cpu", "--epochs", "1", "--steps-per-epoch", "1",
                    "--n-cores", "2", "--feature-store", "mmap",
                    "--cache-capacity", "64")]
    if not torch.cuda.is_available():
        procs.append(_start("torch_quickstart.py", "--steps", "1"))
    results = [_finish(p) for p in procs]
    rc, out, err = results[0]
    assert rc == 0, err
    assert out.startswith("cores: 4 stacked on cpu")
    assert "engine spec: ell+pipelined" in out
    assert "epoch 2: val_acc" in out and "done — loss" in out
    rc, out, err = results[1]
    assert rc == 0, err
    assert "engine spec: coo+serial" in out
    assert "out-of-core via the mmap store" in out
    assert "cache hit-rate" in out
    if len(results) > 2:
        rc, _, err = results[2]
        assert rc != 0 and "device='cpu'" in err
