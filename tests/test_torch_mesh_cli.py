"""The Trainer CLI across processes on the CPU: ``torchrun --standalone
--nproc-per-node 2 -m repro_torch.launch.trainer --mesh --device cpu``
builds the gloo process group from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``), spreads 4 cores over the 2 ranks, trains,
checkpoints at the midpoint (rank 0 writes), resumes on every rank and
asserts zero drift; rank 0 alone prints.  The rendezvous is torchrun's own
on ``localhost`` (``--standalone`` takes a free port).  The hypercube's
``ell+pipelined`` and the 2-D torus's ``ell+pipelined+torus2d`` (its
orthogonal halves' rounds across the two ranks) each run once.
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _torchrun(spec):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.trainer",
         "--mesh", "--device", "cpu", "--spec", spec,
         "--n-cores", "4", "--dataset", "reddit", "--scale", "0.004",
         "--feat-dim", "16", "--hidden", "16", "--batch-size", "32",
         "--steps", "6", "--ckpt-restart"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert sum(ln.startswith(f"OK spec={spec}") for ln in lines) == 1
    assert any("cores=4 ranks=2 device=cpu" in ln for ln in lines)
    assert "resume drift vs uninterrupted: 0.00e+00" in out.stdout
    return out.stdout


def test_torchrun_mesh_cli_resumes_without_drift():
    _torchrun("ell+pipelined")


def test_torchrun_mesh_cli_torus2d_resumes_without_drift():
    assert "(resolved ell+pipelined+torus2d)" in _torchrun(
        "ell+pipelined+torus2d")
