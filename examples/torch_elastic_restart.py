"""Fault-tolerance walkthrough on the PyTorch port: train, lose a worker,
checkpoint, shrink the mesh plan, resume from the checkpoint — the full
recovery path in one file.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]
"""
import argparse
import tempfile

from repro_torch.checkpoint import CheckpointManager, scale_plan
from repro_torch.launch.train import train_lm


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as ckpt:
        print("== phase 1: train with a worker dying at step 5 ==")
        out = train_lm("llama3.2-1b", smoke=True, steps=10, batch=2, seq=32,
                       ckpt_dir=ckpt, fault_at=5, log_every=2,
                       device=args.device)
        print(f"survivors: {out['survivors']} (worker 3 evicted)")

        plan = scale_plan(n_available=255, model_parallel=16)
        print(f"survivor mesh plan: {plan.mesh_shape} "
              f"({plan.n_devices} devices)")

        print("== phase 2: resume from the crash checkpoint ==")
        mgr = CheckpointManager(ckpt)
        print(f"resuming from step {mgr.latest_step()}")
        out2 = train_lm("llama3.2-1b", smoke=True, steps=14, batch=2, seq=32,
                        ckpt_dir=ckpt, resume=True, log_every=2,
                        device=args.device)
        print(f"final loss {out2['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
