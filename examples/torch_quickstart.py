"""Quickstart on the PyTorch port — train the paper's 2-layer GCN on a
synthetic Flickr-like graph with the transpose-free dataflow, the sequence
estimator choosing the execution order, and checkpointing enabled.  Runs
on the card unless ``--device cpu``; on the card the ``coo+serial``
Engine aggregates, forward and backward, through the COO-walk kernel
(``spmm``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The aggregation engine is declared, not flag-selected: ``engine`` names a
registered format+schedule spec (``repro_torch.engine.supported_specs()``
lists them all).
"""
import argparse
import tempfile

from repro_torch.launch.train import train_gcn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as ckpt:
        out = train_gcn(
            "flickr",                # synthetic stand-in (paper §5.1 stats)
            model="gcn",             # or "sage"
            dataflow="ours",         # the paper's Table-1 redesign
            engine="coo+serial",     # Engine spec: format+schedule
            scale=0.01,              # a small graph
            batch_size=64,
            steps=args.steps,
            lr=0.05,
            ckpt_dir=ckpt,
            device=args.device,
        )
    print(f"\nestimator chose per-layer orders: {out['orders']}")
    print(f"loss: {out['loss_history'][0]:.4f} -> "
          f"{out['loss_history'][-1]:.4f} in {out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
