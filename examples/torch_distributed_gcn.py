"""The paper's architecture end-to-end on the PyTorch port, through the
engine-native Trainer: 16 stacked cores on one device play the paper's 16
cores — local combination GEMMs, hypercube message-passing aggregation
with sender-side pre-reduction, transpose-free backward, Weight-Bank
gradient sync — while the async input pipeline (sampling + per-batch
layout build on a prefetch thread, depth-2 double buffering) keeps the
device step fed (paper §4.2–4.3).  Runs on the card unless ``--device
cpu``; on the card the default ``ell+pipelined`` spec walks its ELL
tables through ``spmm_ell`` (forward) and ``spmm_ell_t`` (backward).

    PYTHONPATH=src python examples/torch_distributed_gcn.py [SPEC] \\
        [--dataset reddit|flickr|yelp|amazonproducts] [--epochs 2] \\
        [--device cpu]

SPEC is an engine spec string (default ``ell+pipelined``) — any registered
format+schedule combination trains unchanged: ``coo+serial``,
``block+pipelined``, ``ell+pipelined``.  ``--feature-store mmap`` moves the
node features out-of-core: only each batch's frontier rows stream to the
device through the staged prefetch chain (sample → gather → layout →
place), and a degree-keyed hot-vertex cache absorbs the hub traffic.  The
cores are stacked on one device (a leading core axis).  Over N GPUs, N
processes split the cores, the hypercube folding across them::

    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.trainer \\
        --mesh --spec ell+pipelined --n-cores 16 --dataset reddit --steps 20
"""
import argparse

from repro_torch.launch.trainer import Trainer


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("spec", nargs="?", default="ell+pipelined")
    ap.add_argument("--dataset", default="reddit",
                    help="synthetic stand-in to train on (flickr, reddit, "
                         "yelp, amazonproducts)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--n-cores", type=int, default=16)
    ap.add_argument("--feature-store", default="device",
                    help="'device' (dense in-memory features) or a "
                         "registered featurestore backend ('host', 'mmap')"
                         " to stream frontier rows out-of-core")
    ap.add_argument("--cache-capacity", type=int, default=256,
                    help="hot-vertex cache rows in front of the store")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()

    fs = None if args.feature_store == "device" else args.feature_store
    trainer = Trainer(args.spec, args.dataset, n_cores=args.n_cores,
                      scale=0.005, feat_dim=64, hidden=64, batch_size=64,
                      fanouts=(5, 10), lr=0.1, seed=0,
                      input_pipeline="prefetch", pad_multiple=64,
                      val_batches=2, feature_store=fs,
                      cache_capacity=args.cache_capacity, device=args.device)
    print(f"cores: {trainer.n_cores} stacked on {trainer.device} — each "
          f"one of the paper's {trainer.n_cores} hypercube cores; engine "
          f"spec: {trainer.engine.spec}; dataset: {args.dataset}")
    if trainer.store is not None:
        print(f"features: out-of-core via the {trainer.feature_mode} store "
              f"({trainer.store.nbytes / 1e6:.1f} MB backing, "
              f"{args.cache_capacity}-row hot-vertex cache)")
    out = trainer.fit(args.epochs, steps_per_epoch=args.steps_per_epoch)
    if "cache" in out:
        c = out["cache"]
        print(f"store traffic: {out['gather_bytes'] / 1e6:.2f} MB gathered, "
              f"cache hit-rate {c['hit_rate']:.2f} "
              f"({c['hits']} hits / {c['misses']} misses)")
    for ep, (acc, sps, stall) in enumerate(zip(
            out["val_acc"], out["steps_per_s"],
            out["host_stall_s_per_step"]), start=1):
        print(f"epoch {ep}: val_acc {acc:.3f}  {sps:.2f} steps/s  "
              f"host stall/step {stall * 1e3:.1f} ms")
    print(f"done — loss {out['loss_history'][0]:.4f} -> "
          f"{out['loss_history'][-1]:.4f} in {out['wall_s']:.1f}s; "
          "combination stayed core-local, aggregation rode the hypercube "
          f"under the {trainer.engine.spec} engine, weights synced via the "
          "Weight Bank pmean, and the host pipeline prefetched every batch")


if __name__ == "__main__":
    main()
