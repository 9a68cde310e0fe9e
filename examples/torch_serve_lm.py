"""Serve a smoke-scale LM with continuous batching on the PyTorch port
(llama3.2-1b by default, as ``examples/serve_lm.py``; any decoder-only
architecture with ``--arch``).  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch ARCH] \\
        [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.launch.lm_serve import Request, Server


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    srv = Server(args.arch, slots=4, max_seq=96, device=args.device)
    for i in range(8):
        prompt = rng.integers(0, srv.cfg.vocab,
                              rng.integers(4, 10)).astype(np.int32)
        srv.submit(Request(rid=i, prompt=prompt, max_new=12))
    stats = srv.run()
    print(f"served {len(srv.completed)} requests / {stats['tokens']} tokens "
          f"in {stats['steps']} steps ({stats['tok_per_s']:.1f} tok/s) on "
          f"{srv.device}")
    for r in srv.completed[:3]:
        print(f"  req {r.rid}: prompt {[int(t) for t in r.prompt]} -> "
              f"{r.generated}")


if __name__ == "__main__":
    main()
