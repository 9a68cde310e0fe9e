"""The paper's core on the PyTorch port: route message waves over the 4-D
hypercube with Algorithm 1 and compare against the static
dimension-ordered schedule.  Host-only (numpy): no device is used.

    PYTHONPATH=src python examples/torch_routing_playground.py
"""
import argparse

import numpy as np

from repro_torch.core.blockmsg import build_waves, wave_statistics
from repro_torch.core.routing import (make_fuse_wave, route_messages,
                                      validate_routing)
from repro_torch.core.schedule import compare_schedules
from repro_torch.graph.coo import from_edges
from repro_torch.graph.partition import block_partition


def main() -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    rng = np.random.default_rng(0)

    # --- a Fuse4 wave: 64 messages, 4 per source core -----------------
    src, dst = make_fuse_wave(4, rng)
    res = route_messages(src, dst, seed=1)
    validate_routing(res, src, dst)
    print(f"Fuse4 wave: {len(src)} messages in {res.cycles} cycles "
          f"(lower bound 4)")
    print("cycle-by-cycle positions of message 0:",
          list(res.positions[:, 0]))
    print(compare_schedules(src, dst, seed=1))

    # --- Block Messages from a random subgraph -------------------------
    n = 1024
    e = 8000
    coo = from_edges(rng.integers(0, n, e), rng.integers(0, n, e),
                     rng.standard_normal(e).astype(np.float32), n, n)
    waves = build_waves(block_partition(coo, 16))
    stats = wave_statistics(waves)
    print(f"\n{int(stats['raw_edges'])} edges compressed into "
          f"{int(stats['wire_messages'])} block messages "
          f"({stats['compression']:.2f}x, the paper's Reduced-Register-File "
          f"merge) across {int(stats['waves'])} waves")


if __name__ == "__main__":
    main()
