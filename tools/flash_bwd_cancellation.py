"""f32 ``flash_mha_bwd`` where dK is rounding alone, on the card.

At sk = 1 every live row's one key has p = 1, so o = v and
dS = dP - δ is 0 in exact arithmetic: dK is what rounding leaves of it,
in the kernel and in the plain version alike.  For each head dim, mask
and query length of the tile-edge card test (``tests/test_torch_gpu.py``,
same seeds), this prints one JSON line: the kernel's largest distance
from the plain f32 version's dK with that test's limit, and the kernel's
and the plain version's L2 distances from a float64 backward with their
ratio.  Then the worst ratio a head dim.  Needs one NVIDIA GPU:

    PYTHONPATH=src python tools/flash_bwd_cancellation.py
"""
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import flash_mha, flash_mha_bwd, mha_bwd_ref, mha_ref

LENS = (1, 63, 64, 65, 127, 129, 191)     # the test's BWD_LENS
F32_TOL = 1e-5


def qkv(seed, bh, sq, sk, hd, dev):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((bh, sk, hd)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(a).to(dev) for a in (q, k, v)]


def dk_row(hd, mask, sq, dev):
    opts = dict(causal=mask != "full", window=40 if mask == "window" else None)
    q, k, v = qkv(sq * 1000 + 1 + hd, 2, sq, 1, hd, dev)
    do = qkv(sq + hd, 2, sq, sq, hd, dev)[0]
    o, lse = flash_mha(q, k, v, q_block=1, k_block=1, return_lse=True,
                       **opts)
    dk = flash_mha_bwd(q, k, v, o, lse, do, **opts)[1]
    want = mha_bwd_ref(q, k, v, o, lse, do, **opts)[1]
    wide = [t.double() for t in (q, k, v, do)]
    o64, lse64 = mha_ref(*wide[:3], return_lse=True, **opts)
    exact = mha_bwd_ref(*wide[:3], o64, lse64, wide[3], **opts)[1]
    po, plse = mha_ref(q, k, v, return_lse=True, **opts)
    plain = mha_bwd_ref(q, k, v, po, plse, do, **opts)[1]
    kernel_l2 = float((dk.double() - exact).norm())
    plain_l2 = float((plain.double() - exact).norm())
    return {"hd": hd, "mask": mask, "sq": sq, "sk": 1,
            "vs_plain_max": float((dk - want).abs().max()),
            "test_limit": max(F32_TOL, 2.0 ** -20 * float(want.abs().max())),
            "kernel_f64_l2": kernel_l2, "plain_f32_f64_l2": plain_l2,
            "ratio": kernel_l2 / plain_l2 if plain_l2 else float("inf")}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    rows = [dk_row(hd, mask, sq, dev) for hd in (16, 32, 64, 80, 128)
            for mask in ("causal", "full", "window") for sq in LENS]
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({
        "worst_ratio": {hd: max(r["ratio"] for r in rows if r["hd"] == hd)
                        for hd in (16, 32, 64, 80, 128)},
        "over_test_limit": [(r["hd"], r["mask"], r["sq"]) for r in rows
                            if r["vs_plain_max"] > r["test_limit"]]}))


if __name__ == "__main__":
    main()
