#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: build the CUDA kernels, hold each one
against its plain PyTorch version, serve ``gcn-reddit`` and train it on the
card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. device — require CUDA; print ``nvidia-smi``'s name and power limit;
2. build — compile every kernel source of both paths with ``nvcc``
   (one process per source, all at once) and print the build time;
3. kernels — run each kernel on the card at the shapes the serving path
   gives it (the buckets of a real layer-1 and layer-2 plan, the two
   combination products) plus ragged edge cases, compare with the plain
   version, and time kernel / plain / one PyTorch library call with CUDA
   events (median of 20 runs);
4. serving — ``gcn-reddit`` at its published widths (602 → 256 → 41) on
   ``make_dataset("reddit", scale=0.05)``, weights from a seed written as a
   reference-layout checkpoint and restored through ``ckpt_dir=``; a mixed
   update/query stream where incremental logits must ``torch.equal`` a cold
   recompute for ``ell+pipelined`` and ``coo+serial`` and the two specs must
   agree within 1e-5; an open-loop Poisson replay on ``ell+pipelined``
   (rehearsal, then the measured pass).  The launch counters are set to 0
   just before every call into an engine and read just after it, so each
   spec's launches are its own: ``ell+pipelined`` must launch both
   kernels, ``coo+serial`` ``gemm`` and no ``spmm_ell``;
5. training kernels — on a real training batch of ``make_dataset("reddit",
   scale=1.0)`` at P = 16 stacked cores, both hops' stacked forward walks
   (``spmm_ell``, each core reading its own rows) and transpose walks
   (``spmm_ell_t``, every core reading the one all-gathered error), each
   at the width the main path gives it (256 for the deepest hop, 41 for
   the last), plus edge cases (K = 1, d = 41, an empty core, pad-only
   rows), all bit-equal to the plain version; the deepest hop's transpose
   walk timed against the plain version, a bound and ``torch.sparse.mm``;
   its stacked forward walk (one launch per bucket for all cores) timed
   against one 2-D launch per core;
6. training — ``Trainer("ell+pipelined", reddit scale=1.0, hidden=256,
   batch_size=1024, fanouts=(10, 25), n_cores=16)`` from a seeded
   checkpoint: 3 warm-up and 20 measured steps (ms per step, steps/s, host
   stall per step, the host batch build split, device forward/backward ms,
   the device's busy share, kernel launches per step);
   the first 5 losses must match the port's CPU run of the same steps
   within 1e-4, ``coo+serial`` must match 3 steps within 1e-4 and launch
   no ELL kernel, and a checkpoint at step 10 plus a resume must replay
   steps 11-20 within 1e-6.

The last three lines are ``nvidia-smi``'s name and power limit, the
``kernels`` JSON record and ``{"ok": true, "device": {...}}``.  A longer
record goes to ``build/chip_smoke.json``.  The script imports nothing of
JAX or of the reference package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
OUT_DIR = os.path.join(HERE, "build")

DATASET, SCALE, HIDDEN = "reddit", 0.05, 256   # serving (DynamicGraph: sets)
TRAIN_SCALE = 1.0                    # training: the published node count
SPMM_TOL = 1e-5                      # same order; FMA-free in both
TRAIN_WALK_TOL = 0.0                 # stacked training walks: bit-equal
GEMM_RTOL, GEMM_ATOL = 1e-4, 1e-5    # vs a plain fp32 sum in K order
REPS = 20                            # CUDA-event timings per median
DURATION_S = 5.0                     # length of the Poisson replay
TRAIN_CORES, TRAIN_BATCH, TRAIN_FANOUTS = 16, 1024, (10, 25)
WARMUP_STEPS, MEASURED_STEPS, CKPT_STEP = 3, 20, 10
LOSS_TOL, RESUME_TOL = 1e-4, 1e-6    # card vs CPU (sum order); resume

KERNELS = {
    "spmm_ell": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/spmm_ell.cu",
                 "replaces": "src/repro/kernels/spmm.py:210"},
    "spmm_ell_t": {"route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/spmm_ell.cu",
                   "replaces": "src/repro/kernels/spmm.py:245"},
    "gemm": {"route": "cuda",
             "source": "src/repro_torch/kernels/csrc/gemm.cu",
             "replaces": "src/repro/kernels/gemm.py:49"},
}
SOURCES = sorted({os.path.basename(m["source"])[:-3]
                  for m in KERNELS.values()})


def card_peaks(name: str):
    """(bytes/s, fp32 flop/s) from NVIDIA's data sheets for the part
    ``nvidia-smi`` names (dense, non-tensor-core fp32)."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    if "H200" in name:
        return 4.8e12, 67e12
    return 3.35e12, 67e12            # H100 SXM


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn):
    """Median ms of ``REPS`` CUDA-event-timed calls (after 3 warm-ups)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def seeded_params(seed: int, dims):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b)))
             .astype(np.float32)} for a, b in zip(dims[:-1], dims[1:])]


def write_checkpoint(ckpt_dir: str, params, extra=None) -> None:
    """A fresh step-0 checkpoint of ``params`` under ``ckpt_dir`` in the
    reference's layout, through the port's ``CheckpointManager``."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    CheckpointManager(ckpt_dir).save(0, params, extra=extra)


def bucket_walk(torch, fn, tables, x, total_rows, prefix=""):
    """Run ``fn(cols, vals, x, out=slice)`` over every non-empty bucket of
    one table set (``prefix`` "t_" for the transpose walk), into one buffer
    — the ELL walk minus the ``inv_perm`` placement.  Stacked tables
    (``[P, nb, K]``) fill a ``[P, rows, d]`` buffer."""
    cols, vals = tables[prefix + "cols"], tables[prefix + "vals"]
    lead = tuple(cols[0].shape[:-2]) if cols else ()
    buf = torch.empty((*lead, total_rows, x.shape[-1]), device=x.device)
    base = 0
    for c, v in zip(cols, vals):
        nb = int(c.shape[-2])
        if nb:
            fn(c, v, x, out=buf[..., base:base + nb, :])
        base += nb
    return buf


def kernel_phase(torch, device, eng, feats, w1, w2, rng):
    """Phase 3: each kernel against its plain version at the served shapes
    (and ragged edge cases); returns (kernels records, detail dict)."""
    from repro_torch.kernels import gemm, spmm_ell
    from repro_torch.kernels.ref import gemm_ref, spmm_ell_ref

    n = eng.graph.n_nodes
    q = np.unique(rng.integers(0, n, 8))
    coo2, f2 = eng.canonical_layer(q)
    coo1, f1 = eng.canonical_layer(f2)
    plan1, plan2 = eng.engine.layout(coo1), eng.engine.layout(coo2)
    detail = {"layer1": {"n_dst": coo1.n_dst, "n_src": coo1.n_src,
                         "nnz": plan1.nnz, "caps": list(plan1.fwd.caps),
                         "rows_per_bucket": [int(c.shape[0])
                                             for c in plan1.fwd.cols]},
              "layer2": {"n_dst": coo2.n_dst, "n_src": coo2.n_src,
                         "nnz": plan2.nnz, "caps": list(plan2.fwd.caps),
                         "rows_per_bucket": [int(c.shape[0])
                                             for c in plan2.fwd.cols]}}

    # -- gemm at the two served combination shapes + ragged M -------------
    x1 = torch.zeros((coo1.n_src, feats.shape[1]), device=device)
    x1[:len(f1)] = torch.from_numpy(feats[f1]).to(device)
    h1 = gemm(x1, w1)                        # [n_src1, 256]
    x2 = torch.from_numpy(rng.standard_normal(
        (coo2.n_src, HIDDEN)).astype(np.float32)).to(device)
    big = torch.from_numpy(rng.standard_normal(
        (16384, feats.shape[1])).astype(np.float32)).to(device)
    gemm_cases = {"layer1": (x1, w1), "layer2": (x2, w2),
                  "m16384_n256": (big, w1),
                  "m16384_n41": (big[:, :HIDDEN].contiguous(), w2),
                  "m8_n256": (big[:8].contiguous(), w1)}
    bias = torch.from_numpy(rng.standard_normal(HIDDEN).astype(
        np.float32)).to(device)
    gerr = {}
    for key, (x, w) in gemm_cases.items():
        for b, relu in ((None, False), (bias if w is w1 else None, True)):
            got = gemm(x, w, b, relu=relu)
            want = gemm_ref(x, w, b, relu=relu)
            lib = torch.matmul(x, w) if b is None else torch.matmul(x, w) + b
            if relu:
                lib = torch.relu(lib)
            torch.testing.assert_close(got, want, rtol=GEMM_RTOL,
                                       atol=GEMM_ATOL)
            torch.testing.assert_close(got, lib, rtol=GEMM_RTOL,
                                       atol=GEMM_ATOL)
            gerr[f"{key}{'_bias' if b is not None else ''}"
                 f"{'_relu' if relu else ''}"] = max_err(got, want)
    # a row's bits must not depend on the row count or position
    full = gemm(big, w1, bias, relu=True)
    for lo, m in ((0, 8), (5, 64), (1000, 1024), (7, 8192)):
        part = gemm(big[lo:lo + m].contiguous(), w1, bias, relu=True)
        if not torch.equal(part, full[lo:lo + m]):
            raise AssertionError(f"gemm rows {lo}:{lo + m} differ from the "
                                 "same rows in a 16384-row call")
    detail["gemm_max_abs_err"] = gerr

    # -- spmm_ell over every bucket of both real plans + edge cases -------
    serr = {}
    for name, plan, x in (("layer1", plan1, h1),
                          ("layer2", plan2, gemm(x2, w2))):
        tables = plan.device_tables(device)
        for b, (c, v) in enumerate(zip(tables["cols"], tables["vals"])):
            if not c.shape[0]:
                continue
            got, want = spmm_ell(c, v, x), spmm_ell_ref(c, v, x)
            serr[f"{name}_K{plan.fwd.caps[b]}_nb{c.shape[0]}"] = \
                max_err(got, want)
    edge = {"d41_K1": (64, 1, 500, 41), "d5_K3": (33, 3, 100, 5),
            "hub_K4096_nb1": (1, 4096, 9000, HIDDEN),
            "hub_K2048_nb2": (2, 2048, 9000, 41),
            "agco_d602_K16": (300, 16, 4000, feats.shape[1]),
            "nb0": (0, 8, 100, HIDDEN)}
    for key, (nb, K, n_src, d) in edge.items():
        cols = rng.integers(0, n_src, (nb, K)).astype(np.int32)
        vals = rng.standard_normal((nb, K)).astype(np.float32)
        if K > 2:                                   # trailing padding
            cols[:, -2:] = n_src
            vals[:, -2:] = 0.0
            if nb:
                cols[0, -1] = n_src + 7                  # stray pad column
        c = torch.from_numpy(cols).to(device)
        v = torch.from_numpy(vals).to(device)
        x = torch.from_numpy(rng.standard_normal((n_src, d)).astype(
            np.float32)).to(device)
        before = spmm_ell.launches
        got, want = spmm_ell(c, v, x), spmm_ell_ref(c, v, x)
        if nb == 0 and spmm_ell.launches != before:
            raise AssertionError("an empty bucket launched the kernel")
        serr[key] = max_err(got, want)
    worst = max(serr.values())
    if worst > SPMM_TOL:
        raise AssertionError(f"spmm_ell max |err| {worst} > {SPMM_TOL}: "
                             f"{serr}")
    detail["spmm_ell_max_abs_err"] = serr

    bw, flops = card_peaks(torch.cuda.get_device_name(0))
    records = {}
    # spmm_ell: the layer-1 forward walk's buckets, the served unit
    tables = plan1.device_tables(device)
    rows = sum(int(c.shape[0]) for c in tables["cols"])
    d = h1.shape[1]
    ker = time_ms(torch, lambda: bucket_walk(torch, spmm_ell, tables, h1,
                                             rows))
    pla = time_ms(torch, lambda: bucket_walk(torch, plain_out, tables,
                                             h1, rows))
    # the same function as one CSR product: row i of the CSR is row i
    # of the concatenated bucket outputs
    one_core = [c[None] for c in plan1.fwd.cols]
    csr = stacked_csr(torch, one_core, [v[None] for v in plan1.fwd.vals],
                      plan1.n_src, device)
    lib_out = torch.sparse.mm(csr, h1)
    walk = bucket_walk(torch, spmm_ell, tables, h1, rows)
    torch.testing.assert_close(lib_out, walk, rtol=1e-4, atol=1e-5)
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, h1))
    sshape = walk_shape(one_core, plan1.n_src, shared_x=True)
    bound, bound_by = walk_bound(sshape, d, bw, flops)
    records["spmm_ell"] = {
        "max_abs_err": worst, "ms": ker, "plain_ms": pla,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib,
        "shape": dict(sshape, d=d, buckets=len(plan1.fwd.cols))}
    # gemm: the layer-1 combination [n_src1, 602] @ [602, 256]
    m, k = x1.shape
    nn = w1.shape[1]
    ker = time_ms(torch, lambda: gemm(x1, w1))
    pla = time_ms(torch, lambda: gemm_ref(x1, w1))
    lib = time_ms(torch, lambda: torch.matmul(x1, w1))
    gbytes = (m * k + k * nn + m * nn) * 4
    gops = 2 * m * nn * k
    records["gemm"] = {
        "max_abs_err": max(gerr.values()), "ms": ker, "plain_ms": pla,
        "bound_ms": max(gbytes / bw, gops / flops) * 1e3,
        "bound_by": "bytes" if gbytes / bw >= gops / flops
        else "operations", "library_ms": lib,
        "shape": {"m": m, "k": k, "n": nn}}
    # the other served shapes, for PERF.md
    extra = {}
    for key in ("layer2", "m16384_n256", "m16384_n41"):
        x, w = gemm_cases[key]
        extra[key] = {"m": x.shape[0], "k": x.shape[1], "n": w.shape[1],
                      "ms": time_ms(torch, lambda: gemm(x, w)),
                      "library_ms": time_ms(
                          torch, lambda: torch.matmul(x, w))}
    detail["gemm_other_shapes"] = extra
    return records, detail


def cold_breakdown(torch, eng, rng, n_queries: int = 5):
    """Where one cold query's time goes (cache bypassed), step by step as
    ``InferenceEngine._compute_rows`` takes them, at the served shapes:
    median ms per step over ``n_queries`` fresh 8-node queries.  Host steps
    are host-clock; device steps end in a synchronize."""
    clock = time.perf_counter
    rows = []
    for _ in range(n_queries):
        q = np.unique(rng.integers(0, eng.graph.n_nodes, 8))
        t = {}
        t0 = clock()
        coo2, f2 = eng.canonical_layer(q)
        coo1, f1 = eng.canonical_layer(f2)
        t["canonical_coo"] = clock() - t0
        t0 = clock()
        eng.engine.layout(coo1)
        eng.engine.layout(coo2)
        t["ell_plan_build"] = clock() - t0
        t0 = clock()
        x = np.zeros((coo1.n_src, eng.feat_dim), np.float32)
        x[:len(f1)] = eng.features[f1]
        t["feature_gather"] = clock() - t0
        t0 = clock()
        xt = torch.from_numpy(x).to(eng.device)
        torch.cuda.synchronize()
        t["h2d_layer1_input"] = clock() - t0
        t0 = clock()
        h1 = eng.engine.layer(coo1, xt, eng.weights[0], device=eng.device)
        torch.cuda.synchronize()
        t["layer1_on_device"] = clock() - t0
        t0 = clock()
        h = h1[:len(f2)].cpu().numpy()
        t["d2h_layer1_output"] = clock() - t0
        t0 = clock()
        x2 = np.zeros((coo2.n_src, h.shape[1]), np.float32)
        x2[:len(f2)] = h
        y = eng.engine.layer(coo2, torch.from_numpy(x2).to(eng.device),
                             eng.weights[1], activate=False,
                             device=eng.device)
        y[:len(q)].cpu().numpy()
        t["layer2_round_trip"] = clock() - t0
        rows.append(t)
    return {k: float(np.median([r[k] for r in rows]) * 1e3) for k in rows[0]}


def counted(counts, fn, *args, **kwargs):
    """Call ``fn`` with every launch counter set to 0 just before it and add
    what it launched, read just after, to ``counts``."""
    from repro_torch.kernels import gemm, spmm_ell, spmm_ell_t

    kernels = {"spmm_ell": spmm_ell, "spmm_ell_t": spmm_ell_t, "gemm": gemm}
    for k in kernels.values():
        k.launches = 0
    out = fn(*args, **kwargs)
    for name, k in kernels.items():
        counts[name] = counts.get(name, 0) + k.launches
    return out


def serving_phase(torch, eng_ell, eng_coo, rng):
    """Phase 4: the bit-match stream on both specs, then the replay on
    ``ell+pipelined``.  Every call into an engine is counted on its own
    (:func:`counted`), so each spec's launches are its own."""
    from repro_torch.serving import InferenceService, poisson_trace

    engines = (eng_ell, eng_coo)
    zero = {"spmm_ell": 0, "spmm_ell_t": 0, "gemm": 0}
    launches = {"ell+pipelined": {"stream": dict(zero),
                                  "rehearsal": dict(zero),
                                  "replay": dict(zero)},
                "coo+serial": {"stream": dict(zero)}}
    batches = {"ell+pipelined": {"stream": 0}, "coo+serial": {"stream": 0}}

    def query(eng, nodes, **kw):
        batches[eng.spec]["stream"] += 1
        return counted(launches[eng.spec]["stream"], eng.query, nodes, **kw)

    def update(eng, method, *args, **kw):
        counted(launches[eng.spec]["stream"], getattr(eng, method), *args,
                **kw)

    n = eng_ell.graph.n_nodes
    feat_dim = eng_ell.feat_dim
    warm = rng.integers(0, n, 16)
    for eng in engines:
        query(eng, warm)
    worst_cross = 0.0
    for rnd in range(9):
        op = rnd % 3
        if op == 0:
            add = [(int(rng.integers(n)), int(rng.integers(n)))
                   for _ in range(3)]
            for eng in engines:
                update(eng, "update_edges", add=add)
        elif op == 1:
            v = int(rng.integers(n))
            nbrs = eng_ell.graph.in_neighbors(v)
            if len(nbrs):
                for eng in engines:
                    update(eng, "update_edges", remove=[(int(nbrs[0]), v)])
        else:
            nodes = rng.integers(0, n, 2)
            rows = (rng.standard_normal((2, feat_dim)) * 0.1).astype(
                np.float32)
            for eng in engines:
                update(eng, "update_features", nodes, rows)
        q = rng.integers(0, n, 8)
        out = {}
        for eng in engines:
            inc = torch.from_numpy(query(eng, q, use_cache=True))
            cold = torch.from_numpy(query(eng, q, use_cache=False))
            if not torch.equal(inc, cold):
                raise AssertionError(f"{eng.spec}: incremental != cold in "
                                     f"round {rnd}")
            if not torch.isfinite(inc).all() or inc.shape != (8, 41):
                raise AssertionError(f"{eng.spec}: bad logits {inc.shape}")
            out[eng.spec] = inc
        cross = max_err(out["ell+pipelined"], out["coo+serial"])
        if cross > 1e-5:
            raise AssertionError(f"ell vs coo logits differ by {cross}")
        worst_cross = max(worst_cross, cross)
    for eng in engines:
        if not (eng.rows_from_cache > 0 and eng.cache.invalidations > 0):
            raise AssertionError(f"{eng.spec}: the stream reused nothing")

    trace = poisson_trace(rate=200.0, duration=DURATION_S, n_nodes=n,
                          zipf_a=1.3, seed=1)
    ell = launches["ell+pipelined"]
    rehearsal = InferenceService(eng_ell, max_batch=8, max_wait=0.002)
    counted(ell["rehearsal"], rehearsal.replay, trace, slo=0.05)
    hits0, miss0 = eng_ell.cache.hits, eng_ell.cache.misses
    svc = InferenceService(eng_ell, max_batch=8, max_wait=0.002)
    rep = counted(ell["replay"], svc.replay, trace, slo=0.05)
    if rep["completed"] != len(trace):
        raise AssertionError(f"replay answered {rep['completed']} of "
                             f"{len(trace)}")
    batches["ell+pipelined"]["rehearsal"] = rehearsal.queue.batches
    batches["ell+pipelined"]["replay"] = svc.queue.batches
    hits = eng_ell.cache.hits - hits0
    misses = eng_ell.cache.misses - miss0
    rep["cache_hit_rate"] = hits / max(hits + misses, 1)
    rep["requests"] = len(trace)
    rep["ell_vs_coo_max_abs_err"] = worst_cross
    return rep, launches, batches


def check_launches(launches):
    """Each serving spec must have run its own kernels: ``ell+pipelined``
    both, ``coo+serial`` the ``gemm`` combination and no ELL walk; serving
    has no backward, so no transpose walk."""
    for spec, phases in launches.items():
        for phase, got in phases.items():
            if got["gemm"] <= 0 or got["spmm_ell_t"] != 0 or (
                    (got["spmm_ell"] > 0) != spec.startswith("ell")):
                raise AssertionError(f"{spec} {phase}: unexpected kernel "
                                     f"launches {got}")


def plain_out(c, v, x, out):
    """The plain version as a drop-in for a kernel wrapper in a walk."""
    from repro_torch.kernels.ref import spmm_ell_ref

    out.copy_(spmm_ell_ref(c, v, x))


def walk_shape(np_cols, n_cols, shared_x):
    """What one stacked walk (``np_cols``: its buckets, ``[P, nb, K]``
    each) must touch, for its bound: real entries (column < ``n_cols``),
    distinct gathered rows (over one shared ``x``, or per core) and output
    rows holding at least one real entry (the rows the ``inv`` table
    places).  The padded entry and row counts are kept beside them, to
    show the padding overhead; the bound does not charge them."""
    P = np_cols[0].shape[0]
    real = [c[c < n_cols] for c in np_cols]
    if shared_x:
        distinct = len(np.unique(np.concatenate(real)))
    else:
        distinct = sum(len(np.unique(np.concatenate(
            [c[p][c[p] < n_cols] for c in np_cols]))) for p in range(P))
    return {"real_entries": int(sum(r.size for r in real)),
            "distinct_rows": int(distinct),
            "rows_with_entries": int(sum(int((c < n_cols).any(-1).sum())
                                         for c in np_cols)),
            "padded_entries": int(sum(c.size for c in np_cols)),
            "padded_rows": int(P * sum(c.shape[1] for c in np_cols))}


def walk_bound(shape, d, bw, flops):
    """(bound ms, bound_by) of a walk: bytes = real entries × 8 (column
    and value) + distinct gathered rows × d × 4 + output rows with an
    entry × d × 4 over the memory rate; flops = 2 × real entries × d over
    the fp32 rate."""
    nbytes = shape["real_entries"] * 8 + shape["distinct_rows"] * d * 4 \
        + shape["rows_with_entries"] * d * 4
    ops = 2 * shape["real_entries"] * d
    return (max(nbytes / bw, ops / flops) * 1e3,
            "bytes" if nbytes / bw >= ops / flops else "operations")


def stacked_csr(torch, np_cols, np_vals, n_cols, device):
    """One CSR ``[P·rows, n_cols]`` holding every core's bucket rows, in the
    walk's buffer order (core-major, buckets concatenated) — the library
    yardstick for a walk whose cores share one ``x`` (a 2-D walk is one
    core: ``[1, nb, K]`` buckets)."""
    P = np_cols[0].shape[0]
    rows = sum(c.shape[1] for c in np_cols)
    crow, ccol, cval = [], [], []
    for p in range(P):
        base = p * rows
        for c, v in zip(np_cols, np_vals):
            nb, K = c.shape[1:]
            crow.append(base + np.repeat(np.arange(nb), K))
            ccol.append(c[p].reshape(-1))
            cval.append(v[p].reshape(-1))
            base += nb
    crow, ccol, cval = (np.concatenate(a) for a in (crow, ccol, cval))
    real = ccol < n_cols
    indptr = np.zeros(P * rows + 1, np.int64)
    np.cumsum(np.bincount(crow[real], minlength=P * rows), out=indptr[1:])
    order = np.argsort(crow[real], kind="stable")
    return torch.sparse_csr_tensor(  # yardstick only, never run by the port
        torch.from_numpy(indptr),
        torch.from_numpy(ccol[real][order].astype(np.int64)),
        torch.from_numpy(cval[real][order]), size=(P * rows, n_cols),
        device=device)


def train_kernel_phase(torch, device, ds, rng):
    """Phase 5: ``spmm_ell_t`` on every transpose bucket of a real layer-1
    training plan at P = 16 (and on edge cases) against its plain version,
    its walk timed; the stacked forward walk timed against one 2-D launch
    per core.  Returns (spmm_ell_t record, detail)."""
    from repro_torch.data import GraphBatchPipeline
    from repro_torch.engine import Engine
    from repro_torch.graph import NeighborSampler
    from repro_torch.kernels import spmm_ell, spmm_ell_t
    from repro_torch.kernels.ref import spmm_ell_ref

    P = TRAIN_CORES
    sampler = NeighborSampler(ds.graph, TRAIN_FANOUTS, pad_multiple=P,
                              seed=0)
    mb, feats, labels = next(GraphBatchPipeline(ds, sampler, TRAIN_BATCH))
    bundle = Engine("ell+pipelined").build(n_cores=P, device=device)
    host = bundle.prepare_batch(mb, feats, labels)
    batch = bundle.commit_batch(host)
    n_dst1, n_src1 = batch["dims"][1]
    tables, htables = batch["edges"][1], host["edges"][1]
    detail = {"layer1": {
        "n_dst": n_dst1, "n_src": n_src1, "cores": P,
        "fwd_buckets": [list(c.shape) for c in htables["cols"]],
        "t_buckets": [list(c.shape) for c in htables["t_cols"]]}}

    # -- bit-equality at the main path's shapes: both hops' forward and
    # transpose walks (one launch per bucket, into slices of one buffer,
    # as ell_apply launches them), each at the width it runs at there —
    # the deepest hop (layer 1) aggregates h @ w0 (HIDDEN wide), layer 0
    # the logits (n_classes wide) — plus edge cases ----------------------
    widths = (ds.stats.n_classes, HIDDEN)
    err, ferr = {}, {}

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    for layer, (tab, (n_dst, n_src)) in enumerate(zip(batch["edges"],
                                                      batch["dims"])):
        d = widths[layer]
        # the backward's error: one all-gathered [n_dst, d], shared by
        # every core through a zero core stride
        e = rand(n_dst, d).unsqueeze(0).expand(P, n_dst, d)
        rows = sum(int(c.shape[-2]) for c in tab["t_cols"])
        err[f"layer{layer}_d{d}_walk"] = max_err(
            bucket_walk(torch, spmm_ell_t, tab, e, rows, "t_"),
            bucket_walk(torch, plain_out, tab, e, rows, "t_"))
        for c, v in zip(tab["t_cols"], tab["t_vals"]):
            err[f"layer{layer}_d{d}_K{c.shape[-1]}_nb{c.shape[-2]}"] = \
                max_err(spmm_ell_t(c, v, e), spmm_ell_ref(c, v, e))
        # the forward's input: each core's own rows, a nonzero core stride
        x = rand(P, n_src // P, d)
        rows = sum(int(c.shape[-2]) for c in tab["cols"])
        ferr[f"layer{layer}_d{d}_walk"] = max_err(
            bucket_walk(torch, spmm_ell, tab, x, rows),
            bucket_walk(torch, plain_out, tab, x, rows))
    fworst = max(ferr.values())
    if fworst > TRAIN_WALK_TOL:
        raise AssertionError(f"stacked spmm_ell max |err| {fworst} > "
                             f"{TRAIN_WALK_TOL}: {ferr}")
    detail["spmm_ell_training_max_abs_err"] = ferr
    edge = {"K1_d41": (4, 9, 1, 50, 41), "d41_K8": (P, 33, 8, 700, 41),
            "d256_K64_empty_core": (P, 17, 64, 6592, HIDDEN),
            "P2_d5_K3": (2, 5, 3, 20, 5)}
    for key, (cores, nb, K, n_src, d) in edge.items():
        cols = rng.integers(0, n_src, (cores, nb, K)).astype(np.int32)
        vals = rng.standard_normal((cores, nb, K)).astype(np.float32)
        cols[:, -1], vals[:, -1] = n_src, 0.0             # pad-only row
        if K > 2:
            cols[:, :, -1], vals[:, :, -1] = n_src, 0.0   # trailing pads
        if cores > 3:
            cols[3], vals[3] = n_src, 0.0                 # an empty core
        c = torch.from_numpy(cols).to(device)
        v = torch.from_numpy(vals).to(device)
        x = torch.from_numpy(rng.standard_normal((n_src, d)).astype(
            np.float32)).to(device).unsqueeze(0).expand(cores, n_src, d)
        got, want = spmm_ell_t(c, v, x), spmm_ell_ref(c, v, x)
        if cores > 3 and got[3].any():
            raise AssertionError("an empty core's rows are not zero")
        err[key] = max_err(got, want)
    worst = max(err.values())
    if worst > TRAIN_WALK_TOL:
        raise AssertionError(f"spmm_ell_t max |err| {worst} > "
                             f"{TRAIN_WALK_TOL}: {err}")
    detail["spmm_ell_t_max_abs_err"] = err

    # -- timing: the layer-1 transpose walk, shared error rows -------------
    bw, flops = card_peaks(torch.cuda.get_device_name(0))
    d = HIDDEN
    e = torch.from_numpy(rng.standard_normal((n_dst1, d)).astype(
        np.float32)).to(device)
    e_all = e.unsqueeze(0).expand(P, n_dst1, d)      # the all-gathered view
    t_rows = sum(int(c.shape[-2]) for c in tables["t_cols"])
    ker = time_ms(torch, lambda: bucket_walk(torch, spmm_ell_t, tables,
                                             e_all, t_rows, "t_"))
    pla = time_ms(torch, lambda: bucket_walk(torch, plain_out, tables,
                                             e_all, t_rows, "t_"))
    csr = stacked_csr(torch, htables["t_cols"], htables["t_vals"], n_dst1,
                      device)
    walk = bucket_walk(torch, spmm_ell_t, tables, e_all, t_rows, "t_")
    torch.testing.assert_close(torch.sparse.mm(csr, e),
                               walk.reshape(-1, d), rtol=1e-4, atol=1e-5)
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, e))
    detail["spmm_ell_t_layer1_bucket_ms"] = {   # where the walk's time goes
        f"K{c.shape[-1]}_nb{c.shape[-2]}": time_ms(
            torch, lambda c=c, v=v: spmm_ell_t(c, v, e_all))
        for c, v in zip(tables["t_cols"], tables["t_vals"])}
    shape = walk_shape(htables["t_cols"], n_dst1, shared_x=True)
    bound, bound_by = walk_bound(shape, d, bw, flops)
    record = {"max_abs_err": worst, "ms": ker, "plain_ms": pla,
              "bound_ms": bound, "bound_by": bound_by, "library_ms": lib,
              "shape": dict(shape, d=d, buckets=len(tables["t_cols"]))}

    # -- the stacked forward walk vs one 2-D launch per core ---------------
    x = torch.from_numpy(rng.standard_normal((P, n_src1 // P, d)).astype(
        np.float32)).to(device)
    f_rows = sum(int(c.shape[-2]) for c in tables["cols"])

    def per_core(c, v, xs, out):
        for p in range(P):
            spmm_ell(c[p], v[p], xs[p], out=out[p])

    stacked = bucket_walk(torch, spmm_ell, tables, x, f_rows)
    looped = bucket_walk(torch, per_core, tables, x, f_rows)
    if not torch.equal(stacked, looped):
        raise AssertionError("stacked forward walk != per-core 2-D walk")
    fshape = walk_shape(htables["cols"], n_src1 // P, shared_x=False)
    bound, bound_by = walk_bound(fshape, d, bw, flops)
    detail["spmm_ell_training_layer1_walk"] = {
        "stacked_ms": time_ms(torch, lambda: bucket_walk(
            torch, spmm_ell, tables, x, f_rows)),
        "per_core_2d_ms": time_ms(torch, lambda: bucket_walk(
            torch, per_core, tables, x, f_rows)),
        "bound_ms": bound, "bound_by": bound_by,
        "launches_stacked": len(tables["cols"]),
        "launches_per_core": len(tables["cols"]) * P,
        "shape": dict(fshape, d=d)}
    return record, detail


def train_phase(torch, ds, device):
    """Phase 6: train gcn-reddit on the card through the Trainer, from a
    seeded checkpoint, and hold it against the port's CPU run, the
    ``coo+serial`` oracle and a checkpoint + resume.  Every call into a
    trainer is counted on its own (:func:`counted`)."""
    from repro_torch.launch.trainer import Trainer

    dims = (ds.stats.feat_dim, HIDDEN, ds.stats.n_classes)
    params = seeded_params(1, dims)
    extra = {"step": 0, "epochs_done": 0,
             "pipeline": {"seed": 0, "epoch": 0, "batch_idx": 0}}
    dirs = {k: os.path.join(OUT_DIR, f"chip_smoke_train_{k}")
            for k in ("card", "cpu", "coo")}
    for path in dirs.values():
        write_checkpoint(path, params, extra=extra)

    def trainer(spec, key, **kw):
        tr = Trainer(spec, ds, n_cores=TRAIN_CORES, hidden=HIDDEN,
                     batch_size=TRAIN_BATCH, fanouts=TRAIN_FANOUTS, seed=0,
                     ckpt_dir=dirs[key], ckpt_every=0, **kw)
        if not tr.resume():
            raise AssertionError(f"no checkpoint under {dirs[key]}")
        return tr

    zero = {"spmm_ell": 0, "spmm_ell_t": 0, "gemm": 0}
    launches = {"ell+pipelined": dict(zero), "coo+serial": dict(zero)}
    tr = trainer("ell+pipelined", "card", input_pipeline="prefetch",
                 device=device)
    if tr.global_step != 0 or not all(
            np.array_equal(p["w"].cpu().numpy(), q["w"])
            for p, q in zip(tr.params, params)):
        raise AssertionError("the seeded checkpoint did not round-trip")
    losses, step_ms, per_step = [], [], []
    for i in range(WARMUP_STEPS + MEASURED_STEPS):
        if i == WARMUP_STEPS:
            tr.reset_stall_stats()
        if tr.global_step == CKPT_STEP:
            tr.save(sync=True)
        counts = dict(zero)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += counted(counts, tr.train_steps, 1)  # float(loss) syncs
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if counts["spmm_ell"] <= 0 or counts["spmm_ell_t"] <= 0:
            raise AssertionError(f"step {i + 1} skipped an ELL kernel: "
                                 f"{counts}")
        per_step.append(counts)
        for k in zero:
            launches["ell+pipelined"][k] += counts[k]
    stall_ms = tr.stall_per_step * 1e3
    measured = step_ms[WARMUP_STEPS:]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")

    # the host half of a step, with the producer thread stopped so nothing
    # contends for the interpreter: sampling, the stacked table build,
    # placement on the card (median of 3 batches)
    tr.fetcher.close()
    host = {"sample_ms": [], "tables_ms": [], "place_ms": []}
    for _ in range(3):
        t0 = time.perf_counter()
        item = next(tr.pipeline)
        t1 = time.perf_counter()
        host_batch = tr.bundle.prepare_batch(*item)
        t2 = time.perf_counter()
        batch = tr.bundle.commit_batch(host_batch)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(host, (t1 - t0, t2 - t1, t3 - t2)):
            host[key].append(dt * 1e3)
    host = {k: float(np.median(v)) for k, v in host.items()}
    # device time of one step, split at the loss (CUDA events, median of 5)
    fwd, bwd = [], []
    for _ in range(5):
        ws = [p["w"].detach().requires_grad_(True) for p in tr.params]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = tr.bundle.loss([{"w": w} for w in ws], batch)
        ev[1].record()
        torch.autograd.grad(loss, ws)
        ev[2].record()
        ev[2].synchronize()
        fwd.append(ev[0].elapsed_time(ev[1]))
        bwd.append(ev[1].elapsed_time(ev[2]))
    busy = device_busy(torch, tr, 3)
    tr.close()

    # checkpoint at step 10 + resume: steps 11-20 again
    resumed = trainer("ell+pipelined", "card", input_pipeline="prefetch",
                      device=device)
    if resumed.global_step != CKPT_STEP:
        raise AssertionError(f"resumed at step {resumed.global_step}")
    again = counted(launches["ell+pipelined"], resumed.train_steps, 10)
    resumed.close()
    drift = float(np.abs(np.asarray(again)
                         - np.asarray(losses[CKPT_STEP:CKPT_STEP + 10])).max())
    if drift > RESUME_TOL:
        raise AssertionError(f"resume drift {drift} > {RESUME_TOL}")

    # the same 5 steps on the CPU with the plain kernel versions
    cpu = trainer("ell+pipelined", "cpu", input_pipeline="sync",
                  device="cpu")
    cpu_losses = cpu.train_steps(5)
    cpu.close()
    cpu_diff = float(np.abs(np.asarray(cpu_losses)
                            - np.asarray(losses[:5])).max())
    if cpu_diff > LOSS_TOL:
        raise AssertionError(f"card vs CPU losses differ by {cpu_diff}")

    # the coo+serial oracle on the card: 3 steps, no ELL kernel
    coo = trainer("coo+serial", "coo", input_pipeline="prefetch",
                  device=device)
    coo_losses = counted(launches["coo+serial"], coo.train_steps, 3)
    coo.close()
    coo_diff = float(np.abs(np.asarray(coo_losses)
                            - np.asarray(losses[:3])).max())
    if coo_diff > LOSS_TOL:
        raise AssertionError(f"coo+serial vs ell losses differ by "
                             f"{coo_diff}")
    got = launches["coo+serial"]
    if got["spmm_ell"] or got["spmm_ell_t"]:
        raise AssertionError(f"coo+serial launched ELL kernels: {got}")

    n_steps = WARMUP_STEPS + MEASURED_STEPS
    return {
        "losses": losses, "resumed_losses_11_20": again,
        "cpu_losses": cpu_losses, "coo_losses": coo_losses,
        "resume_drift": drift, "card_vs_cpu_max_abs": cpu_diff,
        "coo_vs_ell_max_abs": coo_diff,
        "ms_per_step_median": float(np.median(measured)),
        "steps_per_s": len(measured) / (sum(measured) / 1e3),
        "host_stall_ms_per_step": stall_ms,
        "host_batch_ms": host,
        "device_fwd_ms": float(np.median(fwd)),
        "device_bwd_ms": float(np.median(bwd)),
        "device_busy_share": busy,
        "step_ms": step_ms,
        "launches": launches,
        "launches_per_step": {"ell+pipelined": {
            k: sum(c[k] for c in per_step) / n_steps for k in zero}},
        "launches_each_step": per_step,
    }


def device_busy(torch, tr, n_steps):
    """Share of ``n_steps`` training steps' wall time the card spent in
    kernels: the device time of ``torch.profiler``'s CUDA kernel events
    (the ops that launched them are not counted again) over the host
    clock; ``None`` when the profiler reports no kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_steps(n_steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernel_us = sum(float(evt.self_device_time_total)
                    for evt in prof.key_averages()
                    if evt.device_type == DeviceType.CUDA)
    return kernel_us / wall_us if kernel_us > 0 else None


def run():
    """Phases 3–6 on the card; returns (kernels line, record)."""
    import torch

    from repro_torch.graph import make_dataset
    from repro_torch.serving import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    ds = make_dataset(DATASET, scale=SCALE, seed=0)
    dims = (ds.stats.feat_dim, HIDDEN, ds.stats.n_classes)
    params = seeded_params(0, dims)
    ckpt = os.path.join(OUT_DIR, "chip_smoke_ckpt")
    write_checkpoint(ckpt, params)
    eng_ell = InferenceEngine("ell+pipelined", ds.graph, ds.features,
                              ckpt_dir=ckpt, device="cuda")
    eng_coo = InferenceEngine("coo+serial", ds.graph, ds.features,
                              ckpt_dir=ckpt, device="cuda")
    device = eng_ell.device
    for got, want in zip(eng_ell.weights, params):
        if not np.array_equal(got.cpu().numpy(), want["w"]):
            raise AssertionError("checkpoint weights did not round-trip")
    setup_s = time.perf_counter() - t0
    print(f"data: {DATASET} scale={SCALE} nodes={ds.graph.n_nodes} "
          f"directed_edges={ds.graph.n_edges} dims={dims} "
          f"setup_s={setup_s:.1f}", flush=True)

    t0 = time.perf_counter()
    records, detail = kernel_phase(torch, device, eng_ell, ds.features,
                                   eng_ell.weights[0], eng_ell.weights[1],
                                   rng)
    print(f"kernels checked in {time.perf_counter() - t0:.1f}s: "
          f"spmm_ell worst |err| "
          f"{max(detail['spmm_ell_max_abs_err'].values()):.3g}, gemm worst "
          f"|err| {max(detail['gemm_max_abs_err'].values()):.3g}", flush=True)

    t0 = time.perf_counter()
    rep, launches, batches = serving_phase(torch, eng_ell, eng_coo, rng)
    rep["phase_s"] = time.perf_counter() - t0
    check_launches(launches)
    totals = {spec: {k: sum(p[k] for p in phases.values())
                     for k in KERNELS}
              for spec, phases in launches.items()}
    per_batch = {f"{spec} {phase}": {k: n / batches[spec][phase]
                                     for k, n in got.items()}
                 for spec, phases in launches.items()
                 for phase, got in phases.items()}
    print(f"serving: p50_ms={rep['p50_ms']:.3f} p99_ms={rep['p99_ms']:.3f} "
          f"throughput_at_slo={rep['throughput_at_slo']:.2f}/s "
          f"(slo {rep['slo_ms']:.0f} ms, {rep['requests']} requests) "
          f"coalesce_factor={rep['coalesce_factor']:.3f} "
          f"cache_hit_rate={rep['cache_hit_rate']:.3f} "
          f"ell_vs_coo={rep['ell_vs_coo_max_abs_err']:.3g}", flush=True)
    for key, got in per_batch.items():
        spec, phase = key.split(" ")
        print(f"launches {key}: {launches[spec][phase]} over "
              f"{batches[spec][phase]} micro-batches, per micro-batch "
              + " ".join(f"{k}={v:.3f}" for k, v in got.items()), flush=True)
    breakdown = cold_breakdown(torch, eng_ell, rng)
    print("cold query breakdown (ms, median of 5): "
          + " ".join(f"{k}={v:.3f}" for k, v in breakdown.items()),
          flush=True)

    t0 = time.perf_counter()
    tds = make_dataset(DATASET, scale=TRAIN_SCALE, seed=0)
    print(f"training data: {DATASET} scale={TRAIN_SCALE} "
          f"nodes={tds.graph.n_nodes} directed_edges={tds.graph.n_edges} "
          f"setup_s={time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    records["spmm_ell_t"], tdetail = train_kernel_phase(torch, device, tds,
                                                        rng)
    detail.update(tdetail)
    records["spmm_ell"]["max_abs_err"] = max(
        records["spmm_ell"]["max_abs_err"],
        *tdetail["spmm_ell_training_max_abs_err"].values())
    walk = detail["spmm_ell_training_layer1_walk"]
    print(f"training kernels checked in {time.perf_counter() - t0:.1f}s: "
          f"spmm_ell_t worst |err| {records['spmm_ell_t']['max_abs_err']:.3g}"
          f", layer-1 t walk {records['spmm_ell_t']['ms']:.4f} ms (bound "
          f"{records['spmm_ell_t']['bound_ms']:.5f}, library "
          f"{records['spmm_ell_t']['library_ms']:.4f}); layer-1 forward "
          f"walk stacked {walk['stacked_ms']:.4f} ms "
          f"({walk['launches_stacked']} launches) vs per-core 2-D "
          f"{walk['per_core_2d_ms']:.4f} ms "
          f"({walk['launches_per_core']} launches)", flush=True)

    t0 = time.perf_counter()
    train = train_phase(torch, tds, device)
    train["phase_s"] = time.perf_counter() - t0
    print(f"training: gcn-reddit {dims} P={TRAIN_CORES} "
          f"batch={TRAIN_BATCH} fanouts={TRAIN_FANOUTS}: "
          f"ms_per_step={train['ms_per_step_median']:.3f} "
          f"steps_per_s={train['steps_per_s']:.3f} "
          f"host_stall_ms_per_step={train['host_stall_ms_per_step']:.3f} "
          f"host_batch_ms={json.dumps(train['host_batch_ms'])} "
          f"device_fwd_ms={train['device_fwd_ms']:.3f} "
          f"device_bwd_ms={train['device_bwd_ms']:.3f} "
          f"device_busy_share={train['device_busy_share']} "
          f"resume_drift={train['resume_drift']:.3g} "
          f"card_vs_cpu={train['card_vs_cpu_max_abs']:.3g} "
          f"coo_vs_ell={train['coo_vs_ell_max_abs']:.3g} "
          f"({train['phase_s']:.1f}s)", flush=True)
    print("training losses: " + json.dumps(train["losses"]), flush=True)
    print("training launches per step: "
          + json.dumps(train["launches_per_step"]) + " totals: "
          + json.dumps(train["launches"]), flush=True)
    by_path = {f"serving {spec}": t for spec, t in totals.items()}
    by_path.update({f"training {spec}": t
                    for spec, t in train["launches"].items()})
    kernels = []
    for name, meta in KERNELS.items():
        rec = dict(name=name, **meta,
                   launches=sum(t[name] for t in by_path.values()))
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            rec[key] = records[name][key]
        rec["launches_by_path"] = {k: t[name] for k, t in by_path.items()}
        rec["launches_per_batch"] = {k: v[name] for k, v in per_batch.items()}
        rec["launches_per_training_step"] = \
            train["launches_per_step"]["ell+pipelined"][name]
        kernels.append(rec)
    record = {"kernels": records, "detail": detail, "serving": rep,
              "launches": launches, "micro_batches": batches,
              "launches_per_batch": per_batch,
              "cold_query_breakdown_ms": breakdown, "training": train}
    return {"kernels": kernels}, record


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} (torch {torch.__version__}, "
          f"cuda {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    print(f"build: {len(SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    kernels_line, record = run()
    record["nvidia_smi"] = smi
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=float)
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
