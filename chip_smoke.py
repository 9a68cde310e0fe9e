#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: build the CUDA kernels, hold each one
against its plain PyTorch version, and serve ``gcn-reddit`` on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. device — require CUDA; print ``nvidia-smi``'s name and power limit;
2. build — compile every kernel source of the served path with ``nvcc``
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
   kernels, ``coo+serial`` ``gemm`` and no ``spmm_ell``.

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

DATASET, SCALE, HIDDEN = "reddit", 0.05, 256
SPMM_TOL = 1e-5                      # same order; FMA-free in both
GEMM_RTOL, GEMM_ATOL = 1e-4, 1e-5    # vs a plain fp32 sum in K order
REPS = 20                            # CUDA-event timings per median
DURATION_S = 5.0                     # length of the Poisson replay

KERNELS = {
    "spmm_ell": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/spmm_ell.cu",
                 "replaces": "src/repro/kernels/spmm.py:210"},
    "gemm": {"route": "cuda",
             "source": "src/repro_torch/kernels/csrc/gemm.cu",
             "replaces": "src/repro/kernels/gemm.py:49"},
}


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


def write_checkpoint(ckpt_dir: str, params, step: int = 0) -> None:
    """The reference ``CheckpointManager`` layout, written with numpy:
    ``step_XXXXXXXX/manifest.json`` plus one ``.npy`` per leaf."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    leaves = {}
    for i, p in enumerate(params):
        fname = f"{i}__w.npy"
        np.save(os.path.join(path, fname), p["w"])
        leaves[f"{i}/w"] = {"file": fname, "shape": list(p["w"].shape),
                            "dtype": str(p["w"].dtype)}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "extra": {}, "leaves": leaves}, f)


def bucket_walk(torch, fn, tables, x, total_rows):
    """Run ``fn(cols, vals, x, out=slice)`` over every non-empty bucket of
    one forward table set, into one buffer — the served ELL walk minus the
    ``inv_perm`` placement."""
    buf = torch.empty((total_rows, x.shape[1]), device=x.device)
    base = 0
    for c, v in zip(tables["cols"], tables["vals"]):
        nb = int(c.shape[0])
        if nb:
            fn(c, v, x, out=buf[base:base + nb])
        base += nb
    return buf


def kernel_phase(torch, device, eng, feats, w1, w2, rng):
    """Phase 3: each kernel against its plain version at the served shapes
    (and ragged edge cases); returns (kernels records, detail dict)."""
    from repro_torch.kernels import gemm, spmm_ell
    from repro_torch.kernels.ref import gemm_ref, spmm_ell_ref

    def plain_out(c, v, x, out):
        out.copy_(spmm_ell_ref(c, v, x))

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
    ccat = np.concatenate([c.reshape(-1) for c in plan1.fwd.cols])
    vcat = np.concatenate([v.reshape(-1) for v in plan1.fwd.vals])
    real = ccat < plan1.n_src
    crow, base = [], 0
    for c in plan1.fwd.cols:
        crow.append(base + np.repeat(np.arange(c.shape[0]), c.shape[1]))
        base += c.shape[0]
    crow = np.concatenate(crow)
    indptr = np.zeros(rows + 1, np.int64)
    np.cumsum(np.bincount(crow[real], minlength=rows), out=indptr[1:])
    order = np.argsort(crow[real], kind="stable")
    csr = torch.sparse_csr_tensor(  # yardstick only, never served
        torch.from_numpy(indptr), torch.from_numpy(ccat[real][order]
                                                   .astype(np.int64)),
        torch.from_numpy(vcat[real][order]), size=(rows, plan1.n_src),
        device=device)
    lib_out = torch.sparse.mm(csr, h1)
    walk = bucket_walk(torch, spmm_ell, tables, h1, rows)
    torch.testing.assert_close(lib_out, walk, rtol=1e-4, atol=1e-5)
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, h1))
    n_real = int(real.sum())
    n_cols = int(len(np.unique(ccat[real])))
    sbytes = ccat.size * 8 + n_cols * d * 4 + rows * d * 4
    sops = 2 * n_real * d
    records["spmm_ell"] = {
        "max_abs_err": worst, "ms": ker, "plain_ms": pla,
        "bound_ms": max(sbytes / bw, sops / flops) * 1e3,
        "bound_by": "bytes" if sbytes / bw >= sops / flops
        else "operations", "library_ms": lib,
        "shape": {"padded_entries": int(ccat.size),
                  "real_entries": n_real, "distinct_cols": n_cols,
                  "rows": rows, "d": d, "buckets": len(plan1.fwd.cols)}}
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
    from repro_torch.kernels import gemm, spmm_ell

    spmm_ell.launches = 0
    gemm.launches = 0
    out = fn(*args, **kwargs)
    counts["spmm_ell"] += spmm_ell.launches
    counts["gemm"] += gemm.launches
    return out


def serving_phase(torch, eng_ell, eng_coo, rng):
    """Phase 4: the bit-match stream on both specs, then the replay on
    ``ell+pipelined``.  Every call into an engine is counted on its own
    (:func:`counted`), so each spec's launches are its own."""
    from repro_torch.serving import InferenceService, poisson_trace

    engines = (eng_ell, eng_coo)
    zero = {"spmm_ell": 0, "gemm": 0}
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
    """Each spec must have run its own kernels: ``ell+pipelined`` both,
    ``coo+serial`` the ``gemm`` combination and no ELL walk."""
    for spec, phases in launches.items():
        for phase, got in phases.items():
            if got["gemm"] <= 0 or ((got["spmm_ell"] > 0)
                                    != spec.startswith("ell")):
                raise AssertionError(f"{spec} {phase}: unexpected kernel "
                                     f"launches {got}")


def run():
    """Phases 3–4 on the card; returns (kernels line, record)."""
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
                     for k in ("spmm_ell", "gemm")}
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
    kernels = []
    for name, meta in KERNELS.items():
        rec = dict(name=name, **meta,
                   launches=totals["ell+pipelined"][name])
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            rec[key] = records[name][key]
        rec["launches_by_path"] = {spec: t[name] for spec, t in totals.items()}
        rec["launches_per_batch"] = {k: v[name] for k, v in per_batch.items()}
        kernels.append(rec)
    record = {"kernels": records, "detail": detail, "serving": rep,
              "launches": launches, "micro_batches": batches,
              "launches_per_batch": per_batch,
              "cold_query_breakdown_ms": breakdown}
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
    _build.build_all(list(KERNELS))
    print(f"build: {len(KERNELS)} kernels in "
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
