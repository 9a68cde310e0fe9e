#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: build the CUDA kernels, hold each one
against its plain PyTorch version, serve ``gcn-reddit`` and train it on the
card, train the paper's GCN model and its Table-1 arms on the card,
resolve ``Engine("auto")`` through the planner on the card, serve
``llama3.2-1b`` (long-prompt prefill and decode), run the paper's
network layer (Algorithm 1, the waves, the int8 gradient sync), train
``llama3.2-1b``, then drive the other LM families (gemma3's sliding
window, moonshot's MoE, mamba2, zamba2, seamless) at full width,
train past 8192 keys through ``flash_mha``'s backward kernel, run
``stablelm-3b`` (head dim 80) past 8192 keys, the one-device dry run over
the grid and the last two examples, train through the
``torch.distributed`` mesh backend on one NCCL rank, and run the LM's
train and prefill steps on a ``(data, model)`` mesh of that rank with
the expert-parallel MoE and an elastic restore.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. device — require CUDA; print ``nvidia-smi``'s name and power limit;
2. build — compile every kernel source of both paths with ``nvcc``
   (one process per source, all at once) and print the build time;
3. kernels — run each kernel on the card at the shapes the serving path
   gives it (the one-launch ELL walk and each bucket of a real layer-1 and
   layer-2 plan, the two combination products) plus ragged edge cases,
   compare with the plain version, and time kernel / plain / one PyTorch
   library call with CUDA events (median of 20 runs); the layer-1 walk is
   also timed bucket by bucket and its hub bucket alone.  Every timed
   kernel and library call also gets its kernel-only time (20 calls
   queued behind a spin kernel, timed by one event pair; the run fails
   unless the wrapper counted exactly 20 × its launches per call), and
   every kernel the host time of a call;
4. serving — ``gcn-reddit`` at its published widths (602 → 256 → 41) on
   ``make_dataset("reddit", scale=0.05)``, weights from a seed written as a
   reference-layout checkpoint and restored through ``ckpt_dir=``; a mixed
   update/query stream where incremental logits must ``torch.equal`` a cold
   recompute for ``ell+pipelined`` and ``coo+serial``, the two specs must
   agree within 1e-5, and ``block+pipelined`` (incremental reuse off) must
   ``torch.equal`` ``coo+serial``; an open-loop Poisson replay on
   ``ell+pipelined`` (rehearsal, then the measured pass).  The launch
   counters are set to 0 just before every call into an engine and read
   just after it, so each spec's launches are its own: ``ell+pipelined``
   must launch ``spmm_ell`` and ``gemm``, ``coo+serial`` ``gemm`` alone,
   ``block+pipelined`` ``spmm_block`` and ``gemm``;
5. training kernels — on a real training batch of ``make_dataset("reddit",
   scale=1.0)`` at P = 16 stacked cores, both hops' stacked forward walks
   (``spmm_ell``, each core reading its own rows) and transpose walks
   (``spmm_ell_t``, every core reading the one all-gathered error), each
   at the width the main path gives it (256 for the deepest hop, 41 for
   the last), plus edge cases (K = 1, d = 41, an empty core, pad-only
   rows), all bit-equal to the plain version; the deepest hop's transpose
   walk timed against the plain version, a bound and ``torch.sparse.mm``;
   its stacked forward walk (one launch for every bucket of every core)
   timed against one launch per bucket and one 2-D launch per bucket and
   core;
6. COO-walk kernels — on the same batch, ``spmm_block`` over both hops'
   stacked sender tiles (each core reading its own rows, at 256 and 41
   wide) and ``spmm`` over their transpose walks (every core reading the
   one all-gathered error) and over the ``coo`` shards both ways, plus one
   serving ``dst_tiles`` layer (``block_tiles`` 4, 256 wide) and edge
   cases (empty tile, all-padding tile, one-entry tiles, d = 1, d = 33, a
   feature-wave slice), all bit-equal to the plain versions, and the block
   partials bit-equal to the coo partials; the deepest hop's forward and
   transpose walks timed against the plain version, a bound and
   ``torch.sparse.mm``;
7. training — ``Trainer(spec, reddit scale=1.0, hidden=256,
   batch_size=1024, fanouts=(10, 25), n_cores=16)`` from a seeded
   checkpoint for ``ell+pipelined`` and ``block+pipelined``, each: 3
   warm-up and 20 measured steps (ms per step, steps/s, host stall per
   step, the host batch build split, device forward/backward ms, the
   device's busy share, kernel launches per step); the first 5 losses must
   match the port's CPU run of the same steps within 1e-4, and a
   checkpoint at step 10 plus a resume must replay steps 11-20 within
   1e-6.  ``coo+serial`` trains 5 steps: within 1e-4 of ``ell``,
   ``torch.equal`` to ``block``, launching ``spmm`` and no ELL kernel; and
   the same batch aggregated twice by ``coo+serial`` gives equal forward
   and gradient bits;
8. the paper's model — ``gcn-reddit`` (602 → 256 → 41) on the training
   data, single device, batch 1024, fanouts (10, 25): the §4.4
   ``LayerShape``s of the first batch and the estimator's orders (ours
   and naive must agree); three arms from the same seeded weights and
   batches for 6 steps (1 warm-up): ``train_gcn(dataflow="naive")``,
   ``train_gcn(model="sage")`` and the ours/gcn loop, each on the card
   and on the CPU (within 1e-4), naive within (1e-4, 1e-5) of ours; per
   arm ms per step, device forward/backward ms and kernel time, peak
   memory beside the summed ``residual_bytes``, and ``gemm`` / ``spmm``
   launches gated every step at what the layer stack implies; the UMA
   baseline against the hypercube aggregate on both hops at P = 16
   (2e-4), each timed, with the bytes each core receives;
9. LM serving — ``llama3.2-1b`` at its published config (16 layers,
   d 2048, 32/8 heads, hd 64, d_ff 8192, vocab 128256; f32 weights from a
   seeded generator on the card): ``flash_mha`` against its plain version
   at layer 0's prefill shape (``[32, 16384, 64]``, causal, q/k/v from
   the model's own projection and rotary embedding) and at edge cases
   (non-causal, sq != sk, q_block != k_block, hd 16/32/128, one tile,
   ragged, bf16), within 1e-5 (f32) and 5e-2 (bf16), the layer-0 shape
   timed against the plain version, its bound (f32: three TF32 products
   per multiply-add at the TF32 tensor rate) and SDPA, its largest error
   and SDPA's against a float64 attention (also with q and k doubled),
   and the layer-0 q, k, v cast to bf16 timed against the bf16 bound and
   SDPA's flash backend; ``prefill_fn`` at
   b = 1, s = 16384 (1 warm-up + 3 measured, exactly 16 ``flash_mha``
   launches each, finite logits; the profiler's attention share), a
   prefill at s = 2048 (no launch), and the last logits of a 2-layer
   full-width model at s = 9216 on the card against the port's CPU run
   within 1e-3; ``lm_serve.Server`` (4 slots, ``max_seq`` 128) on the
   reference CLI's traffic (8 requests, prompts of 4-12 tokens,
   ``max_new`` 16): every request completes with the tokens of its run
   alone in the server, no ``flash_mha`` launch, decode calls timed
   against the weight bytes; teacher-forced logits equal token-by-token
   decode within 1e-3;
10. the Engine's other axes (run after phase 8, on its training data and
   seeded weights, P = 16): (a) both hops of the first batch at 41 and 256
   wide through ``EngineBundle.aggregate`` and its gradient for
   ``ell+pipelined``, ``block+pipelined`` and ``coo+serial`` on ring,
   allpairs and torus2d, within 1e-5 of the same format on the hypercube,
   each topology's ``ExchangePlan`` beside its forward + backward event ms
   at hop 1 (one card has no wire: the exchange is a copy on the device, so
   the times show the round count, not a network); (b) Trainer arms
   ``ell+pipelined+torus2d``, ``ell+pipelined+ring`` and
   ``block+pipelined+allpairs``, 3 warm-up + 5 steps, the first 5 losses
   within 1e-4 of phase 7's hypercube arm and the first 3 within 1e-4 of
   the port's CPU run; (c) ``merge="redundancy"`` on ``ell+pipelined``, 5
   steps within 1e-4 of phase 7's dedup arm, each step's ``spmm_ell`` /
   ``spmm_ell_t`` launches equal to what its tables give (failing if no
   virtual vertex was mined), per hop the tier's stats and the mining's
   host ms, and the ``vv`` / ``vvt`` pre-pass walks bit-equal to the plain
   version and timed against it, their bound and ``torch.sparse.mm``; (d)
   ``ell+pipelined+hypercube+mincom``, 5 steps within 1e-4 of the naive
   arm, the plan reports' wire bytes naive vs mincom and the host batch
   split with the relabeling's ms.

11. ``Engine("auto")`` (run after phase 10, on its training data, seeded
   weights and first batch, P = 16; every record under ``build/`` through
   the ``REPRO_TORCH_*_PATH`` variables, restored afterwards): (a) the
   caps sweep ``tune.autotune`` at n = 16384, deg 25, d 256, each
   candidate's ms per forward + backward, exactly one ``spmm_ell`` and
   one ``spmm_ell_t`` launch per call, ``get_config()`` returning the
   winner; (b) ``ell+pipelined`` on each topology through the planner's
   ``_autotune_measure`` at the batch's ``GraphStats``, written as a
   topology record and fitted (α, β, const, each topology's predicted vs
   measured seconds per step; the exchange is a copy on the device); (c)
   ``rank_specs`` with each format's roofline ratio, ``resolve_spec``
   equal to its first entry with no planner record, ``count_work`` of
   each format's layer equal on the card and the CPU; (d)
   ``planner.autotune`` over every three-part spec (3 steps × 8 trials,
   first-step losses within 1e-5), a second call launching nothing; (e)
   ``Trainer("auto")`` 3 warm-up + 5 steps: the tier-1 winner's spec, its
   losses bit-equal to a concrete ``Trainer`` of that spec and the same
   launches every step; (f) ``InferenceEngine("auto", max_batch=8)`` on
   phase 4's graph and checkpoint resolving as the serving planner says,
   8 cold queries bit-equal to a concrete engine of that spec.
12. feature stores (run after phase 11, on phase 7's training data,
   seeded checkpoint and Trainer configuration, P = 16): (a)
   ``make_dataset(..., features="mmap")`` under ``build/``, its rows and
   labels equal to phase 7's dense dataset (bytes and generation time
   printed; the file is deleted at the end); (b) ``ell+pipelined`` from
   that store (``feature_store="mmap"``) behind a hot-vertex cache of a
   tenth of the nodes, 3 warm-up + 10 steps through the staged chain
   (sample → gather → layout on producer threads, placement on this
   thread): losses and each step's launches equal to phase 7's dense arm,
   the cache's ``device_rows`` on the card equal to its host rows; ms per
   step, host stall, per-stage stalls, the cache's gather host ms a batch
   and its stats, the store's gather calls and bytes, the host batch
   split; (c) ``block+pipelined``, and ``ell+pipelined`` beside (b)'s
   cache, with ``feature_store="host"`` and no cache, 3 warm-up + 10
   steps equal to phase 7's; (d) (b)'s checkpoint at step 5 resumed:
   steps 6-10 equal; (e) a dense Trainer under a ``device_budget_bytes``
   below the feature matrix raises, the store-backed one builds; (f) an
   ``InferenceEngine`` on phase 4's graph and checkpoint over an
   ``MmapStore`` with ``feature_cache_capacity=4096``: 8 cold queries equal
   to a dense engine's, and its feature cache hit; (g) ``python -m
   repro_torch.launch.serve --smoke`` on the card exits 0.  The phase
   fails past ``FEATURE_STORE_PHASE_S`` (120 s).
13. the paper's network layer (run after phase 9, on phase 7's training
   data, first batch and seeded weights, P = 16): (a) Fig. 9,
   ``fuse_experiment(g, 1000, seed=0)`` for g = 1..4 (averages sorted,
   Fuse4 in [4.0, 6.5], each step <= 1.5 cycles) and §5.2's bandwidth
   model at the Fuse4 period (4 ns a cycle) beside the paper's 2.96 TB/s;
   (b) both hops as Block-Message waves (``build_waves``), every wave
   routed by Algorithm 1 and validated, the waves' edges equal to the
   off-diagonal nnz and their messages to the distinct off-diagonal rows
   of ``sender_merge_flat``, ``wave_statistics`` and
   ``compare_schedules`` per wave, ``schedule_bytes`` equal to the
   hypercube plan's bytes; (c) the Weight-Bank sync: the 16 per-core
   gradients of the seeded weights (164,608 parameters) sum to the
   bundle's within 1e-5, ``compressed_psum`` on the card ``torch.equal``
   to the CPU and within 0.05 of the exact sum, 8 error-feedback steps
   with a bias under 0.02, and ``compressed_psum`` against the f32 fold
   timed beside their wire bytes (one card: the exchange is a copy).
   Fails past ``NETWORK_PHASE_S`` (60 s).
14. LM training: (a) ``train_lm("llama3.2-1b", smoke=False, steps=6,
   batch=2, seq=64)`` on the card (16 layers, d 2048, f32 AdamW): finite
   losses, no ``flash_mha`` launch, ms per step, parameters, peak memory;
   (b) 2 layers at full width, 2 steps on the card and on the port's CPU
   from the same seeded weights, losses within 1e-4; (c) the smoke config
   with worker 3 dead from step 4 (survivors [0, 1, 2], a checkpoint at the
   miss), resumed to 12 steps equal to an uninterrupted run within 1e-6,
   and ``examples/torch_elastic_restart.py`` exiting 0.  Fails past
   ``LM_TRAIN_PHASE_S`` (120 s).
15. the LM families (f32 weights from seeded generators, each model freed
   before the next): (a) ``flash_mha`` with a window at gemma3's layer-0
   shape (its own q, k, v: ``[32, 16384, 128]``, w 1024) against the
   plain version in f32 and bf16, w >= s ``torch.equal`` to the causal
   call, the edge cases of ``WINDOW_EDGES`` (w 1, 7, 64, 65, sq != sk,
   ragged); event, kernel-only and host ms against the causal call, the
   live-pair bound, the plain version and SDPA with the boolean band mask
   (the ``flash_mha_window`` entry of the ``kernels`` line), and SDPA's
   causal call at the same shape beside the causal kernel; (b)
   gemma3-27b at full width cut to 6 layers: a prefill at s = 16384
   launching ``flash_mha`` once and windowed 5 times, tokens/s, peak
   memory, and card vs CPU at 2 layers, s = 9216, within 1e-3; (c)
   moonshot-v1-16b-a3b at full width cut to 4 layers: a prefill at
   s = 16384 (4 launches), each layer's drop fraction at capacity factor
   1.25, the server on ``lm_serve.main``'s traffic, decode against the
   teacher-forced forward at factor 8 within 1e-3, and card vs CPU at 2
   layers, s = 9216: the routes compared first (flipped (token, layer)
   slots counted, at most ``MOE_FLIP_SHARE``), then the logits of up to
   512 of the rows no flip reaches (own routes agreeing, before the first
   token flipped in a layer before the last) within 1e-3; (d)
   mamba2-1.3b (48 layers, no launch) and zamba2-1.2b (38 layers, one
   launch per shared-block application: 6) prefills at s = 16384 and their
   servers (4 requests of 8 tokens); seamless-m4t-medium (12 + 12 layers) on 16384 stub frames and
   4096 tokens: 12 encoder and 12 cross-attention calls, non-causal (the
   cross ones sq != sk), none for the decoder's self-attention, then
   ``prefill_cross`` and 8 decode steps; (e) ``train_lm(smoke=True,
   steps=4)`` for moonshot, mamba2, zamba2 and seamless on the card
   within 1e-4 of the port's CPU from the same weights, and
   ``examples/torch_serve_lm.py`` on moonshot's smoke config exiting 0
   (started beside gemma3's CPU gate, when the card is idle).
   Fails past ``LM_FAMILIES_PHASE_S`` (180 s).
16. LM training past ``FLASH_THRESHOLD``: the CPU halves of (c) and (d)
   start first in two processes of their own, beside the card's work; (a)
   ``flash_mha_bwd`` at llama3.2-1b's layer shape ``[32, 16384, 64]``
   causal f32 and at gemma3's ``[32, 16384, 128]`` w 1024 in f32 and
   bf16, and at ``BWD_EDGES`` (``WINDOW_EDGES``, non-causal sq != sk,
   ragged, hd 16 and 32, rows with no live key), each on the forward's
   own ``o`` and ``lse`` (``o`` bit-equal to a call without ``lse``)
   against ``mha_bwd_ref``, f32 also against a float64 plain backward
   (within twice the plain f32 version's distance, or 2^-20 of the
   largest entry), bf16 within 1e-2 of the largest entry; event,
   kernel-only and host ms, the bound (five products at the forward's
   rate), the plain version and SDPA's backward, event and kernel-only
   ms (the
   ``flash_mha_bwd`` and ``flash_mha_bwd_window`` entries of the
   ``kernels`` line); (b) llama3.2-1b at full width through
   ``build_step(cfg, "train")`` (remat, AdamW), batch 1 × 16384 tokens,
   1 warm-up + 3 steps, each launching ``flash_mha`` 32 times (forward
   and recompute) and ``flash_mha_bwd`` 16 times: ms a step, peak
   memory, and under the profiler one more step (after its warm-up
   step): the forward's and backward's kernel shares of its wall time
   from their device records; at 4 layers remat's peak below
   the peak without it; (c) the smoke config (2 layers) at s = 9216:
   loss card vs CPU within 1e-4 and every gradient leaf within the
   reference tests' 2e-3; (d) ``train_lm(smoke=True, steps=2, batch=1)``
   at s = 9216 (seamless 10240) for gemma3, moonshot, zamba2 and seamless
   within 1e-4 of the CPU, launching ``flash_mha_bwd``.  Fails past
   ``LM_LONG_TRAIN_PHASE_S`` (150 s).
17. head dim 80, the dry run, the examples: ``python -m
   repro_torch.launch.dryrun --jobs 4 --out build/dryrun.json`` (fake
   ``cuda`` tensors, the card's path) and the CPU halves of (b)'s gates
   start first, in processes of their own; (a) ``flash_mha`` and
   ``flash_mha_bwd`` at head dim 80 on stablelm-3b's layer shape
   ``[32, 16384, 80]`` (layer 0's own q, k, v), causal: the forward in
   f32 against ``mha_ref`` and a float64 plain forward (1e-5) and in bf16
   (5e-2), the backward on the forward's own ``o`` / ``lse`` through
   phase 16's gate (f32 within twice the plain version's distance from
   float64, bf16 within 1e-2 of each gradient's largest entry), both at
   ``HD80_EDGES`` (ragged, non-causal sq != sk, a window); event,
   kernel-only and host ms against the plain versions, the bounds and
   SDPA's forward and backward (the ``flash_mha_hd80`` and
   ``flash_mha_bwd_hd80`` entries of the ``kernels`` line, whose launches
   the wrappers count at head dim 80 without a window); (b) stablelm-3b at full width cut to 4
   layers (f32): a prefill at s = 16384 (4 launches), tokens/s and peak,
   and ``build_step(cfg, "train")`` (remat, AdamW) at 1 × 16384, 1
   warm-up + 1 step, each launching ``flash_mha`` 8 and
   ``flash_mha_bwd`` 4 times, ms and peak; card vs CPU: 2 full-width
   layers' prefill logits at s = 9216 within 1e-3, and the smoke config
   at head dim 80 trained at s = 9216, loss within 1e-4 and every
   gradient leaf within 2e-3; (c) the dry run exits 0 with 33 records and
   7 skips, ``stablelm-3b × prefill_32k`` among them, and for (b)'s two
   cells the dry-run helper on fake ``cuda`` tensors gives the (flops,
   bytes) of ``count_work`` of the real call and a peak within 10% of
   ``torch.cuda.max_memory_allocated()`` over it (only its inputs live);
   (d) ``examples/torch_quickstart.py`` (launching ``spmm``) and
   ``examples/torch_distributed_gcn.py`` (``spmm_ell``, ``spmm_ell_t``)
   run on the card, launches counted.  Fails past ``HD80_PHASE_S``
   (240 s).

18. mesh — the port's ``torch.distributed`` backend on one rank: an NCCL
   process group of the script's own process (a ``FileStore`` under
   ``build/``) and ``make_topology_mesh`` on ``cuda`` (the card count and
   NCCL's version printed); ``Trainer("ell+pipelined", mesh=...)`` at
   phase 7's full width (16 cores, batch 1024, fanouts (10, 25)) from
   phase 7's seeded step-0 checkpoint, 3 warm-up and 10 measured steps,
   each counted: its losses ``torch.equal`` to phase 7's ``ell+pipelined``
   losses for the same steps and its ``spmm_ell`` / ``spmm_ell_t``
   launches each step equal to phase 7's; ``grad_accum(axis_names=
   ("model",))`` (bucketed or not) on the mesh the bits of the local call;
   ms per step, host stall, placement, and the Weight-Bank
   ``all_reduce``'s device ms from ``torch.profiler`` (with its record
   count) and on its own by CUDA events.  The mesh Trainer runs twice,
   between two runs of the stacked Trainer over the same steps (stacked,
   mesh, mesh, stacked, all with the group up), after one stacked run
   before the group starts; every run is held to phase 7's losses and
   launches, and each prints its ms per step, host stall and placement
   per step beside phase 7's.  Then the paper's orthogonal topology:
   ``Trainer("ell+pipelined+torus2d")`` for ``MESH_TORUS_STEPS`` (3)
   steps stacked, then on the mesh ``make_topology_mesh(16, "torus2d")``
   builds, each step counted: losses ``torch.equal`` and ``spmm_ell`` /
   ``spmm_ell_t`` launches equal each step, the arm within
   ``MESH_TORUS_S`` (10 s), its ms a step and seconds printed; and one
   int8 ``compressed_psum(layout=)`` over the mesh's layout ``torch.equal``
   to the stacked call.  One card holds one rank, so the layout spans
   nothing, no cross-rank transfer runs and no NVLink figure comes from
   here (the rank rounds of every topology and of the int8 sync run over
   gloo in ``tests/test_torch_mesh_train.py`` and
   ``tests/test_torch_topology_ranks.py``).  The group is destroyed at
   the phase's end.  Fails past ``MESH_PHASE_S`` (120 s).
19. the LM on a mesh — a one-rank NCCL group again (a ``FileStore``
   under ``build/``) and the ``(1, 1)`` ``("data", "model")`` mesh that
   ``make_mesh_from_plan(scale_plan(1, model_parallel=1))`` builds;
   moonshot-v1-16b-a3b at full width cut to ``MOE_LAYERS`` (4) layers,
   f32, batch 1 × ``LONG_GATE_S`` (9216) tokens: (a) one AdamW step
   unsharded through ``build_step(cfg, "train")`` from seeded weights
   (its new params kept on the host); (b) the same step from the same
   seed through ``build_step(cfg, "train", ep_spec=ep_spec_for(...))``
   under ``use_mesh`` on params and moments placed by ``tree_shardings``
   (on one rank the placed leaves are the tensors themselves), each
   block computing in its ``model`` split by ``tp_plan`` (on one rank
   the split is trivial and runs no collective): no
   flipped route in any of its routings, the loss within 1e-6 relative,
   every parameter within 1e-5 of its leaf's largest |p|, ``flash_mha``
   and ``flash_mha_bwd`` launched the same number of times in both
   arms, each arm's ``max_memory_allocated`` printed and the mesh arm's
   within 10% of the unsharded one's (no second copy of the params), and
   whether the bits are equal; (c) the prefill at s = 9216 both ways on
   (b)'s params, logits within 1e-5 of their largest; (d) one MoE
   layer's forward through ``moe_ffn_ep``: exactly one reduce-scatter and
   one all-gather (or one ``all_reduce``), their bytes printed; (d')
   ``tp_plan``'s plan of the model (printed), and one dense layer at its
   width (d 2048, 16 heads, d_ff 1408) forward at (b)'s shape under the
   mesh's ``Split``: no collective on one rank (two all-reduces at
   W > 1), a finite output; (e) at
   one full-width layer (an ~11 GB checkpoint) one step on the mesh, the
   placed params and AdamW state saved with ``CheckpointManager.save(
   shardings=)`` and restored with ``restore_latest(like, shardings=)``
   onto a second mesh from ``make_mesh_from_plan``: every leaf's bits
   equal to the live state's, and one more step from each giving the
   same loss bits.  One card holds one rank, so no NVLink figure comes
   from here (the cross-rank paths run over gloo in
   ``tests/test_torch_moe_ep.py`` and ``tests/test_torch_lm_mesh_train.
   py``).  Fails past ``LM_MESH_PHASE_S`` (120 s).

The last three lines are ``nvidia-smi``'s name and power limit, the
``kernels`` JSON record and ``{"ok": true, "device": {...}}``.  A longer
record goes to ``build/chip_smoke.json``.  The script imports nothing of
JAX or of the reference package.
"""
from __future__ import annotations

import json
import os
import re
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
SPIN_CYCLES_PER_MS = 2e6             # cycles in a ms at 2 GHz, above the
                                     # H100's top SM clock: a spin's floor
SPIN_TRIES = 3                       # spins queued_ms tries, each longer
PROFILE_GUARD_S = 0.05                # idle time at a profiled step's ends
DURATION_S = 5.0                     # length of the Poisson replay
TRAIN_CORES, TRAIN_BATCH, TRAIN_FANOUTS = 16, 1024, (10, 25)
WARMUP_STEPS, MEASURED_STEPS, CKPT_STEP = 3, 20, 10
LOSS_TOL, RESUME_TOL = 1e-4, 1e-6    # card vs CPU (sum order); resume
# the paper's model (phase 8): arm → (model, dataflow); 1 warm-up + 5 steps
PAPER_ARMS = {"naive": ("gcn", "naive"), "sage": ("sage", "ours"),
              "ours": ("gcn", "ours")}
PAPER_WARMUP, PAPER_STEPS, PAPER_LR = 1, 6, 0.05
NAIVE_RTOL, NAIVE_ATOL = 1e-4, 1e-5  # naive vs ours: tests/test_system.py:76-77
UMA_TOL = 2e-4                       # UMA vs hypercube: the reference's bound

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
    "spmm_block": {"route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/spmm_coo.cu",
                   "replaces": "src/repro/kernels/spmm.py:92"},
    "spmm": {"route": "cuda",
             "source": "src/repro_torch/kernels/csrc/spmm_coo.cu",
             "replaces": "src/repro/kernels/spmm.py:131"},
    "flash_mha": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/flash_mha.cu",
                  "replaces": "src/repro/kernels/flash.py:81"},
    # the same kernel with a sliding window (its windowed launches, counted
    # apart from flash_mha's): the reference applies the window in its XLA
    # flash_attend, outside the Pallas kernel
    "flash_mha_window": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_mha.cu",
        "replaces": "src/repro/kernels/flash.py:81 with the window of "
                    "src/repro/models/transformer.py:122-158"},
    # flash_mha's gradient (phase 16): the Pallas kernel has no backward;
    # the reference's jax.grad differentiates its XLA flash_attend scan
    "flash_mha_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_mha_bwd.cu",
        "replaces": "no Pallas kernel: jax.grad of "
                    "src/repro/models/transformer.py:122 flash_attend"},
    # ... its windowed calls, counted apart
    "flash_mha_bwd_window": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_mha_bwd.cu",
        "replaces": "no Pallas kernel: jax.grad of "
                    "src/repro/models/transformer.py:122-158 flash_attend "
                    "with w_eff"},
    # phase 17: both kernels' head-dim-80 instantiations on stablelm-3b's
    # path (the grid's only head dim 80), counted by the wrappers apart
    "flash_mha_hd80": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_mha.cu",
        "replaces": "src/repro/kernels/flash.py:81 at head dim 80"},
    "flash_mha_bwd_hd80": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_mha_bwd.cu",
        "replaces": "no Pallas kernel: jax.grad of "
                    "src/repro/models/transformer.py:122 flash_attend at "
                    "head dim 80"},
}
# phase 10: the Engine's other axes on the training batch
AXES_FORMATS = ("ell+pipelined", "block+pipelined", "coo+serial")
AXES_TOPOLOGIES = ("ring", "allpairs", "torus2d")
AXES_TOL = 1e-5                      # vs the hypercube: the reference's bound
AXES_ARMS = ("ell+pipelined+torus2d", "ell+pipelined+ring",
             "block+pipelined+allpairs")
AXES_WARMUP, AXES_STEPS, AXES_CPU_STEPS = 3, 5, 3
FORMAT_WALKS = {"ell": ("spmm_ell", "spmm_ell_t"),
                "block": ("spmm_block", "spmm"), "coo": ("spmm",)}
# the redundancy tier's walks: the ELL kernel over the vv / vvt tables
PREPASS = {
    "spmm_ell_vv": {"route": "cuda", "kernel": "spmm_ell", "prefix": "vv_",
                    "source": "src/repro_torch/kernels/csrc/spmm_ell.cu",
                    "replaces": "src/repro/kernels/spmm.py:210"},
    "spmm_ell_t_vvt": {"route": "cuda", "kernel": "spmm_ell_t",
                       "prefix": "vvt_",
                       "source": "src/repro_torch/kernels/csrc/spmm_ell.cu",
                       "replaces": "src/repro/kernels/spmm.py:245"},
}
# phase 11: the planner on the training data (P = 16)
PLANNER_CAPS_SHAPE = (16384, 25, 256)  # n >= hop 1's n_dst, its fanout, d
PLANNER_TOPOLOGY_SPECS = tuple(f"ell+pipelined+{t}" for t in (
    "hypercube", "ring", "allpairs", "torus2d"))
PLANNER_STEPS, PLANNER_TRIALS = 3, 8  # the reference's autotune defaults
PLANNER_PHASE_S = 90.0               # phase 11's time limit, seconds
AUTO_WARMUP, AUTO_STEPS, AUTO_QUERIES, AUTO_MAX_BATCH = 3, 5, 8, 8
PLANNER_RECORDS = {"REPRO_TORCH_AUTOTUNE_PATH": "chip_smoke_autotune.json",
                   "REPRO_TORCH_PLANNER_PATH": "chip_smoke_planner.json",
                   "REPRO_TORCH_TOPOLOGY_PATH": "chip_smoke_topology.json"}
# phase 12: feature stores on the training data (P = 16) and serving graph
STORE_WARMUP, STORE_STEPS, STORE_CKPT_STEP = 3, 10, 5
STORE_HOST_STEPS = 10                # (c): as many as (b), whatever
                                     # the chain's queues hold ahead
STORE_CACHE_SHARE = 10               # cache rows: 1/10 of the nodes
STORE_SERVE_CACHE_ROWS, STORE_QUERIES = 4096, 8
SERVE_SMOKE_ARGS = ("-m", "repro_torch.launch.serve", "--smoke")
FEATURE_STORE_PHASE_S = 120.0        # phase 12's time limit, seconds
COO_WALK_TOL = 0.0                   # COO walks vs plain: bit-equal
BLOCK_TILES = 4                      # the block format's serving tiles
TRAIN_SPECS = ("ell+pipelined", "block+pipelined")
COO_STEPS = 5
SOURCES = sorted({os.path.basename(m["source"])[:-3]
                  for m in KERNELS.values()})
LM_ARCH = "llama3.2-1b"              # the published config, all 16 layers
LM_PREFILL_S = 16384                 # > FLASH_THRESHOLD: the flash branch
LM_SHORT_S = 2048                    # <= FLASH_THRESHOLD: no flash launch
LM_PREFILL_REPS = 3                  # measured prefills (after 1 warm-up)
LM_GATE_LAYERS, LM_GATE_S = 2, 9216  # card vs CPU prefill gate
LM_SLOTS, LM_MAX_SEQ = 4, 128        # the server (lm_serve.main's traffic)
LM_REQUESTS, LM_MAX_NEW = 8, 16
LM_TF_S = 16                         # teacher-forced forward vs decode
LM_LOGIT_TOL = 1e-3                  # card vs CPU / forward vs decode
# phase 13: the paper's network layer (Fig. 9, the waves, the Weight-Bank
# sync) on phase 7's first batch and seeded weights
FIG9_TRIALS, FIG9_SEED = 1000, 0     # fuse_experiment(g, 1000, seed=0)
FIG9_PERIOD_NS = 4.0                 # one cycle at the paper's 250 MHz
PAPER_TBPS = 2.96                    # §5.2's aggregate bandwidth
WAVE_GROUP = 4                       # anti-diagonals a wave (Fig. 6(a))
GRAD_SUM_RTOL = 1e-5                 # per-core gradients vs the bundle's
PSUM_RTOL, EF_BIAS, EF_REPEATS = 0.05, 0.02, 8   # the reference test's bounds
NETWORK_PHASE_S = 60.0               # phase 13's time limit, seconds
# phase 14: LM training (llama3.2-1b, dense, f32, AdamW)
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 6, 2, 64
LM_TRAIN_GATE_STEPS, LM_TRAIN_LOSS_RTOL = 2, 1e-4   # card vs CPU, 2 layers
LM_FAULT_STEPS, LM_FAULT_AT, LM_RESUME_STEPS = 8, 4, 12
LM_FAULT_SEQ, LM_RESUME_TOL = 32, 1e-6
LM_TRAIN_PHASE_S = 120.0             # phase 14's time limit, seconds
ELASTIC_EXAMPLE_ARGS = ("examples/torch_elastic_restart.py",)
# phase 15: the LM families (gemma3's window, MoE, SSM, hybrid, encdec)
LM_FAMILIES_PHASE_S = 180.0          # phase 15's time limit, seconds
FAMILY_S = 16384                     # long prompts, past FLASH_THRESHOLD
FAMILY_PREFILL_REPS = 1              # measured prefills (after 1 warm-up)
YARDSTICK_REPS = 3                   # event-timed calls of a slow yardstick
GEMMA_ARCH, GEMMA_LAYERS = "gemma3-27b", 6    # one 5:1 local:global period
MOE_ARCH, MOE_LAYERS = "moonshot-v1-16b-a3b", 4
SSM_ARCH, HYBRID_ARCH = "mamba2-1.3b", "zamba2-1.2b"
ENCDEC_ARCH = "seamless-m4t-medium"
FAMILY_GATE_LAYERS, FAMILY_GATE_S = 2, 9216  # card vs CPU, full width
MOE_GATE_ROWS = 512                  # moe gate: rows whose logits compare
MOE_FLIP_SHARE = 0.01                # flipped (token, layer) routes allowed
MOE_DECODE_CF = 8.0                  # decode vs forward: no slot drops
ENC_FRAMES, DEC_TOKENS, ENCDEC_DECODE_STEPS = 16384, 4096, 8
FAMILY_TRAIN_ARCHS = (MOE_ARCH, SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH)
FAMILY_TRAIN_STEPS = 4
SERVE_EXAMPLE_ARGS = ("examples/torch_serve_lm.py", "--arch", MOE_ARCH)
# (d)'s servers: fewer and shorter requests than (c)'s lm_serve.main
# traffic (each mamba2 / zamba2 decode call is ~60 ms of host time)
RECURRENT_REQUESTS, RECURRENT_MAX_NEW = 4, 8
# the windowed flash_mha's edge cases, causal: (bh, sq, sk, hd, window,
# dtype); every row keeps a key in its band (a row with none comes out 0
# from the kernel, the plain version averages v there)
WINDOW_EDGES = (
    (2, 1024, 1024, 128, 1, "float32"),
    (2, 1024, 1024, 128, 7, "float32"),
    (2, 1024, 1024, 128, 64, "float32"),     # one key tile
    (2, 1024, 1024, 128, 65, "float32"),
    (2, 512, 1024, 64, 65, "float32"),       # sq < sk
    (2, 1024, 512, 64, 600, "float32"),      # sq > sk
    (3, 1000, 1000, 64, 100, "float32"),     # ragged for the kernel
    (2, 1024, 1024, 128, 1, "bfloat16"),
    (2, 1024, 1024, 128, 65, "bfloat16"),
)
# flash_mha vs its plain version: f32 tightened from the reference's 3e-4
# (the card measured <= 9.6e-7 over these checks; only the summation order
# differs); bf16 keeps the reference's 5e-2 (p and o are rounded to bf16)
FLASH_TOL, FLASH_BF16_TOL = 1e-5, 5e-2
# flash_mha edge cases: (bh, sq, sk, hd, q_block, k_block, causal, dtype)
FLASH_EDGES = (
    (4, 1024, 1024, 64, 128, 256, False, "float32"),   # non-causal
    (2, 256, 512, 64, 128, 256, True, "float32"),      # sq < sk
    (2, 512, 256, 64, 256, 128, True, "float32"),      # sq > sk
    (2, 512, 512, 128, 256, 128, True, "float32"),     # qb != kb, hd 128
    (1, 256, 256, 32, 128, 128, True, "float32"),      # hd 32
    (2, 256, 256, 16, 128, 128, True, "float32"),      # hd 16 (smoke)
    (2, 512, 512, 64, 512, 512, True, "float32"),      # one tile
    (3, 100, 70, 32, 4, 2, True, "float32"),           # ragged for the kernel
    (2, 512, 512, 64, 128, 128, True, "bfloat16"),     # bf16
    (2, 512, 512, 64, 128, 128, False, "bfloat16"),
)


# phase 16: LM training past FLASH_THRESHOLD, through flash_mha_bwd
LM_LONG_TRAIN_PHASE_S = 150.0        # phase 16's time limit, seconds
LONG_TRAIN_S = 16384                 # llama's full-width steps (all 16 layers)
LONG_TRAIN_WARMUP, LONG_TRAIN_STEPS = 1, 3
LONG_REMAT_LAYERS = 4                # remat on vs off: the two peaks
LONG_GATE_S = 9216                   # card vs CPU, and the families
# seamless trains on s frames and s // 4 tokens, and the cross-attention's
# s // 4 query rows must divide by Q_BLOCK (9216 // 4 = 2304 does not)
LONG_FAMILY_S = {ENCDEC_ARCH: 10240}
LONG_FAMILY_ARCHS = ("gemma3-27b", MOE_ARCH, HYBRID_ARCH, ENCDEC_ARCH)
LONG_FAMILY_STEPS, LONG_FAMILY_BATCH = 2, 1
# the CPU halves, in two processes of 3 threads each (of the host's 8
# cores): one alone took 74-101 s, its small ops scaling poorly with
# threads, zamba2's SSD and seamless the longest
LONG_CPU_PARTS = (("gate", "gemma3-27b", MOE_ARCH),
                  (HYBRID_ARCH, ENCDEC_ARCH))
LONG_CPU_THREADS = 3
GRAD_RTOL = GRAD_ATOL = 2e-3         # the reference tests' gradient bound
# flash_mha_bwd at the training shapes: (bh, s, hd, window), causal
BWD_SHAPES = {"llama3.2-1b": (32, 16384, 64, None),
              "gemma3-27b": (32, 16384, 128, 1024)}
# f32 vs a float64 plain backward: each of dq, dk, dv within twice the
# plain f32 version's own distance, both distances the L2 norm of the
# difference (the largest entry's error is recorded too, but is a
# max over millions of draws: two versions with the same error sources,
# lse rounded to f32 in both, swing 2x on it with the row blocking
# alone); where the plain version is exact (w 1: one key a row, p = 1)
# twice 0 is 0, so 2^-20 of the float64 gradient's norm is admitted too
BWD_F64_FACTOR, BWD_F64_FLOOR = 2.0, 2.0 ** -20
# bf16 vs the plain version in bf16: both round f32 sums to bf16 (half an
# ulp, 2^-9 of the entry, each) from p computed in another order and
# rounded to bf16 before p^T dO: each of dq, dk and dv within 1e-2 (2.56
# bf16 ulps) of its own largest entry, or within 1e-4 where that is
# smaller: with w 1 dq is 0 up to f32 rounding (p = 1 and dP = δ; ~1e-6
# from unit-normal inputs)
BWD_BF16_TOL, BWD_BF16_FLOOR = 1e-2, 1e-4
# flash_mha_bwd's edge cases: (bh, sq, sk, hd, causal, window, dtype):
# WINDOW_EDGES (causal) and the non-causal, ragged and no-key rows
BWD_EDGES = tuple((bh, sq, sk, hd, True, w, dt)
                  for bh, sq, sk, hd, w, dt in WINDOW_EDGES) + (
    (2, 512, 1024, 64, False, None, "float32"),   # sq < sk: cross-attention
    (2, 1024, 512, 128, False, None, "float32"),  # sq > sk
    (2, 1024, 1024, 16, False, None, "bfloat16"),  # hd 16: the smoke configs
    (3, 1000, 1000, 32, True, None, "float32"),   # ragged, hd 32
    (2, 700, 300, 64, False, 200, "float32"),     # rows >= 499 keep no key
    (2, 700, 300, 64, True, 100, "bfloat16"),     # rows >= 399 keep no key
)

# phase 17: head dim 80 (stablelm-3b past FLASH_THRESHOLD), the one-device
# dry run over the grid, and the last two examples
HD80_PHASE_S = 240.0                 # phase 17's time limit, seconds
STABLELM_ARCH, STABLELM_LAYERS = "stablelm-3b", 4   # full width, cut depth
HD80_S = 16384                       # prefill and training, past the threshold
HD80_GATE_LAYERS, HD80_GATE_S = 2, 9216   # card vs CPU (its own process)
HD80_GATE_SEED = 17                  # the gates' weights and tokens
HD80_CPU_THREADS = 3
# hd-80 edge cases of both kernels: (bh, sq, sk, causal, window, dtype);
# every row keeps a key
HD80_EDGES = (
    (3, 1000, 1000, True, None, "float32"),    # ragged for both kernels
    (2, 512, 1024, False, None, "float32"),    # non-causal, sq < sk
    (2, 1024, 512, False, None, "float32"),    # non-causal, sq > sk
    (2, 1024, 1024, True, 100, "float32"),     # a window
    (3, 1000, 1000, True, None, "bfloat16"),
    (2, 1024, 1024, True, 100, "bfloat16"),
)
DRYRUN_ARGS = ("-m", "repro_torch.launch.dryrun", "--jobs", "4", "--out",
               os.path.join("build", "dryrun.json"))
DRYRUN_RECORDS, DRYRUN_SKIPS = 33, 7  # the grid's runnable cells and skips
DRYRUN_PEAK_RTOL = 0.10              # traced peak vs the card's
MESH_PHASE_S = 120.0                 # phase 18's time limit, seconds
MESH_BACKEND, MESH_DEVICE = "nccl", "cuda"   # the one-rank mesh
MESH_WARMUP, MESH_STEPS = 3, 10      # phase 7's ell steps 1-3, then 4-13
MESH_GA_SHAPE = (64, 256, 41)        # grad_accum's rows, d_in, d_out
MESH_TORUS_SPEC = "ell+pipelined+torus2d"   # phase 18's torus2d arm
MESH_TORUS_STEPS = 3                 # its steps, stacked and on the mesh
MESH_TORUS_S = 10.0                  # the arm's time limit, seconds
MESH_PSUM_PER_CORE = 4096            # compressed_psum's n / cores
# phase 19: the LM on a (data, model) mesh (moonshot at MOE_LAYERS layers,
# f32, batch LONG_FAMILY_BATCH x LONG_GATE_S, through the one-rank mesh)
LM_MESH_PHASE_S = 120.0              # phase 19's time limit, seconds
LM_MESH_SEED = 19                    # weights and tokens
LM_MESH_LOSS_RTOL = 1e-6             # mesh step vs unsharded
LM_MESH_PARAM_TOL = 1e-5             # x each leaf's largest |p|
LM_MESH_LOGIT_TOL = 1e-5             # x the largest |logit|
LM_MESH_PEAK_RTOL = 0.10             # mesh arm's peak vs unsharded
# the elastic restore's model: full width at one layer, so that its
# checkpoint (params and both moments, f32) is ~11 GB on disk, not ~31
LM_MESH_ELASTIC_LAYERS = 1
# the examples, their arguments and the kernels each must launch (the
# Trainer's combination h @ w is a plain matmul, as the reference's
# engine.py::_forward_local, so training launches the walks, no gemm)
HD80_EXAMPLES = (
    ("examples/torch_quickstart.py", (), ("spmm",)),
    ("examples/torch_distributed_gcn.py", (), ("spmm_ell", "spmm_ell_t")),
)


def device_peaks(torch):
    """The published rates of card 0
    (:func:`repro_torch.launch.roofline.card_peaks`)."""
    from repro_torch.launch.roofline import card_peaks

    return card_peaks(torch.cuda.get_device_name(0))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=None):
    """Median ms of ``reps`` (default ``REPS``) CUDA-event-timed calls
    (after 3 warm-ups)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS if reps is None else reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(torch, fn):
    """Median host ms of ``REPS`` calls of ``fn`` from an idle card (after
    3 warm-ups): the wrapper's checks, allocation and launch, which
    :func:`time_ms`'s event pair holds on top of the kernel."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def queued_ms(torch, fn, counter=None):
    """Device ms per call of ``fn`` with the host out of the way, and the
    launches ``counter`` (a wrapper of the port) counted over the timed
    calls (``None`` without one).  A spin kernel (``torch.cuda._sleep``)
    holds the card while the host queues ``REPS`` calls behind it, so one
    event pair around them times the card alone, kernels and the gaps
    between them, none of the host time that :func:`time_ms`'s pair holds
    when the card waits for the host.  The spin is lengthened until the
    card is still in it when the last call is queued; raises after
    ``SPIN_TRIES`` spins that ended too soon (``fn`` synchronizes)."""
    for _ in range(3):
        fn()
    spin_ms = 1.0
    for _ in range(SPIN_TRIES):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        before = counter.launches if counter is not None else None
        for _ in range(REPS):
            fn()
        end.record()
        ahead = not start.query()               # the card still spins
        queue_ms = (time.perf_counter() - t0) * 1e3
        count = counter.launches - before if counter is not None else None
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / REPS, count
        spin_ms = 4 * queue_ms + 1.0
    raise AssertionError(f"the host queued {REPS} calls in {queue_ms:.3f} "
                         "ms, after the card's spin ended: the call "
                         "synchronizes")


def kernel_ms(torch, fn, wrapper, launches: int = 1):
    """:func:`queued_ms` of ``fn``, whose calls launch the kernel of the
    port's ``wrapper`` ``launches`` times each, and the launches the
    wrapper counted over the ``REPS`` timed calls: the card's time per
    call, the kernels and the gaps between them alone.  Raises unless the
    count is ``REPS × launches``."""
    ms, count = queued_ms(torch, fn, wrapper)
    if count != REPS * launches:
        raise AssertionError(f"{REPS} calls launched {wrapper.__name__} "
                             f"{count} times, expected {REPS * launches}")
    return ms, count


def profiled(torch, fn):
    """``torch.profiler``'s ``key_averages()`` of one ``fn()`` on the card,
    and its wall seconds, for a call that synchronizes (a training step, a
    decode call), which :func:`queued_ms` cannot time.  The profiler first
    runs ``fn()`` once as its warm-up step and throws those records away,
    and each step starts and ends with ``PROFILE_GUARD_S`` of idle host
    time: without them a profile lost records of its first kernels (PERF.md,
    "the clock"), so the readings built on it carry their record counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    wall = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(PROFILE_GUARD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            time.sleep(PROFILE_GUARD_S)
            prof.step()
    return prof.key_averages(), wall[-1]


def device_records(events, kernel: str = ""):
    """(device ms, record count) of the CUDA records among ``events``
    (``key_averages()`` entries) whose name holds ``kernel`` (``""``: every
    device record but the profiler's own ``ProfilerStep`` range, which
    spans its whole step)."""
    from torch.autograd import DeviceType

    us, count = 0.0, 0
    for evt in events:
        if evt.device_type == DeviceType.CUDA and kernel in evt.key \
                and not evt.key.startswith("ProfilerStep"):
            us += float(evt.self_device_time_total)
            count += int(evt.count)
    return us / 1e3, count


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


def walk_once(torch, fn, walk, x):
    """One table set's whole walk in one launch (``fn`` is
    ``spmm_ell_walk`` or ``spmm_ell_t_walk``) into a fresh buffer, as
    ``ops.ell_apply`` runs it, minus the ``inv_perm`` placement."""
    buf = torch.empty((*walk.lead, walk.total, x.shape[-1]), device=x.device)
    return fn(walk, x, buf)


def kernel_phase(torch, device, eng, feats, w1, w2, rng):
    """Phase 3: each kernel against its plain version at the served shapes
    (and ragged edge cases); returns (kernels records, detail dict)."""
    from repro_torch.kernels import gemm, spmm_ell
    from repro_torch.kernels.ref import gemm_ref, spmm_ell_ref
    from repro_torch.kernels.spmm import spmm_ell_walk

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
        # the whole walk in one launch, as ell_apply runs it
        before = spmm_ell.launches
        got = walk_once(torch, spmm_ell_walk, tables["walk"], x)
        if spmm_ell.launches != before + 1:
            raise AssertionError(f"the {name} walk made "
                                 f"{spmm_ell.launches - before} launches")
        serr[f"{name}_walk"] = max_err(got, bucket_walk(
            torch, plain_out, tables, x, tables["walk"].total))
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

    bw, flops, _, _ = device_peaks(torch)
    records = {}
    # spmm_ell: the layer-1 forward walk, the served unit, in one launch
    tables = plan1.device_tables(device)
    rows = tables["walk"].total
    d = h1.shape[1]
    ker = time_ms(torch, lambda: walk_once(torch, spmm_ell_walk,
                                           tables["walk"], h1))
    detail["spmm_ell_per_bucket_ms"] = time_ms(
        torch, lambda: bucket_walk(torch, spmm_ell, tables, h1, rows))
    only = kernel_ms(torch, lambda: walk_once(torch, spmm_ell_walk,
                                              tables["walk"], h1), spmm_ell)
    hub = max((i for i, c in enumerate(tables["cols"]) if c.shape[0]),
              key=lambda i: tables["cols"][i].shape[1])
    hc, hv = tables["cols"][hub], tables["vals"][hub]
    detail["spmm_ell_hub_bucket"] = {
        "K": int(hc.shape[1]), "nb": int(hc.shape[0]),
        "ms": time_ms(torch, lambda: spmm_ell(hc, hv, h1)),
        "kernel_only_ms_count": kernel_ms(
            torch, lambda: spmm_ell(hc, hv, h1), spmm_ell)}
    pla = time_ms(torch, lambda: bucket_walk(torch, plain_out, tables,
                                             h1, rows))
    # the same function as one CSR product: row i of the CSR is row i
    # of the concatenated bucket outputs
    one_core = [c[None] for c in plan1.fwd.cols]
    csr = stacked_csr(torch, one_core, [v[None] for v in plan1.fwd.vals],
                      plan1.n_src, device)
    lib_out = torch.sparse.mm(csr, h1)
    walk = walk_once(torch, spmm_ell_walk, tables["walk"], h1)
    torch.testing.assert_close(lib_out, walk, rtol=1e-4, atol=1e-5)
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, h1))
    sshape = walk_shape(one_core, plan1.n_src, shared_x=True)
    bound, bound_by = walk_bound(sshape, d, bw, flops)
    records["spmm_ell"] = {
        "max_abs_err": worst, "ms": ker, "plain_ms": pla,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib,
        "kernel_only_ms": only[0], "kernel_only_count": only[1],
        "host_ms": host_ms(torch, lambda: walk_once(
            torch, spmm_ell_walk, tables["walk"], h1)),
        "library_kernel_only_ms": queued_ms(
            torch, lambda: torch.sparse.mm(csr, h1))[0],
        "shape": dict(sshape, d=d, buckets=len(plan1.fwd.cols))}
    # gemm: the layer-1 combination [n_src1, 602] @ [602, 256]
    m, k = x1.shape
    nn = w1.shape[1]
    ker = time_ms(torch, lambda: gemm(x1, w1))
    only = kernel_ms(torch, lambda: gemm(x1, w1), gemm)
    pla = time_ms(torch, lambda: gemm_ref(x1, w1))
    lib = time_ms(torch, lambda: torch.matmul(x1, w1))
    gbytes = (m * k + k * nn + m * nn) * 4
    gops = 2 * m * nn * k
    records["gemm"] = {
        "max_abs_err": max(gerr.values()), "ms": ker, "plain_ms": pla,
        "bound_ms": max(gbytes / bw, gops / flops) * 1e3,
        "bound_by": "bytes" if gbytes / bw >= gops / flops
        else "operations", "library_ms": lib,
        "kernel_only_ms": only[0], "kernel_only_count": only[1],
        "host_ms": host_ms(torch, lambda: gemm(x1, w1)),
        "library_kernel_only_ms": queued_ms(
            torch, lambda: torch.matmul(x1, w1))[0],
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


def launch_counters():
    """Kernel name → its wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels import (flash_mha, flash_mha_bwd, gemm, spmm,
                                     spmm_block, spmm_ell, spmm_ell_t)

    return {"spmm_ell": spmm_ell, "spmm_ell_t": spmm_ell_t, "gemm": gemm,
            "spmm_block": spmm_block, "spmm": spmm, "flash_mha": flash_mha,
            "flash_mha_bwd": flash_mha_bwd}


def launch_totals(kernels):
    """Kernel name (``KERNELS``' names) → launches counted so far by the
    wrappers of ``kernels`` (:func:`launch_counters`): ``flash_mha``'s
    and ``flash_mha_bwd``'s windowed launches as ``flash_mha_window`` and
    ``flash_mha_bwd_window``, those at head dim 80 without a window as
    ``flash_mha_hd80`` and ``flash_mha_bwd_hd80`` (as each wrapper counted
    them where it launched), their others under their own names."""
    out = {name: k.launches for name, k in kernels.items()}
    for name in ("flash_mha", "flash_mha_bwd"):
        out[f"{name}_window"] = kernels[name].window_launches
        out[f"{name}_hd80"] = kernels[name].hd80_launches
        out[name] -= out[f"{name}_window"] + out[f"{name}_hd80"]
    return out


def counted(counts, fn, *args, **kwargs):
    """Call ``fn`` with every launch counter set to 0 just before it and add
    what it launched, read just after, to ``counts`` (named as
    :func:`launch_totals` names them)."""
    kernels = launch_counters()
    for k in kernels.values():
        k.launches = 0
    for name in ("flash_mha", "flash_mha_bwd"):
        kernels[name].window_launches = kernels[name].hd80_launches = 0
    out = fn(*args, **kwargs)
    for name, n in launch_totals(kernels).items():
        counts[name] = counts.get(name, 0) + n
    return out


def prepass_counted(counts, fn, *args):
    """Call ``fn`` and add to ``counts`` the ``spmm_ell`` / ``spmm_ell_t``
    launches of the redundancy pre-pass alone: the walks ``ell_apply``
    makes over a ``vv_`` / ``vvt_`` table set (the descriptors ``_walk_of``
    hands out for those prefixes), each read from its kernel's launch
    counter across that walk's call."""
    from repro_torch.kernels import ops, spmm_ell, spmm_ell_t

    walk_of, walks = ops._walk_of, []
    saved = (ops._walk_of, ops.spmm_ell_walk, ops.spmm_ell_t_walk)

    def tagging(tables, prefix):
        walk = walk_of(tables, prefix)
        if prefix in ("vv_", "vvt_"):
            walks.append(walk)
        return walk

    def measuring(walk_fn, name, kernel):
        def call(walk, x, out):
            before = kernel.launches
            got = walk_fn(walk, x, out)
            if any(walk is w for w in walks):
                counts[name] = counts.get(name, 0) + kernel.launches - before
            return got
        return call

    ops._walk_of = tagging
    ops.spmm_ell_walk = measuring(saved[1], "spmm_ell", spmm_ell)
    ops.spmm_ell_t_walk = measuring(saved[2], "spmm_ell_t", spmm_ell_t)
    try:
        return fn(*args)
    finally:
        ops._walk_of, ops.spmm_ell_walk, ops.spmm_ell_t_walk = saved


def serving_phase(torch, eng_ell, eng_coo, eng_blk, rng):
    """Phase 4: the bit-match stream on the three specs, then the replay on
    ``ell+pipelined``.  Every call into an engine is counted on its own
    (:func:`counted`), so each spec's launches are its own."""
    from repro_torch.serving import InferenceService, poisson_trace

    if eng_blk.incremental_supported or eng_blk.stats()[
            "incremental_supported"]:
        raise AssertionError("block+pipelined reports incremental reuse on")
    engines = (eng_ell, eng_coo, eng_blk)
    zero = dict.fromkeys(KERNELS, 0)
    launches = {"ell+pipelined": {"stream": dict(zero),
                                  "rehearsal": dict(zero),
                                  "replay": dict(zero)},
                "coo+serial": {"stream": dict(zero)},
                "block+pipelined": {"stream": dict(zero)}}
    batches = {spec: {"stream": 0} for spec in launches}

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
        for eng in (eng_ell, eng_coo):
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
        # block serves cold recomputes, in coo's per-row order: equal bits
        blk = torch.from_numpy(query(eng_blk, q))
        if not torch.equal(blk, out["coo+serial"]):
            raise AssertionError(f"block logits != coo logits in round {rnd}"
                                 f" (max |diff| "
                                 f"{max_err(blk, out['coo+serial'])})")
    for eng in (eng_ell, eng_coo):
        if not (eng.rows_from_cache > 0 and eng.cache.invalidations > 0):
            raise AssertionError(f"{eng.spec}: the stream reused nothing")
    if eng_blk.rows_from_cache:
        raise AssertionError("block+pipelined reused cached rows")

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
    rep["block_vs_coo_equal"] = True
    return rep, launches, batches


def check_launches(launches):
    """Each serving spec must have run its own kernels: every spec the
    ``gemm`` combination, ``ell+pipelined`` the ELL walk, ``block+pipelined``
    the ``spmm_block`` walk, ``coo+serial`` neither; serving has no
    backward, so no transpose walk and no flat ``spmm``."""
    for spec, phases in launches.items():
        fmt = spec.split("+")[0]
        for phase, got in phases.items():
            if got["gemm"] <= 0 or got["spmm_ell_t"] != 0 \
                    or got["spmm"] != 0 \
                    or (got["spmm_ell"] > 0) != (fmt == "ell") \
                    or (got["spmm_block"] > 0) != (fmt == "block"):
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


def walk_bound(shape, d, bw, flops, entry_bytes=8):
    """(bound ms, bound_by) of a walk: bytes = real entries × entry_bytes
    (column and value for an ELL table; row, column and value for a COO
    list) + distinct gathered rows × d × 4 + output rows with an entry × d
    × 4 over the memory rate; flops = 2 × real entries × d over the fp32
    rate."""
    nbytes = shape["real_entries"] * entry_bytes \
        + shape["distinct_rows"] * d * 4 + shape["rows_with_entries"] * d * 4
    ops = 2 * shape["real_entries"] * d
    return (max(nbytes / bw, ops / flops) * 1e3,
            "bytes" if nbytes / bw >= ops / flops else "operations")


def stacked_csr(torch, np_cols, np_vals, n_cols, device, own_x=False):
    """One CSR ``[P·rows, n_cols]`` holding every core's bucket rows, in the
    walk's buffer order (core-major, buckets concatenated) — the library
    yardstick for a walk whose cores share one ``x`` (a 2-D walk is one
    core: ``[1, nb, K]`` buckets).  ``own_x``: each core reads its own
    ``x`` rows, so core *p*'s columns move by ``p·n_cols`` and the CSR is
    ``[P·rows, P·n_cols]`` over the cores' rows stacked."""
    P = np_cols[0].shape[0]
    rows = sum(c.shape[1] for c in np_cols)
    crow, ccol, cval = [], [], []
    for p in range(P):
        base = p * rows
        for c, v in zip(np_cols, np_vals):
            nb, K = c.shape[1:]
            crow.append(base + np.repeat(np.arange(nb), K))
            ccol.append(np.where(c[p] < n_cols, c[p] + p * n_cols * own_x,
                                 P * n_cols).reshape(-1))
            cval.append(v[p].reshape(-1))
            base += nb
    crow, ccol, cval = (np.concatenate(a) for a in (crow, ccol, cval))
    width = P * n_cols if own_x else n_cols
    real = ccol < width
    indptr = np.zeros(P * rows + 1, np.int64)
    np.cumsum(np.bincount(crow[real], minlength=P * rows), out=indptr[1:])
    order = np.argsort(crow[real], kind="stable")
    return torch.sparse_csr_tensor(  # yardstick only, never run by the port
        torch.from_numpy(indptr),
        torch.from_numpy(ccol[real][order].astype(np.int64)),
        torch.from_numpy(cval[real][order]), size=(P * rows, width),
        device=device)


def first_train_batch(ds):
    """The training stream's first batch ``(mb, feats, labels)`` at P = 16
    (the batch every training arm starts with)."""
    from repro_torch.data import GraphBatchPipeline
    from repro_torch.graph import NeighborSampler

    sampler = NeighborSampler(ds.graph, TRAIN_FANOUTS,
                              pad_multiple=TRAIN_CORES, seed=0)
    return next(GraphBatchPipeline(ds, sampler, TRAIN_BATCH))


def train_kernel_phase(torch, device, ds, item, rng):
    """Phase 5: ``spmm_ell_t`` on every transpose bucket of a real layer-1
    training plan at P = 16 (and on edge cases) against its plain version,
    its walk timed; the stacked forward walk timed against one 2-D launch
    per core.  Returns (spmm_ell_t record, detail)."""
    from repro_torch.engine import Engine
    from repro_torch.kernels import spmm_ell, spmm_ell_t
    from repro_torch.kernels.ref import spmm_ell_ref
    from repro_torch.kernels.spmm import spmm_ell_t_walk, spmm_ell_walk

    P = TRAIN_CORES
    bundle = Engine("ell+pipelined").build(n_cores=P, device=device)
    host = bundle.prepare_batch(*item)
    batch = bundle.commit_batch(host)
    n_dst1, n_src1 = batch["dims"][1]
    tables, htables = batch["edges"][1], host["edges"][1]
    detail = {"layer1": {
        "n_dst": n_dst1, "n_src": n_src1, "cores": P,
        "fwd_buckets": [list(c.shape) for c in htables["cols"]],
        "t_buckets": [list(c.shape) for c in htables["t_cols"]]}}

    # -- bit-equality at the main path's shapes: both hops' forward and
    # transpose walks (one launch per walk, as ell_apply launches them, and
    # each bucket on its own), each at the width it runs at there —
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
        rows = tab["t_walk"].total
        err[f"layer{layer}_d{d}_walk"] = max_err(
            walk_once(torch, spmm_ell_t_walk, tab["t_walk"], e),
            bucket_walk(torch, plain_out, tab, e, rows, "t_"))
        for c, v in zip(tab["t_cols"], tab["t_vals"]):
            err[f"layer{layer}_d{d}_K{c.shape[-1]}_nb{c.shape[-2]}"] = \
                max_err(spmm_ell_t(c, v, e), spmm_ell_ref(c, v, e))
        # the forward's input: each core's own rows, a nonzero core stride
        x = rand(P, n_src // P, d)
        rows = tab["walk"].total
        ferr[f"layer{layer}_d{d}_walk"] = max_err(
            walk_once(torch, spmm_ell_walk, tab["walk"], x),
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
    bw, flops, _, _ = device_peaks(torch)
    d = HIDDEN
    e = torch.from_numpy(rng.standard_normal((n_dst1, d)).astype(
        np.float32)).to(device)
    e_all = e.unsqueeze(0).expand(P, n_dst1, d)      # the all-gathered view
    t_rows = tables["t_walk"].total
    ker = time_ms(torch, lambda: walk_once(torch, spmm_ell_t_walk,
                                           tables["t_walk"], e_all))
    detail["spmm_ell_t_per_bucket_ms"] = time_ms(
        torch, lambda: bucket_walk(torch, spmm_ell_t, tables, e_all, t_rows,
                                   "t_"))
    pla = time_ms(torch, lambda: bucket_walk(torch, plain_out, tables,
                                             e_all, t_rows, "t_"))
    csr = stacked_csr(torch, htables["t_cols"], htables["t_vals"], n_dst1,
                      device)
    walk = walk_once(torch, spmm_ell_t_walk, tables["t_walk"], e_all)
    torch.testing.assert_close(torch.sparse.mm(csr, e),
                               walk.reshape(-1, d), rtol=1e-4, atol=1e-5)
    lib = time_ms(torch, lambda: torch.sparse.mm(csr, e))
    detail["spmm_ell_t_layer1_bucket_ms"] = {   # where the walk's time goes
        f"K{c.shape[-1]}_nb{c.shape[-2]}": time_ms(
            torch, lambda c=c, v=v: spmm_ell_t(c, v, e_all))
        for c, v in zip(tables["t_cols"], tables["t_vals"])}
    shape = walk_shape(htables["t_cols"], n_dst1, shared_x=True)
    bound, bound_by = walk_bound(shape, d, bw, flops)
    only = kernel_ms(torch, lambda: walk_once(
        torch, spmm_ell_t_walk, tables["t_walk"], e_all), spmm_ell_t)
    record = {"max_abs_err": worst, "ms": ker, "plain_ms": pla,
              "bound_ms": bound, "bound_by": bound_by, "library_ms": lib,
              "kernel_only_ms": only[0], "kernel_only_count": only[1],
              "host_ms": host_ms(torch, lambda: walk_once(
                  torch, spmm_ell_t_walk, tables["t_walk"], e_all)),
              "library_kernel_only_ms": queued_ms(
                  torch, lambda: torch.sparse.mm(csr, e))[0],
              "shape": dict(shape, d=d, buckets=len(tables["t_cols"]))}

    # -- the stacked forward walk in one launch vs one launch per bucket
    # and one 2-D launch per bucket and core -----------------------------
    x = torch.from_numpy(rng.standard_normal((P, n_src1 // P, d)).astype(
        np.float32)).to(device)
    f_rows = tables["walk"].total

    def per_core(c, v, xs, out):
        for p in range(P):
            spmm_ell(c[p], v[p], xs[p], out=out[p])

    stacked = walk_once(torch, spmm_ell_walk, tables["walk"], x)
    looped = bucket_walk(torch, per_core, tables, x, f_rows)
    if not torch.equal(stacked, looped):
        raise AssertionError("stacked forward walk != per-core 2-D walk")
    fshape = walk_shape(htables["cols"], n_src1 // P, shared_x=False)
    bound, bound_by = walk_bound(fshape, d, bw, flops)
    detail["spmm_ell_training_layer1_walk"] = {
        "walk_ms": time_ms(torch, lambda: walk_once(
            torch, spmm_ell_walk, tables["walk"], x)),
        "kernel_only_ms_count": kernel_ms(torch, lambda: walk_once(
            torch, spmm_ell_walk, tables["walk"], x), spmm_ell),
        "per_bucket_ms": time_ms(torch, lambda: bucket_walk(
            torch, spmm_ell, tables, x, f_rows)),
        "per_core_2d_ms": time_ms(torch, lambda: bucket_walk(
            torch, per_core, tables, x, f_rows)),
        "bound_ms": bound, "bound_by": bound_by,
        "launches_walk": 1,
        "launches_per_bucket": len(tables["cols"]),
        "launches_per_core": len(tables["cols"]) * P,
        "shape": dict(fshape, d=d)}
    return record, detail


def coo_walk_shape(out_rows, gather, vals, n_out, n_src, shared_x):
    """What one stacked COO walk (``[P, E]`` numpy arrays: output rows,
    gathered rows, weights) must touch, for its bound: the entries it adds
    (weight nonzero, both indices in range), distinct gathered rows (over
    one shared ``x``, or per core) and output rows holding an entry; the
    padded counts beside them show the padding the walk skips."""
    P = out_rows.shape[0]
    keep = (vals != 0) & (gather >= 0) & (gather < n_src) \
        & (out_rows >= 0) & (out_rows < n_out)
    if shared_x:
        distinct = len(np.unique(gather[keep]))
    else:
        distinct = sum(len(np.unique(gather[p][keep[p]])) for p in range(P))
    return {"real_entries": int(keep.sum()), "distinct_rows": int(distinct),
            "rows_with_entries": int(sum(len(np.unique(out_rows[p][keep[p]]))
                                         for p in range(P))),
            "padded_entries": int(vals.size), "padded_rows": int(P * n_out)}


def coo_csr(torch, out_rows, gather, vals, n_out, n_src, shared_x, device):
    """One CSR ``[P·n_out, n_src]`` (shared ``x``) or ``[P·n_out,
    P·n_src]`` (block-diagonal, per-core ``x``) of a stacked COO walk's
    entries, rows in walk order — the library yardstick for the walk."""
    P = out_rows.shape[0]
    keep = (vals != 0) & (gather >= 0) & (gather < n_src) \
        & (out_rows >= 0) & (out_rows < n_out)
    core = np.arange(P, dtype=np.int64).reshape(P, 1)
    grow = (out_rows.astype(np.int64) + core * n_out)[keep]
    gcol = (gather.astype(np.int64) + (0 if shared_x else core * n_src)
            + np.zeros_like(core))[keep]
    order = np.argsort(grow, kind="stable")
    indptr = np.zeros(P * n_out + 1, np.int64)
    np.cumsum(np.bincount(grow, minlength=P * n_out), out=indptr[1:])
    return torch.sparse_csr_tensor(  # yardstick only, never run by the port
        torch.from_numpy(indptr), torch.from_numpy(gcol[order]),
        torch.from_numpy(vals[keep][order]),
        size=(P * n_out, n_src if shared_x else P * n_src), device=device)


def coo_kernel_phase(torch, device, ds, item, eng_blk, w1, rng):
    """Phase 6: ``spmm_block`` and ``spmm`` against their plain versions
    (tolerance 0) on both hops of the first training batch at P = 16, as
    the ``block`` and ``coo`` training paths run them, on a serving
    ``dst_tiles`` layer and on edge cases; the block partials must equal
    the coo partials.  The deepest hop's forward (``spmm_block``) and
    transpose (``spmm``) walks are timed.  Returns (records, detail)."""
    from repro_torch.core.gcn import segment_sum_rows
    from repro_torch.engine import Engine
    from repro_torch.kernels import gemm, spmm, spmm_block
    from repro_torch.kernels.ref import spmm_block_ref, spmm_ref

    P = TRAIN_CORES
    built = {}
    for spec in ("block+pipelined", "coo+serial"):
        bundle = Engine(spec).build(n_cores=P, device=device)
        host = bundle.prepare_batch(*item)
        built[spec] = (host, bundle.commit_batch(host))
    (bhost, bb), (_, cb) = built["block+pipelined"], built["coo+serial"]
    widths = (ds.stats.n_classes, HIDDEN)
    err, unequal, detail = {}, [], {}

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    def check(key, got, want):
        err[key] = max_err(got, want)
        if not torch.equal(got, want):
            unequal.append(key)

    def block_t(t, e, spc, fn=spmm):
        """The block backward's walk: the tiles column-major."""
        flat = t["t_rows"].shape
        return fn(t["cols"].reshape(flat), t["t_rows"],
                  t["vals"].reshape(flat), e, spc, perm=t["t_perm"],
                  ptr=t["t_ptr"])

    for layer, (n_dst, n_src) in enumerate(bb["dims"]):
        d, spc, dpc = widths[layer], n_src // P, n_dst // P
        t, c = bb["edges"][layer], cb["edges"][layer]
        tag = f"layer{layer}_d{d}"
        detail[f"{tag}_shape"] = {
            "n_dst": n_dst, "n_src": n_src,
            "tiles": list(bhost["edges"][layer]["rows"].shape),
            "coo_entries": list(c["rows"].shape)}
        x = rand(P, spc, d)               # each core's own rows
        fb = spmm_block(t["rows"], t["cols"], t["vals"], x, dpc,
                        perm=t["perm"], ptr=t["ptr"])
        check(f"block_fwd_{tag}", fb, spmm_block_ref(
            t["rows"], t["cols"], t["vals"], x, dpc, t["perm"], t["ptr"]))
        check(f"block_fwd_self_grouped_{tag}", spmm_block(
            t["rows"], t["cols"], t["vals"], x, dpc), fb)
        fc = spmm(c["rows"], c["cols"], c["vals"], x, n_dst,
                  perm=c["perm"], ptr=c["ptr"])
        check(f"coo_fwd_{tag}", fc, spmm_ref(
            c["rows"], c["cols"], c["vals"], x, n_dst, c["perm"], c["ptr"]))
        check(f"block_vs_coo_fwd_{tag}", fb, fc)
        # the backward's error: one all-gathered [n_dst, d] for all cores
        e = rand(n_dst, d).unsqueeze(0).expand(P, n_dst, d)
        tb = block_t(t, e, spc)
        check(f"block_t_{tag}", tb, block_t(t, e, spc, spmm_ref))
        tc = spmm(c["cols"], c["rows"], c["vals"], e, spc,
                  perm=c["t_perm"], ptr=c["t_ptr"])
        check(f"coo_t_{tag}", tc, spmm_ref(
            c["cols"], c["rows"], c["vals"], e, spc, c["t_perm"],
            c["t_ptr"]))
        check(f"block_vs_coo_t_{tag}", tb, tc)
    # a feature wave: a unit-stride slice of a wider x, into a strided out
    n_dst, n_src = bb["dims"][1]
    t = bb["edges"][1]
    wide = rand(P, n_src // P, HIDDEN + 64)
    out = torch.full((P, n_dst, HIDDEN), 7.0, device=device)
    spmm_block(t["rows"], t["cols"], t["vals"], wide[..., 32:32 + 128],
               n_dst // P, perm=t["perm"], ptr=t["ptr"],
               out=out[..., 64:192])
    check("block_fwd_feature_wave", out[..., 64:192], spmm_block_ref(
        t["rows"], t["cols"], t["vals"], wide[..., 32:32 + 128].contiguous(),
        n_dst // P, t["perm"], t["ptr"]))
    if not (out[..., :64] == 7.0).all() or not (out[..., 192:] == 7.0).all():
        raise AssertionError("a feature-wave walk wrote outside its slice")
    # edge cases: cores, tiles, tile length, dpc, n_src, d
    edge = {"eb1_d1": (P, 4, 1, 5, 50, 1),
            "d33_empty_tiles": (P, 4, 7, 9, 60, 33),
            "P2_d256_pad_tiles": (2, 3, 64, 32, 500, HIDDEN)}
    for key, (cores, B, eb, dpc, n_src, d) in edge.items():
        rows = rng.integers(0, dpc, (cores, B, eb)).astype(np.int32)
        cols = rng.integers(0, n_src, (cores, B, eb)).astype(np.int32)
        vals = rng.standard_normal((cores, B, eb)).astype(np.float32)
        vals[:, 0] = 0.0                     # an all-padding tile
        if B > 2:
            cols[:, 1] = n_src               # padding past the range
        if eb > 2:
            vals[:, :, -2:] = 0.0            # trailing tile padding
        if cores > 3:
            vals[3] = 0.0                    # a core with no entries
        r, cc, v = (torch.from_numpy(a).to(device) for a in (rows, cols,
                                                            vals))
        x = rand(cores, n_src, d)
        got = spmm_block(r, cc, v, x, dpc)
        check(f"block_{key}", got, spmm_block_ref(r, cc, v, x, dpc))
        if got[:, :dpc].any() or (B > 2 and got[:, dpc:2 * dpc].any()):
            raise AssertionError(f"{key}: a padding-only tile is not zero")
        grows = torch.from_numpy((rows + np.arange(B).reshape(B, 1) * dpc)
                                 .reshape(cores, -1).astype(np.int32)
                                 ).to(device)
        e = rand(B * dpc, d).unsqueeze(0).expand(cores, B * dpc, d)
        flat = (cores, B * eb)
        got = spmm(cc.reshape(flat), grows, v.reshape(flat), e, n_src)
        check(f"spmm_t_{key}", got, spmm_ref(cc.reshape(flat), grows,
                                             v.reshape(flat), e, n_src))
    # one serving layer: dst_tiles of a canonical layer-1 COO, 256 wide;
    # the block walk must equal the coo layer's aggregation
    q = np.unique(rng.integers(0, eng_blk.graph.n_nodes, 8))
    coo2, f2 = eng_blk.canonical_layer(q)
    coo1, f1 = eng_blk.canonical_layer(f2)
    layout = eng_blk.engine.layout(coo1)
    x1 = torch.zeros((coo1.n_src, eng_blk.feat_dim), device=device)
    x1[:len(f1)] = torch.from_numpy(eng_blk.features[f1]).to(device)
    h1 = gemm(x1, w1)
    tab = layout.device_tables(device)
    sdpc = layout.tiles.dst_per_core
    got = spmm_block(tab["rows"], tab["cols"], tab["vals"], h1, sdpc,
                     perm=tab["perm"], ptr=tab["ptr"])
    check("serving_layer1_d256", got, spmm_block_ref(
        tab["rows"], tab["cols"], tab["vals"], h1, sdpc, tab["perm"],
        tab["ptr"]))
    check("serving_layer1_vs_coo_layer", got, segment_sum_rows(coo1, h1))
    detail["serving_layer1"] = {
        "n_dst": coo1.n_dst, "n_src": coo1.n_src, "block_tiles": BLOCK_TILES,
        "tiles": list(layout.tiles.rows.shape),
        "ms": time_ms(torch, lambda: spmm_block(
            tab["rows"], tab["cols"], tab["vals"], h1, sdpc,
            perm=tab["perm"], ptr=tab["ptr"]))}
    worst = max(err.values())
    if unequal or worst > COO_WALK_TOL:
        raise AssertionError(f"COO walks differ from their plain versions "
                             f"or from each other: "
                             f"{ {k: err[k] for k in unequal} }")
    detail["coo_walk_max_abs_err"] = err

    # -- timing: the deepest hop's forward (per-core x) and transpose
    # (shared error) walks of the block training path, d = 256 ------------
    bw, flops, _, _ = device_peaks(torch)
    n_dst, n_src = bb["dims"][1]
    spc, d = n_src // P, HIDDEN
    t, ht = bb["edges"][1], bhost["edges"][1]
    np_cols = ht["cols"].reshape(P, -1)
    np_vals = ht["vals"].reshape(P, -1)
    x = rand(P, spc, d)
    e1 = rand(n_dst, d)
    e = e1.unsqueeze(0).expand(P, n_dst, d)
    records = {}
    for name, fn, plain, csr_args, lib_x in (
            ("spmm_block",
             lambda: spmm_block(t["rows"], t["cols"], t["vals"], x,
                                n_dst // P, perm=t["perm"], ptr=t["ptr"]),
             lambda: spmm_block_ref(t["rows"], t["cols"], t["vals"], x,
                                    n_dst // P, t["perm"], t["ptr"]),
             (ht["t_rows"], np_cols, np_vals, n_dst, spc, False),
             x.reshape(P * spc, d)),
            ("spmm", lambda: block_t(t, e, spc),
             lambda: block_t(t, e, spc, spmm_ref),
             (np_cols, ht["t_rows"], np_vals, spc, n_dst, True), e1)):
        shape = coo_walk_shape(*csr_args)
        csr = coo_csr(torch, *csr_args, device)
        lib_out = torch.sparse.mm(csr, lib_x)
        torch.testing.assert_close(lib_out, fn().reshape(lib_out.shape),
                                   rtol=1e-4, atol=1e-5)
        bound, bound_by = walk_bound(shape, d, bw, flops, entry_bytes=12)
        records[name] = {
            "max_abs_err": worst, "ms": time_ms(torch, fn),
            "plain_ms": time_ms(torch, plain), "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": time_ms(torch, lambda: torch.sparse.mm(csr,
                                                                 lib_x)),
            "shape": dict(shape, d=d, n_dst=n_dst, n_src=n_src)}
        records[name]["kernel_only_ms"], records[name][
            "kernel_only_count"] = kernel_ms(
                torch, fn, spmm_block if name == "spmm_block" else spmm)
        records[name]["host_ms"] = host_ms(torch, fn)
        records[name]["library_kernel_only_ms"] = queued_ms(
            torch, lambda: torch.sparse.mm(csr, lib_x))[0]
    detail["spmm_coo_layer1_fwd_ms"] = time_ms(torch, lambda: spmm(
        cb["edges"][1]["rows"], cb["edges"][1]["cols"],
        cb["edges"][1]["vals"], x, n_dst, perm=cb["edges"][1]["perm"],
        ptr=cb["edges"][1]["ptr"]))
    return records, detail


def train_arm(torch, spec, trainer, device, params):
    """One spec's training run on the card from the seeded checkpoint: 3
    warm-up and 20 measured steps (a checkpoint saved at step 10), the host
    half of a step split with the producer stopped, the device step split
    at the loss, the busy share; then a resume from step 10 replaying steps
    11-20 and the port's CPU run of the first 5 steps.  Every call into a
    trainer is counted on its own (:func:`counted`)."""
    fmt = spec.split("+")[0]
    walks = FORMAT_WALKS[fmt]
    zero = dict.fromkeys(KERNELS, 0)
    launches = dict(zero)
    tr = trainer(spec, "card", input_pipeline="prefetch", device=device)
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
        others = [k for k in ("spmm_ell", "spmm_ell_t", "spmm_block",
                              "spmm") if k not in walks and counts[k]]
        if any(counts[k] <= 0 for k in walks) or others:
            raise AssertionError(f"{spec} step {i + 1} launched {counts}, "
                                 f"not its own walks {walks}")
        per_step.append(counts)
        for k in zero:
            launches[k] += counts[k]
    stall_ms = tr.stall_per_step * 1e3
    place_ms = tr.place_per_step * 1e3
    measured = step_ms[WARMUP_STEPS:]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{spec}: non-finite losses {losses}")

    tr.fetcher.close()
    host, batch = host_split(torch, tr)
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
    busy, busy_records = device_busy(torch, tr, 3)
    tr.close()

    # checkpoint at step 10 + resume: steps 11-20 again
    resumed = trainer(spec, "card", input_pipeline="prefetch", device=device)
    if resumed.global_step != CKPT_STEP:
        raise AssertionError(f"{spec} resumed at step {resumed.global_step}")
    again = counted(launches, resumed.train_steps, 10)
    resumed.close()
    drift = float(np.abs(np.asarray(again)
                         - np.asarray(losses[CKPT_STEP:CKPT_STEP + 10])).max())
    if drift > RESUME_TOL:
        raise AssertionError(f"{spec} resume drift {drift} > {RESUME_TOL}")

    # the same 5 steps on the CPU with the plain kernel versions
    cpu = trainer(spec, "cpu", input_pipeline="sync", device="cpu")
    cpu_losses = cpu.train_steps(5)
    cpu.close()
    cpu_diff = float(np.abs(np.asarray(cpu_losses)
                            - np.asarray(losses[:5])).max())
    if cpu_diff > LOSS_TOL:
        raise AssertionError(f"{spec}: card vs CPU losses differ by "
                             f"{cpu_diff}")
    n_steps = WARMUP_STEPS + MEASURED_STEPS
    return {
        "losses": losses, "resumed_losses_11_20": again,
        "cpu_losses": cpu_losses, "resume_drift": drift,
        "card_vs_cpu_max_abs": cpu_diff,
        "ms_per_step_median": float(np.median(measured)),
        "steps_per_s": len(measured) / (sum(measured) / 1e3),
        "host_stall_ms_per_step": stall_ms,
        "place_ms_per_step": place_ms,
        "host_batch_ms": host,
        "device_fwd_ms": float(np.median(fwd)),
        "device_bwd_ms": float(np.median(bwd)),
        "device_busy_share": busy,
        "device_busy_records": busy_records,
        "step_ms": step_ms,
        "launches": launches,
        "launches_per_step": {k: sum(c[k] for c in per_step) / n_steps
                              for k in zero},
        "launches_each_step": per_step,
    }


def host_split(torch, tr, n_batches=3):
    """The host half of a step, with the producer thread stopped so nothing
    contends for the interpreter (median of ``n_batches`` batches):
    sampling + feature gather (for a store-backed Trainer the sampling
    alone, and the store gather through its cache as ``gather_ms``), the
    partition's relabeling
    (``_apply_partition``; 0 for ``naive``), the edge tables (ELL tables,
    or tiles and their groupings), the batch's plan report
    (``_plan_report``: ``exchange_rows`` per hop) and placement on the
    card.  The relabeling and the report are timed inside
    ``prepare_batch`` by wrapping the bundle's two methods; the tables are
    the rest of it.  Returns (the split, the last batch on the card)."""
    bundle = tr.bundle
    host = {k: [] for k in ("sample_ms", "relabel_ms", "tables_ms",
                            "report_ms", "place_ms")}
    if tr.store is not None:
        host["gather_ms"] = []
    spent = {}

    def timed(key, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent[key] = (time.perf_counter() - t0) * 1e3
            return out
        return run

    bundle._apply_partition = timed("relabel_ms", bundle._apply_partition)
    bundle._plan_report = timed("report_ms", bundle._plan_report)
    try:
        for _ in range(n_batches):
            t0 = time.perf_counter()
            item = next(tr.pipeline)
            tg = time.perf_counter()
            if tr.store is not None:     # (mb, labels): gather on its own
                item = tr._gather_stage(*item)
                host["gather_ms"].append((time.perf_counter() - tg) * 1e3)
            t1 = time.perf_counter()
            host_batch = bundle.prepare_batch(*item)
            t2 = time.perf_counter()
            batch = bundle.commit_batch(host_batch)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            host["sample_ms"].append((tg - t0) * 1e3)
            host["relabel_ms"].append(spent["relabel_ms"])
            host["report_ms"].append(spent["report_ms"])
            host["tables_ms"].append((t2 - t1) * 1e3 - spent["relabel_ms"]
                                     - spent["report_ms"])
            host["place_ms"].append((t3 - t2) * 1e3)
    finally:
        del bundle._apply_partition, bundle._plan_report
    return {k: float(np.median(v)) for k, v in host.items()}, batch


def coo_determinism(torch, trainer_coo, item, rng):
    """The same batch through ``coo+serial`` twice on the card: the loss,
    the weight gradients, and the deepest hop's raw aggregate and its
    input gradient must be equal bits (the flat ``spmm`` walk adds in a
    fixed order; the ``index_add_`` it replaced added atomically)."""
    bundle = trainer_coo.bundle
    batch = bundle.shard_batch(*item)
    n_dst, n_src = batch["dims"][1]
    P = bundle.n_cores
    h0 = torch.from_numpy(rng.standard_normal(
        (P, n_src // P, HIDDEN)).astype(np.float32)).to(bundle.device)
    g = torch.from_numpy(rng.standard_normal(
        (P, n_dst // P, HIDDEN)).astype(np.float32)).to(bundle.device)
    runs = []
    for _ in range(2):
        ws = [p["w"].detach().requires_grad_(True)
              for p in trainer_coo.params]
        loss = bundle.loss([{"w": w} for w in ws], batch)
        grads = torch.autograd.grad(loss, ws)
        h = h0.clone().requires_grad_(True)
        y = bundle._aggregate(n_dst, batch["edges"][1], h)
        (y * g).sum().backward()
        runs.append([loss.detach(), *grads, y.detach(), h.grad])
    names = ["loss", "grad_w0", "grad_w1", "aggregate", "aggregate_grad"]
    same = {n: bool(torch.equal(a, b))
            for n, a, b in zip(names, *runs)}
    if not all(same.values()):
        raise AssertionError(f"coo+serial is not deterministic: {same}")
    return same


def train_params(ds):
    """The seeded weights every training arm starts from (phases 7, 10)."""
    return seeded_params(1, (ds.stats.feat_dim, HIDDEN, ds.stats.n_classes))


def seeded_trainer(ds, params, spec, tag=""):
    """A factory ``trainer(spec, which, **kw)`` of training-phase Trainers
    that resume a fresh step-0 checkpoint of ``params`` (one directory per
    ``spec``, ``tag`` and ``which``, ``"card"`` or ``"cpu"``); ``spec`` may
    be an ``EngineConfig``."""
    from repro_torch.launch.trainer import Trainer

    extra = {"step": 0, "epochs_done": 0,
             "pipeline": {"seed": 0, "epoch": 0, "batch_idx": 0}}
    key = getattr(spec, "spec", spec).replace("+", "_")
    if getattr(spec, "merge", "dedup") != "dedup":
        key += "_" + spec.merge
    if tag:
        key += "_" + tag
    dirs = {k: os.path.join(OUT_DIR, f"chip_smoke_train_{key}_{k}")
            for k in ("card", "cpu")}
    for path in dirs.values():
        write_checkpoint(path, params, extra=extra)

    def trainer(spec_, which, **kw):
        tr = Trainer(spec_, ds, n_cores=TRAIN_CORES, hidden=HIDDEN,
                     batch_size=TRAIN_BATCH, fanouts=TRAIN_FANOUTS,
                     seed=0, ckpt_dir=dirs[which], ckpt_every=0, **kw)
        if not tr.resume():
            raise AssertionError(f"no checkpoint under {dirs[which]}")
        return tr
    return trainer


def train_phase(torch, ds, device, item, rng):
    """Phase 7: train gcn-reddit on the card through the Trainer, from a
    seeded checkpoint: the ``ell+pipelined`` and ``block+pipelined`` arms
    (:func:`train_arm`), then ``coo+serial`` for 5 steps — within 1e-4 of
    ell, equal bits to block, launching the flat ``spmm`` walk and no ELL
    kernel — and the coo determinism check."""
    params = train_params(ds)

    def trainer_for(spec):
        return seeded_trainer(ds, params, spec)

    out = {}
    for spec in TRAIN_SPECS:
        t0 = time.perf_counter()
        out[spec] = train_arm(torch, spec, trainer_for(spec), device, params)
        out[spec]["phase_s"] = time.perf_counter() - t0

    # the coo+serial oracle on the card: 5 steps, the flat spmm walk only
    t0 = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)
    coo = trainer_for("coo+serial")("coo+serial", "card",
                                    input_pipeline="prefetch", device=device)
    coo_losses = counted(launches, coo.train_steps, COO_STEPS)
    coo.close()
    if launches["spmm"] <= 0 or launches["spmm_ell"] \
            or launches["spmm_ell_t"] or launches["spmm_block"]:
        raise AssertionError(f"coo+serial launched {launches}")
    ell = out["ell+pipelined"]["losses"][:COO_STEPS]
    blk = out["block+pipelined"]["losses"][:COO_STEPS]
    coo_vs_ell = float(np.abs(np.asarray(coo_losses)
                              - np.asarray(ell)).max())
    if coo_vs_ell > LOSS_TOL:
        raise AssertionError(f"coo+serial vs ell losses differ by "
                             f"{coo_vs_ell}")
    if coo_losses != blk:
        raise AssertionError(f"block losses {blk} != coo+serial losses "
                             f"{coo_losses}")
    same = coo_determinism(torch, coo, item, rng)
    out["coo+serial"] = {"losses": coo_losses, "launches": launches,
                         "launches_per_step": {k: v / COO_STEPS
                                               for k, v in launches.items()},
                         "coo_vs_ell_max_abs": coo_vs_ell,
                         "block_equals_coo": True,
                         "deterministic": same,
                         "phase_s": time.perf_counter() - t0}
    return out


def device_busy(torch, tr, n_steps):
    """Share of ``n_steps`` training steps' wall time the card spent in
    kernels: the device time of ``torch.profiler``'s CUDA records (the ops
    that launched them are not counted again) over the host clock, read
    after the profiler's warm-up step of ``n_steps`` more steps; and the
    count of those records."""
    events, wall_s = profiled(torch, lambda: tr.train_steps(n_steps))
    ms, count = device_records(events)
    return ms / (wall_s * 1e3), count


# ---------------------------------------------------------------------------
# Phase 8: the paper's GCN model and its Table-1 arms (single device).
# ---------------------------------------------------------------------------
def paper_shapes(item, cfg):
    """The §4.4 ``LayerShape`` of each hop of the first training batch, as
    ``launch.train._estimator_orders`` builds them (``item`` is that batch:
    the same sampler seed, padding and batch size)."""
    from repro_torch.core.estimator import LayerShape

    layers = item[0].layers
    return [LayerShape(b=TRAIN_BATCH, n=l.n_dst, nbar=l.n_src,
                       d=cfg.feat_dim if i == len(layers) - 1 else cfg.hidden,
                       h=cfg.n_classes if i == 0 else cfg.hidden,
                       e=l.nnz, c=cfg.n_classes)
            for i, l in enumerate(layers)]


def paper_launches(orders, model):
    """Launches one training step of the single-device loop implies, per
    kernel.  Every layer's forward combination is one ``gemm`` (SAGE's
    root path one more); the backward's ``Aᵀ`` walk is one flat ``spmm``
    when CoAg (its ``S`` feeds ``dW``) or when the layer's input takes a
    gradient (AgCo's walk only makes ``dX``, and the deepest layer's input
    is the raw features).  No other kernel runs."""
    want = dict.fromkeys(KERNELS, 0)
    deepest = len(orders) - 1
    for l, order in enumerate(orders):
        want["gemm"] += 2 if model == "sage" else 1
        want["spmm"] += int(order == "coag" or l != deepest)
    return want


def residual_sum(shapes, orders, dataflow):
    """Σ over the layers of ``residual_bytes`` (ours) or
    ``residual_bytes_naive`` at this batch's shapes."""
    from repro_torch.core import residual_bytes, residual_bytes_naive

    total = 0
    for s, order in zip(shapes, orders):
        dims = dict(n_dst=s.n, n_src=s.nbar, d=s.d, h=s.h)
        total += residual_bytes(order, **dims) if dataflow == "ours" \
            else residual_bytes_naive(order, nnz=s.e, **dims)
    return total


def paper_entry(torch, tds, arm, device):
    """One arm through the port's entry point for ``PAPER_STEPS`` steps:
    ``train_gcn`` for the naive and sage arms; the ours/gcn arm is the
    same single-device loop (``_train_gcn_reference``), which
    ``train_gcn`` keeps for the reference arms."""
    from repro_torch.launch import train

    model, dataflow = PAPER_ARMS[arm]
    kw = dict(model=model, dataflow=dataflow, batch_size=TRAIN_BATCH,
              steps=PAPER_STEPS, lr=PAPER_LR, hidden=HIDDEN, seed=0,
              log_every=0, device=device)
    if arm == "ours":
        return train._train_gcn_reference(
            tds, scale=TRAIN_SCALE, feat_dim=None, ckpt_dir=None,
            resume=False, **kw)
    return train.train_gcn(tds, **kw)


def paper_recorded(torch, counts, tds, arm, device):
    """:func:`paper_entry` on the card, counted into ``counts``, with
    ``launch.train``'s ``train_step`` and ``gcn_loss`` wrapped for the run:
    per step the host ms of ``train_step`` (to its loss on the host; the
    batch is sampled and placed before it) and of the loop (one step's
    start to the next's, sampling included), the launches it made, the peak
    device memory above the step's start, and the bytes the forward keeps
    for the backward (``memory_allocated`` after the loss, before the
    backward, above the step's start).  Then the device time of one step on
    the first batch with the trained weights: CUDA events split at the loss
    (median of 3), and the profiler's kernel time of one more step.
    Returns ``(entry result, record)``."""
    from repro_torch.launch import train
    from repro_torch.optim import tree_leaves, tree_map

    kernels = launch_counters()
    steps, first = [], []
    train_step, gcn_loss = train.train_step, train.gcn_loss

    def loss_kept(*args, **kwargs):
        loss = gcn_loss(*args, **kwargs)
        steps[-1]["kept"] = torch.cuda.memory_allocated() - steps[-1]["start"]
        return loss

    def step_recorded(params, opt_state, update, layers, x, labels, cfg,
                      orders, n_valid):
        if not first:
            first.append((layers, x, labels, cfg, orders, n_valid))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"start": torch.cuda.memory_allocated()}
        steps.append(rec)
        before = launch_totals(kernels)
        rec["t0"] = time.perf_counter()
        out = train_step(params, opt_state, update, layers, x, labels, cfg,
                         orders, n_valid)
        float(out[2])                                  # syncs
        rec["ms"] = (time.perf_counter() - rec["t0"]) * 1e3
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["launches"] = {n: c - before[n]
                           for n, c in launch_totals(kernels).items()}
        return out

    train.train_step, train.gcn_loss = step_recorded, loss_kept
    try:
        card = counted(counts, paper_entry, torch, tds, arm, device)
    finally:
        train.train_step, train.gcn_loss = train_step, gcn_loss
    layers, x, y, cfg, orders, n_valid = first[0]
    params = card["params"]

    def step():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = gcn_loss(live, layers, x, y, cfg, orders, n_valid=n_valid)
        return loss, tree_leaves(live)

    fwd, bwd = [], []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss, leaves = step()
        ev[1].record()
        torch.autograd.grad(loss, leaves)
        ev[2].record()
        ev[2].synchronize()
        fwd.append(ev[0].elapsed_time(ev[1]))
        bwd.append(ev[1].elapsed_time(ev[2]))
    events, wall_s = profiled(torch, lambda: torch.autograd.grad(*step()))
    busy_ms, records = device_records(events)
    measured = steps[PAPER_WARMUP:]
    loop_ms = [(b["t0"] - a["t0"]) * 1e3 for a, b in zip(measured,
                                                         measured[1:])]
    return card, {
        "step_ms": [r["ms"] for r in steps],
        "ms_per_step_median": float(np.median([r["ms"] for r in measured])),
        "loop_ms_per_step_median": float(np.median(loop_ms)),
        "device_fwd_ms": float(np.median(fwd)),
        "device_bwd_ms": float(np.median(bwd)),
        "device_kernel_ms": busy_ms, "device_kernel_records": records,
        "device_busy_share": busy_ms / (wall_s * 1e3),
        "peak_bytes": max(r["peak"] for r in measured),
        "peak_above_start_bytes": max(r["peak"] - r["start"]
                                      for r in measured),
        "kept_for_backward_bytes": max(r["kept"] for r in measured),
        "kept_each_step": [r["kept"] for r in steps],
        "launches_each_step": [r["launches"] for r in steps]}


def uma_phase(torch, device, item, rng):
    """UMA (receiver shards, the raw features gathered to every core) against
    the hypercube aggregate (sender shards, pre-reduced partial rows folded)
    on the first batch's two hops at P = ``TRAIN_CORES``: the deepest hop at
    the feature width, the other at the hidden width.  Forward within the
    reference's 2e-4, both timed (CUDA events, median of ``REPS``); the
    bytes each core receives: ``n_src·(1 − 1/P)`` raw rows against
    ``n_dst·(1 − 1/P)`` pre-reduced ones."""
    from repro_torch.distributed import aggregate as agg

    P = TRAIN_CORES
    widths = {len(item[0].layers) - 1: item[1].shape[1], 0: HIDDEN}
    out, launches = {}, dict.fromkeys(KERNELS, 0)
    for layer, d in sorted(widths.items(), reverse=True):
        coo = item[0].layers[layer]
        sender = {k: torch.from_numpy(v).to(device) for k, v in
                  agg.shard_leaves(agg.shard_edges(coo, P)).items()}
        es = agg.shard_edges_by_dst(coo, P)
        recv = {k: torch.from_numpy(v).to(device)
                for k, v in agg.uma_leaves(es).items()}
        x = torch.from_numpy(rng.standard_normal(
            (P, coo.n_src // P, d)).astype(np.float32)).to(device)

        def hyper():
            return agg.hypercube_aggregate(
                coo.n_dst, sender["rows"], sender["cols"], sender["vals"], x,
                groups=sender)

        def uma():
            return agg.uma_aggregate(coo.n_dst, recv["rows"], recv["cols"],
                                     recv["vals"], x, groups=recv)

        with torch.no_grad():
            y_h = hyper()
            y_u = counted(launches, uma)
            err = float((y_u - y_h).abs().max())
            if not torch.allclose(y_u, y_h, rtol=UMA_TOL, atol=UMA_TOL):
                raise AssertionError(f"UMA vs hypercube on hop {layer}: "
                                     f"max |diff| {err}")
            hyper_ms, uma_ms = time_ms(torch, hyper), time_ms(torch, uma)
        raw = int(coo.n_src * (1 - 1 / P)) * d * 4
        pre = int(coo.n_dst * (1 - 1 / P)) * d * 4
        out[f"hop{layer}"] = {
            "n_dst": coo.n_dst, "n_src": coo.n_src, "d": d,
            "max_abs_err": err, "hypercube_ms": hyper_ms, "uma_ms": uma_ms,
            "raw_bytes_per_core": raw, "prereduced_bytes_per_core": pre,
            "raw_over_prereduced": raw / max(pre, 1)}
    if launches["spmm"] != len(widths):
        raise AssertionError(f"UMA launched {launches}, expected one spmm "
                             "per hop")
    return out, launches


def paper_kernels(torch, device, item, n_classes, rng):
    """The two kernels of phase 8's path at the shapes the first batch gives
    them (AgCo on both layers): ``gemm`` for layer 1's ``(A X) W``
    (``[n₁, 602] @ [602, 256]``) and layer 0's (``[n₀, 256] @ [256, 41]``)
    against the plain sum in K order within (1e-4, 1e-5), and the flat
    ``spmm`` walk of layer 0's ``Aᵀ`` (the backward's ``dX``, 256 wide)
    bit-equal to its plain version.  Each is timed by CUDA events (median
    of ``REPS``), kernel only (``REPS`` calls queued behind a spin, the
    launches gated), against its plain version, one library call
    (``torch.matmul``; ``torch.sparse.mm`` over a CSR of ``Aᵀ``) and its
    bound."""
    from repro_torch.core.gcn import _col_grouping, segment_sum_rows
    from repro_torch.kernels import gemm, spmm
    from repro_torch.kernels.ref import gemm_ref, spmm_ref

    bw, flops, _, _ = device_peaks(torch)
    mb, feats, _ = item
    a1, a0 = mb.layers[1], mb.layers[0]
    w1, w0 = (torch.from_numpy(w["w"]).to(device) for w in seeded_params(
        2, (feats.shape[1], HIDDEN, n_classes)))
    ax1 = segment_sum_rows(a1, torch.from_numpy(feats).to(device))
    ax0 = segment_sum_rows(a0, torch.relu(gemm(ax1, w1)))
    out = {}
    for key, (x, w) in {"gemm_layer1": (ax1, w1),
                        "gemm_layer0": (ax0, w0)}.items():
        got, want = gemm(x, w), gemm_ref(x, w)
        torch.testing.assert_close(got, want, rtol=GEMM_RTOL, atol=GEMM_ATOL)
        m, k = x.shape
        n = w.shape[1]
        gbytes, gops = (m * k + k * n + m * n) * 4, 2 * m * n * k
        out[key] = {
            "m": m, "k": k, "n": n, "max_abs_err": max_err(got, want),
            "ms": time_ms(torch, lambda: gemm(x, w)),
            "kernel_only_ms": kernel_ms(torch, lambda: gemm(x, w), gemm)[0],
            "plain_ms": time_ms(torch, lambda: gemm_ref(x, w)),
            "library_ms": time_ms(torch, lambda: torch.matmul(x, w)),
            "library_kernel_only_ms": queued_ms(
                torch, lambda: torch.matmul(x, w))[0],
            "bound_ms": max(gbytes / bw, gops / flops) * 1e3,
            "bound_by": "bytes" if gbytes / bw >= gops / flops
            else "operations"}
    # layer 0's Aᵀ walk, as _spmm_t runs it (the tables placed once here)
    perm, ptr = (t.to(device) for t in _col_grouping(a0))
    rows, cols, vals = (t.to(device) for t in (a0.rows, a0.cols, a0.vals))
    e = torch.from_numpy(rng.standard_normal(
        (a0.n_dst, HIDDEN)).astype(np.float32)).to(device)

    def walk():
        return spmm(cols, rows, vals, e, a0.n_src, perm=perm, ptr=ptr)

    got = walk()
    want = spmm_ref(cols, rows, vals, e, a0.n_src)
    if max_err(got, want) > COO_WALK_TOL:
        raise AssertionError(f"layer-0 Aᵀ walk differs from its plain "
                             f"version by {max_err(got, want)}")
    np_rows, np_cols, np_vals = (t.numpy()[None] for t in (a0.rows, a0.cols,
                                                           a0.vals))
    shape = coo_walk_shape(np_cols, np_rows, np_vals, a0.n_src, a0.n_dst,
                           True)
    csr = coo_csr(torch, np_cols, np_rows, np_vals, a0.n_src, a0.n_dst, True,
                  device)
    bound, bound_by = walk_bound(shape, HIDDEN, bw, flops, entry_bytes=12)
    out["spmm_t_layer0"] = {
        "n_out": a0.n_src, "d": HIDDEN, **shape,
        "max_abs_err": max_err(got, want),
        "ms": time_ms(torch, walk),
        "kernel_only_ms": kernel_ms(torch, walk, spmm)[0],
        "plain_ms": time_ms(torch, lambda: spmm_ref(
            cols, rows, vals, e, a0.n_src, perm, ptr)),
        "library_ms": time_ms(torch, lambda: torch.sparse.mm(csr, e)),
        "library_kernel_only_ms": queued_ms(
            torch, lambda: torch.sparse.mm(csr, e))[0],
        "bound_ms": bound, "bound_by": bound_by}
    return out


def paper_model_phase(torch, device, tds, item, rng):
    """Phase 8: the paper's GCN model on gcn-reddit at full width
    (602 → 256 → 41), single device.  (a) The estimator's shapes and
    orders of the first batch, equal for ours and naive; (b) three arms —
    naive, sage and ours/gcn — for ``PAPER_STEPS`` steps through the entry
    point, the same weights and batches, on the card and on the CPU:
    naive within the reference's (1e-4, 1e-5) of ours, card within
    ``LOSS_TOL`` of the CPU; (c) per arm the entry run's steps as
    :func:`paper_recorded` reads them; (d) its launches per step gated at
    :func:`paper_launches`, and the two kernels held against their plain
    versions at the path's shapes (:func:`paper_kernels`); (e)
    :func:`uma_phase`."""
    from repro_torch.configs.gcn_paper import gcn_config
    from repro_torch.models.gcn_model import pick_orders

    cfgs = {d: gcn_config(DATASET, "gcn", d) for d in ("ours", "naive")}
    cfgs = {d: type(c)(**{**c.__dict__, "hidden": HIDDEN})
            for d, c in cfgs.items()}
    shapes = paper_shapes(item, cfgs["ours"])
    orders = {d: pick_orders(c, shapes) for d, c in cfgs.items()}
    if orders["ours"] != orders["naive"]:
        raise AssertionError(f"the estimator picks {orders['ours']} for ours "
                             f"and {orders['naive']} for naive")
    out = {"shapes": [vars(s) for s in shapes], "orders": orders["ours"],
           "arms": {}}
    launches = {}
    for arm in PAPER_ARMS:
        model, dataflow = PAPER_ARMS[arm]
        t0 = time.perf_counter()
        counts = dict.fromkeys(KERNELS, 0)
        card, rec = paper_recorded(torch, counts, tds, arm, device)
        if card["orders"] != orders["ours"]:
            raise AssertionError(f"paper {arm}: train_gcn reports orders "
                                 f"{card['orders']}, the first batch "
                                 f"{orders['ours']}")
        want = paper_launches(card["orders"], model)
        if counts != {k: v * PAPER_STEPS for k, v in want.items()}:
            raise AssertionError(f"paper {arm}: {PAPER_STEPS} steps launched "
                                 f"{counts}, expected {want} a step")
        launches[arm] = counts
        for i, got in enumerate(rec["launches_each_step"]):
            if got != want:
                raise AssertionError(f"paper {arm} step {i}: launched {got},"
                                     f" expected {want}")
        cpu = paper_entry(torch, tds, arm, "cpu")
        losses = np.asarray(card["loss_history"])
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"paper {arm}: non-finite losses {losses}")
        rec["card_vs_cpu_max_abs"] = float(np.abs(
            losses - np.asarray(cpu["loss_history"])).max())
        if rec["card_vs_cpu_max_abs"] > LOSS_TOL:
            raise AssertionError(f"paper {arm}: card vs CPU losses differ by "
                                 f"{rec['card_vs_cpu_max_abs']}")
        rec.update(losses=card["loss_history"],
                   cpu_losses=cpu["loss_history"],
                   launches_per_step=want,
                   residual_bytes=residual_sum(shapes, card["orders"],
                                               dataflow),
                   phase_s=time.perf_counter() - t0)
        out["arms"][arm] = rec
    ours = np.asarray(out["arms"]["ours"]["losses"])
    naive = np.asarray(out["arms"]["naive"]["losses"])
    if not np.allclose(naive, ours, rtol=NAIVE_RTOL, atol=NAIVE_ATOL):
        raise AssertionError(f"naive losses {naive.tolist()} differ from "
                             f"ours {ours.tolist()}")
    out["naive_vs_ours_max_abs"] = float(np.abs(naive - ours).max())
    out["kernels"] = paper_kernels(torch, device, item,
                                   cfgs["ours"].n_classes, rng)
    out["uma"], launches["uma"] = uma_phase(torch, device, item, rng)
    return out, launches


# ---------------------------------------------------------------------------
# Phase 10: the Engine's other axes — ring / allpairs / torus2d, the
# redundancy tier's pre-pass walks, the mincom partition (after phase 8, on
# its training data).
# ---------------------------------------------------------------------------
def agg_and_grad(torch, bundle, coo, x, g):
    """``EngineBundle.aggregate`` of ``x`` over ``coo`` and the gradient of
    ``sum(y * g)`` with respect to ``x``."""
    xt = x.detach().requires_grad_(True)
    y = bundle.aggregate(xt, coo)
    (dx,) = torch.autograd.grad((y * g).sum(), xt)
    return y.detach(), dx


def check_walks(counts, fmt, what):
    """``fmt``'s walks (:data:`FORMAT_WALKS`) launched, no other walk."""
    walks = FORMAT_WALKS[fmt.split("+")[0]]
    others = [k for k in ("spmm_ell", "spmm_ell_t", "spmm_block", "spmm")
              if k not in walks and counts.get(k)]
    if any(counts.get(k, 0) <= 0 for k in walks) or others:
        raise AssertionError(f"{what} launched {counts}, not its own walks "
                             f"{walks}")


def topology_aggregates(torch, device, item, widths, rng):
    """(a) Both hops of the first batch at their path widths through
    ``EngineBundle.aggregate`` and its gradient, for every format on ring,
    allpairs and torus2d, against the same format on the hypercube
    (``AXES_TOL``); at hop 1 each topology's ``ExchangePlan`` beside its
    event ms of forward + backward.  Returns (records, launches by
    format)."""
    from repro_torch.engine import Engine
    from repro_torch.graph.partition import exchange_rows

    P = TRAIN_CORES
    out, launches = {}, {}
    for fmt in AXES_FORMATS:
        launches[fmt] = dict.fromkeys(KERNELS, 0)
        for hop, coo in enumerate(item[0].layers):
            d = widths[hop]
            x, g = (torch.from_numpy(rng.standard_normal((n, d)).astype(
                np.float32)).to(device) for n in (coo.n_src, coo.n_dst))
            res, bundles = {}, {}
            for topo in ("hypercube",) + AXES_TOPOLOGIES:
                bundles[topo] = Engine(f"{fmt}+{topo}").build(P,
                                                              device=device)
                counts = {}
                res[topo] = counted(counts, agg_and_grad, torch,
                                    bundles[topo], coo, x, g)
                check_walks(counts, fmt, f"{fmt}+{topo} hop {hop}")
                for k, n in counts.items():
                    launches[fmt][k] += n
            wire = exchange_rows(np.asarray(coo.rows), np.asarray(coo.cols),
                                 np.asarray(coo.vals), coo.n_dst, coo.n_src,
                                 P)
            for topo, bundle in bundles.items():
                rec = {"d": d}
                if topo != "hypercube":
                    y_err, g_err = (max_err(a, b) for a, b in zip(
                        res[topo], res["hypercube"]))
                    rec.update(max_abs_err=max(y_err, g_err),
                               grad_max_abs_err=g_err)
                    if rec["max_abs_err"] > AXES_TOL:
                        raise AssertionError(
                            f"{fmt}+{topo} hop {hop}: {rec['max_abs_err']}"
                            f" from the hypercube > {AXES_TOL}")
                if hop == 1:
                    plan = bundle.topology.plan(coo.n_dst, d, P)
                    rec.update(
                        steps=plan.steps, bytes_per_core=plan.bytes_per_core,
                        wire_bytes_per_core=bundle.topology.plan(
                            coo.n_dst, d, P, wire_rows=wire).bytes_per_core,
                        max_step_rows=plan.max_step_rows,
                        link_parallelism=plan.link_parallelism,
                        fwd_bwd_ms=time_ms(torch, lambda b=bundle: agg_and_grad(
                            torch, b, coo, x, g)))
                out[f"{fmt}+{topo} hop{hop}"] = rec
    return out, launches


def topology_arm(torch, spec, trainer, device, base_losses):
    """(b) One topology's Trainer arm from the seeded checkpoint:
    ``AXES_WARMUP`` + ``AXES_STEPS`` steps on the card, each counted; the
    first 5 losses within ``LOSS_TOL`` of phase 7's hypercube arm of the
    format, the first ``AXES_CPU_STEPS`` within ``LOSS_TOL`` of the port's
    CPU run of the same spec."""
    tr = trainer(spec, "card", input_pipeline="prefetch", device=device)
    losses, step_ms, per_step = [], [], []
    for i in range(AXES_WARMUP + AXES_STEPS):
        if i == AXES_WARMUP:
            tr.reset_stall_stats()
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += counted(counts, tr.train_steps, 1)    # float(loss) syncs
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check_walks(counts, spec, f"{spec} step {i + 1}")
        per_step.append(counts)
    stall_ms = tr.stall_per_step * 1e3
    tr.close()
    diff = float(np.abs(np.asarray(losses[:5])
                        - np.asarray(base_losses[:5])).max())
    if not np.all(np.isfinite(losses)) or diff > LOSS_TOL:
        raise AssertionError(f"{spec}: losses {losses[:5]} vs the "
                             f"hypercube's {base_losses[:5]} ({diff})")
    cpu = trainer(spec, "cpu", input_pipeline="sync", device="cpu")
    cpu_losses = cpu.train_steps(AXES_CPU_STEPS)
    cpu.close()
    cpu_diff = float(np.abs(np.asarray(cpu_losses)
                            - np.asarray(losses[:AXES_CPU_STEPS])).max())
    if cpu_diff > LOSS_TOL:
        raise AssertionError(f"{spec}: card vs CPU losses differ by "
                             f"{cpu_diff}")
    n = len(per_step)
    return {"losses": losses, "cpu_losses": cpu_losses,
            "vs_hypercube_max_abs": diff, "card_vs_cpu_max_abs": cpu_diff,
            "ms_per_step_median": float(np.median(step_ms[AXES_WARMUP:])),
            "host_stall_ms_per_step": stall_ms, "step_ms": step_ms,
            "launches": {k: sum(c.get(k, 0) for c in per_step)
                         for k in KERNELS},
            "launches_per_step": {k: sum(c.get(k, 0) for c in per_step) / n
                                  for k in KERNELS}}


def prepass_records(torch, device, host, batch, widths, rng):
    """The pre-pass walks of one prepared batch on their own, at the hop
    with the most virtual vertices: the ``vv`` walk (``spmm_ell``, each
    core reading its own ``[spc, d]`` rows) and the ``vvt`` walk
    (``spmm_ell_t``, each core reading its own virtual cotangent rows, a
    strided slice of the extended ``[P, spc + n_vv_pad, d]``): bit-equal to
    the plain version, timed against it, the bound and ``torch.sparse.mm``
    over one block-diagonal CSR."""
    from repro_torch.kernels import spmm_ell, spmm_ell_t
    from repro_torch.kernels.spmm import spmm_ell_t_walk, spmm_ell_walk

    bw, flops, _, _ = device_peaks(torch)
    hops = [l for l, e in enumerate(host["edges"]) if "vv_cols" in e]
    hop = max(hops, key=lambda l: host["edges"][l]["vv_inv"].shape[-1])
    tables, htab = batch["edges"][hop], host["edges"][hop]
    P = TRAIN_CORES
    spc = htab["vvt_inv"].shape[-1]
    n_vv = htab["vv_inv"].shape[-1]
    d = widths[hop]
    empty = sum(not any((c[p] < spc).any() for c in htab["vv_cols"])
                for p in range(P))
    ext = torch.from_numpy(rng.standard_normal((P, spc + n_vv, d)).astype(
        np.float32)).to(device)
    inputs = {"spmm_ell_vv": (ext[:, :spc].contiguous(), spc),
              "spmm_ell_t_vvt": (ext[:, spc:], n_vv)}
    out = {}
    for name, (x, n_cols) in inputs.items():
        meta = PREPASS[name]
        prefix, fn = meta["prefix"], (spmm_ell_walk, spmm_ell_t_walk)[
            meta["kernel"] == "spmm_ell_t"]
        wrapper = spmm_ell if meta["kernel"] == "spmm_ell" else spmm_ell_t
        walk = tables[prefix + "walk"]
        got = walk_once(torch, fn, walk, x)
        want = bucket_walk(torch, plain_out, tables, x, walk.total, prefix)
        err = max_err(got, want)
        if err > TRAIN_WALK_TOL:
            raise AssertionError(f"{name} |err| {err} > {TRAIN_WALK_TOL}")
        shape = walk_shape(htab[prefix + "cols"], n_cols, shared_x=False)
        bound, bound_by = walk_bound(shape, d, bw, flops)
        csr = stacked_csr(torch, htab[prefix + "cols"], htab[prefix + "vals"],
                          n_cols, device, own_x=True)
        xc = x.contiguous().reshape(-1, d)
        torch.testing.assert_close(torch.sparse.mm(csr, xc),
                                   got.reshape(-1, d), rtol=1e-4, atol=1e-5)
        only = kernel_ms(torch, lambda: walk_once(torch, fn, walk, x),
                         wrapper)
        out[name] = {
            "hop": hop, "max_abs_err": err,
            "ms": time_ms(torch, lambda: walk_once(torch, fn, walk, x)),
            "plain_ms": time_ms(torch, lambda: bucket_walk(
                torch, plain_out, tables, x, walk.total, prefix)),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": time_ms(torch, lambda: torch.sparse.mm(csr, xc)),
            "library_kernel_only_ms": queued_ms(
                torch, lambda: torch.sparse.mm(csr, xc))[0],
            "kernel_only_ms": only[0], "kernel_only_count": only[1],
            "host_ms": host_ms(torch, lambda: walk_once(torch, fn, walk, x)),
            "shape": dict(shape, d=d, buckets=len(walk.cols),
                          n_virtual_pad=n_vv, src_per_core=spc,
                          cores_without_virtual=int(empty))}
    return out


def redundancy_arm(torch, device, ds, item, widths, params, base_losses,
                   rng):
    """(c) ``ell+pipelined`` with ``merge="redundancy"``: ``AXES_STEPS``
    steps from the seeded checkpoint (the sync pipeline, so each step's
    host batch is seen), losses within ``LOSS_TOL`` of phase 7's dedup arm,
    and each step's ``spmm_ell`` / ``spmm_ell_t`` launches equal to the
    count its tables give: per hop one walk a feature wave forward and one
    backward, plus one pre-pass walk a wave forward and one ``Vᵀ`` walk
    backward on a hop with virtual vertices; the pre-pass walks' own
    launches are counted apart (:func:`prepass_counted`), gated at what
    the tables give and reported as ``prepass_launches``.  Fails unless a
    virtual vertex was mined.  Per hop of the first batch: the tier's stats and
    the mining's host ms; then :func:`prepass_records`."""
    from repro_torch.core.blockmsg import sender_merge_flat
    from repro_torch.core.schedule import feature_waves
    from repro_torch.distributed import aggregate as agg
    from repro_torch.engine import EngineConfig
    from repro_torch.graph.partition import block_partition
    from repro_torch.kernels.edgeplan import mine_pair_redundancy

    P = TRAIN_CORES
    cfg = EngineConfig.from_spec("ell+pipelined", merge="redundancy")
    tr = seeded_trainer(ds, params, cfg)(cfg, "card", input_pipeline="sync",
                                         device=device)
    hosts, prepare = [], tr.bundle.prepare_batch

    def recording(*args):
        hosts.append(prepare(*args))
        return hosts[-1]

    tr.bundle.prepare_batch = recording
    losses, per_step, prepass = [], [], {"spmm_ell": 0, "spmm_ell_t": 0}
    step_ms = []
    for i in range(AXES_STEPS):
        counts, pre = {}, {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += prepass_counted(pre, counted, counts, tr.train_steps, 1)
        step_ms.append((time.perf_counter() - t0) * 1e3)  # float(loss) syncs
        edges = hosts[-1]["edges"]
        waves = [len(feature_waves(widths[l], tr.bundle.n_chunks))
                 for l in range(len(edges))]
        tier = [l for l, e in enumerate(edges) if "vv_cols" in e]
        want_pre = {"spmm_ell": sum(waves[l] for l in tier),
                    "spmm_ell_t": len(tier)}
        want = {"spmm_ell": sum(waves) + want_pre["spmm_ell"],
                "spmm_ell_t": len(edges) + want_pre["spmm_ell_t"]}
        if any(counts.get(k, 0) != n for k, n in want.items()) or any(
                counts.get(k) for k in ("spmm_block", "spmm")) or any(
                pre.get(k, 0) != n for k, n in want_pre.items()):
            raise AssertionError(
                f"redundancy step {i + 1} launched {counts}, its pre-pass "
                f"{pre}; its tables give {want}, pre-pass {want_pre}")
        for k in prepass:
            prepass[k] += pre.get(k, 0)
        per_step.append(counts)
    tr.close()
    if not prepass["spmm_ell"]:
        raise AssertionError("no virtual vertex was mined on the driven "
                             "batches: the pre-pass never launched")
    diff = float(np.abs(np.asarray(losses)
                        - np.asarray(base_losses[:AXES_STEPS])).max())
    if not np.all(np.isfinite(losses)) or diff > LOSS_TOL:
        raise AssertionError(f"redundancy losses {losses} vs dedup "
                             f"{base_losses[:AXES_STEPS]} ({diff})")
    hops = {}
    for hop, coo in enumerate(item[0].layers):
        blocked = block_partition(coo, P)
        flats = [sender_merge_flat(blocked, j) for j in range(P)]
        t0 = time.perf_counter()
        for r, c, v in flats:
            mine_pair_redundancy(r, c, v, coo.n_dst, blocked.src_per_core)
        mining_ms = (time.perf_counter() - t0) * 1e3
        ee = agg.shard_edges_ell(coo, P, merge="redundancy")
        hops[f"hop{hop}"] = {"n_virtual": ee.n_virtual,
                             "pair_coverage": ee.pair_coverage,
                             "flop_reduction": ee.flop_reduction,
                             "mining_host_ms": mining_ms,
                             "merge_stats": ee.merge_stats}
    host = tr.bundle.prepare_batch(*item)
    batch = tr.bundle.commit_batch(host)
    n = len(per_step)
    return {"losses": losses, "vs_dedup_max_abs": diff, "hops": hops,
            "step_ms": step_ms,
            "ms_per_step_median_sync": float(np.median(step_ms)),
            "reports": [h["report"] for h in hosts],
            "launches": {k: sum(c.get(k, 0) for c in per_step)
                         for k in KERNELS},
            "launches_per_step": {k: sum(c.get(k, 0) for c in per_step) / n
                                  for k in KERNELS},
            "prepass_launches": prepass}, \
        prepass_records(torch, device, host, batch, widths, rng)


def mincom_arm(torch, device, ds, item, params, base_losses):
    """(d) ``ell+pipelined+hypercube+mincom``: ``AXES_STEPS`` steps from
    the seeded checkpoint, losses within ``LOSS_TOL`` of phase 7's naive
    arm; the plan reports' ``wire_bytes`` of naive and mincom on the first
    batch and the Trainer's last batch, and the host batch split with the
    relabeling's ms (a measurement, not a gate)."""
    from repro_torch.engine import Engine

    spec = "ell+pipelined+hypercube+mincom"
    tr = seeded_trainer(ds, params, spec)(spec, "card",
                                          input_pipeline="prefetch",
                                          device=device)
    counts = {}
    losses = counted(counts, tr.train_steps, AXES_STEPS)
    check_walks(counts, spec, spec)
    diff = float(np.abs(np.asarray(losses)
                        - np.asarray(base_losses[:AXES_STEPS])).max())
    if not np.all(np.isfinite(losses)) or diff > LOSS_TOL:
        raise AssertionError(f"mincom losses {losses} vs naive "
                             f"{base_losses[:AXES_STEPS]} ({diff})")
    last = dict(tr.last_plan_report)
    tr.fetcher.close()
    host, _ = host_split(torch, tr)
    tr.close()
    first = {part: Engine(s).build(TRAIN_CORES, device=device).prepare_batch(
        *item)["report"]["wire_bytes"]
        for part, s in (("naive", "ell+pipelined"), ("mincom", spec))}
    return {"losses": losses, "vs_naive_max_abs": diff,
            "wire_bytes_first_batch": first,
            "last_plan_report": last, "host_batch_ms": host,
            "launches": {k: counts.get(k, 0) for k in KERNELS},
            "launches_per_step": {k: counts.get(k, 0) / AXES_STEPS
                                  for k in KERNELS}}


def axes_phase(torch, device, ds, item, train, rng):
    """Phase 10: the Engine's other axes on the training data (P = 16,
    the seeded weights and batches of phase 7): (a)
    :func:`topology_aggregates`; (b) :func:`topology_arm` for each of
    ``AXES_ARMS``; (c) :func:`redundancy_arm`; (d) :func:`mincom_arm`.
    Returns (record, launches by path, pre-pass kernel records)."""
    widths = (ds.stats.n_classes, HIDDEN)
    params = train_params(ds)
    out, launches = {}, {}
    t0 = time.perf_counter()
    out["aggregates"], agg_launches = topology_aggregates(
        torch, device, item, widths, rng)
    out["aggregates_s"] = time.perf_counter() - t0
    for fmt, got in agg_launches.items():
        launches[f"axes aggregates {fmt}"] = got
    out["arms"] = {}
    for spec in AXES_ARMS:
        t0 = time.perf_counter()
        base = train[spec.rsplit("+", 1)[0]]["losses"]
        rec = topology_arm(torch, spec, seeded_trainer(ds, params, spec),
                           device, base)
        rec["phase_s"] = time.perf_counter() - t0
        out["arms"][spec] = rec
        launches[f"axes {spec}"] = rec["launches"]
    t0 = time.perf_counter()
    out["redundancy"], prepass = redundancy_arm(
        torch, device, ds, item, widths, params,
        train["ell+pipelined"]["losses"], rng)
    out["redundancy"]["phase_s"] = time.perf_counter() - t0
    launches["axes ell+pipelined redundancy"] = \
        out["redundancy"]["launches"]
    for name, rec in prepass.items():
        rec["launches"] = out["redundancy"]["prepass_launches"][
            PREPASS[name]["kernel"]]
    t0 = time.perf_counter()
    out["mincom"] = mincom_arm(torch, device, ds, item, params,
                               train["ell+pipelined"]["losses"])
    out["mincom"]["phase_s"] = time.perf_counter() - t0
    launches["axes ell+pipelined+hypercube+mincom"] = \
        out["mincom"]["launches"]
    return out, launches, prepass


# ---------------------------------------------------------------------------
# Phase 11: Engine("auto") — the planner, its records and the caps sweep.
# ---------------------------------------------------------------------------
def caps_sweep(device):
    """(a) ``tune.autotune(force=True)`` at the deepest hop's scale on the
    card: every candidate's forward + backward of ``ell_aggregate`` must
    launch exactly one ``spmm_ell`` and one ``spmm_ell_t`` (the untimed
    first call and the timed ones), and ``get_config()`` must then return
    the winner."""
    from repro_torch.kernels import tune

    n, deg, d = PLANNER_CAPS_SHAPE
    counts = {}
    rec = counted(counts, tune.autotune, force=True, n=n, deg=deg, d=d,
                  device=device)
    calls = len(tune.CAPS_CANDIDATES) * (rec["sweep"]["n_reps"] + 1)
    if counts["spmm_ell"] != calls or counts["spmm_ell_t"] != calls \
            or any(counts[k] for k in counts if k not in ("spmm_ell",
                                                          "spmm_ell_t")):
        raise AssertionError(f"caps sweep launched {counts} over {calls} "
                             "calls, not one spmm_ell + one spmm_ell_t each")
    if tune.get_config()["caps"] != rec["config"]["caps"]:
        raise AssertionError(f"get_config() {tune.get_config()} is not the "
                             f"sweep's winner {rec['config']}")
    return {"record": rec, "calls": calls, "launches": counts,
            "ms_per_fwdbwd": {json.dumps(r["caps"]): r["s_per_fwdbwd"] * 1e3
                              for r in rec["sweep"]["caps"]},
            "winner": rec["config"]["caps"]}


def topology_fit(device, stats):
    """(b) The port's ``_autotune_measure`` over ``ell+pipelined`` on each
    topology at the first batch's stats, written as a topology record (the
    keys ``benchmarks/epoch_time.py`` writes), then ``fit_cost_model``:
    α, β, const and each topology's predicted against measured seconds per
    step.  On one card the wire is a copy on the device."""
    import dataclasses

    from repro_torch.engine import get_topology, planner
    from repro_torch.kernels import tune

    counts = {}
    meas = counted(counts, planner._autotune_measure,
                   dataclasses.asdict(stats), TRAIN_CORES,
                   PLANNER_TOPOLOGY_SPECS, PLANNER_STEPS, PLANNER_TRIALS, 0,
                   device=device)
    check_walks(counts, "ell", "topology sweep")
    if not meas["loss_match"]:
        raise AssertionError("topology sweep: first-step losses differ by "
                             "more than 1e-5")
    mid, feat = meas["stream"]["mid"], meas["stream"]["feat"]
    topos = [spec.split("+")[2] for spec in PLANNER_TOPOLOGY_SPECS]
    rec = {"n_cores": TRAIN_CORES, "backend": tune.backend_key(device),
           "base_spec": "ell+pipelined", "mid": mid, "feat": feat,
           "topologies": topos, **{f"stream_{k}": v
                                   for k, v in meas["stream"].items()}}
    for spec, topo in zip(PLANNER_TOPOLOGY_SPECS, topos):
        plan = get_topology(topo).plan(mid, feat, TRAIN_CORES)
        rec[f"exchange_steps_{topo}"] = plan.steps
        rec[f"exchange_bytes_per_core_{topo}"] = plan.bytes_per_core
        rec[f"link_parallelism_{topo}"] = plan.link_parallelism
        rec[f"s_per_step_{topo}"] = meas["s_per_step"][spec]
    planner.TOPOLOGY_STORE.save(rec)
    model = planner.fit_cost_model(n_cores=TRAIN_CORES,
                                   backend=rec["backend"])
    if model is None:
        raise AssertionError(f"no cost model fits the record {rec}")
    fit = {}
    for topo in topos:
        pred = get_topology(topo).plan(mid, feat, TRAIN_CORES,
                                       cost_model=model).predicted_seconds
        got = rec[f"s_per_step_{topo}"]
        fit[topo] = {"measured_ms": got * 1e3, "predicted_ms": pred * 1e3,
                     "rel_err": abs(pred - got) / got}
    return model, {"record": rec, "alpha": model.alpha, "beta": model.beta,
                   "const": model.const, "fit": fit, "launches": counts}


def analytic_tier(torch, device, model, stats):
    """(c) ``rank_specs`` at the first batch's stats on the card (each
    format's roofline seconds beside it); with no planner record
    ``resolve_spec`` must return its first entry, and ``count_work`` of
    each format's layer at the roofline's dims must count the same on the
    card as on the CPU."""
    from repro_torch.engine import planner
    from repro_torch.kernels import tune
    from repro_torch.launch.roofline import count_work

    ranked = planner.rank_specs(model, TRAIN_CORES, graph_stats=stats,
                                device=device)
    backend = tune.backend_key(device)
    dims = planner._roofline_dims(stats)
    formats = sorted({"+".join(s.split("+")[:2]) for s, _ in ranked})
    secs = {f: planner._format_roofline_seconds(backend, f, dims)
            for f in formats}
    base = secs[model.base_spec]
    if planner.PLANNER_STORE.load() is not None:
        raise AssertionError("a planner record exists before tier 1 ran")
    resolved = planner.resolve_spec(n_cores=TRAIN_CORES, graph_stats=stats,
                                    device=device)
    if resolved != ranked[0][0]:
        raise AssertionError(f"tier 2 resolved {resolved}, ranking first "
                             f"{ranked[0][0]}")
    work, counts = {}, {}
    for spec in formats:
        fmt, layout, x, w = planner.roofline_layer_inputs(spec, dims)
        cpu = count_work(fmt.layer, layout, x, w)
        card = counted(counts, count_work, fmt.layer, layout, x.to(device),
                       w.to(device))
        if cpu != card:
            raise AssertionError(f"count_work of {spec}'s layer: CPU {cpu}, "
                                 f"card {card}")
        work[spec] = {"flops": cpu[0], "bytes": cpu[1]}
    return {"ranking": [[s, v * 1e3] for s, v in ranked],
            "roofline_s": secs,
            "roofline_ratio": {f: (s / base if s and base else None)
                               for f, s in secs.items()},
            "dims": list(dims), "resolved": resolved, "count_work": work,
            "launches": counts}


def auto_trainer(torch, device, ds, train, winner):
    """(e) ``Trainer("auto")`` from phase 7's seeded checkpoint, 3 warm-up
    + 5 steps, beside a concrete ``Trainer(winner)`` on the same batches:
    the same spec, bit-equal losses, the same launches every step (its
    format's walks only)."""
    params = train_params(ds)
    runs = {}
    for spec in ("auto", winner):
        tr = seeded_trainer(ds, params, spec)(spec, "card",
                                              input_pipeline="prefetch",
                                              device=device)
        losses, step_ms, per_step = [], [], []
        for i in range(AUTO_WARMUP + AUTO_STEPS):
            if i == AUTO_WARMUP:
                tr.reset_stall_stats()
            counts = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += counted(counts, tr.train_steps, 1)  # float(loss) syncs
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check_walks(counts, tr.engine.spec, f"{spec} step {i + 1}")
            per_step.append(counts)
        runs[spec] = {"spec": tr.engine.spec, "requested": tr.requested_spec,
                      "losses": losses, "step_ms": step_ms,
                      "ms_per_step_median": float(np.median(
                          step_ms[AUTO_WARMUP:])),
                      "host_stall_ms_per_step": tr.stall_per_step * 1e3,
                      "launches_each_step": per_step,
                      "launches": {k: sum(c.get(k, 0) for c in per_step)
                                   for k in KERNELS}}
        tr.close()
    auto, conc = runs["auto"], runs[winner]
    if auto["spec"] != winner or auto["requested"] != "auto":
        raise AssertionError(f"Trainer('auto') trains {auto['spec']}, the "
                             f"tier-1 winner is {winner}")
    if auto["losses"] != conc["losses"]:
        raise AssertionError(f"auto losses {auto['losses']} != {winner}'s "
                             f"{conc['losses']}")
    if auto["launches_each_step"] != conc["launches_each_step"]:
        raise AssertionError(f"auto launches {auto['launches_each_step']} "
                             f"!= {winner}'s {conc['launches_each_step']}")
    phase7 = train.get("+".join(winner.split("+")[:2]), {})
    return {"auto": auto, "concrete": conc, "losses_bit_equal": True,
            "phase7_ms_per_step": phase7.get("ms_per_step_median"),
            "phase7_host_stall_ms_per_step":
                phase7.get("host_stall_ms_per_step")}


def auto_serving(device, sds, ckpt, rng):
    """(f) ``InferenceEngine("auto", max_batch=8)`` on phase 4's graph and
    checkpoint: it resolves to ``resolve_spec(n_cores=1, mode="serving")``
    (phase (b)'s P = 16 record must not apply), and 8 cold queries give
    the logits of a concrete engine of that spec, bit for bit."""
    from repro_torch.engine import EngineConfig, planner
    from repro_torch.serving import InferenceEngine

    want = planner.resolve_spec(n_cores=1, mode="serving",
                                max_batch=AUTO_MAX_BATCH, device=device)
    auto = InferenceEngine("auto", sds.graph, sds.features, ckpt_dir=ckpt,
                           device=device, max_batch=AUTO_MAX_BATCH)
    conc = InferenceEngine(want, sds.graph, sds.features, ckpt_dir=ckpt,
                           device=device)
    if auto.spec != EngineConfig.from_spec(want).spec:
        raise AssertionError(f"auto serving resolved {auto.spec}, the "
                             f"serving planner says {want}")
    launches = {}
    for _ in range(AUTO_QUERIES):
        nodes = rng.choice(sds.graph.n_nodes, AUTO_MAX_BATCH, replace=False)
        got = counted(launches, auto.query, nodes, use_cache=False)
        if not np.array_equal(got, conc.query(nodes, use_cache=False)):
            raise AssertionError(f"auto serving logits differ from {want}'s "
                                 f"on {nodes.tolist()}")
    return {"resolved": want, "spec": auto.spec, "queries": AUTO_QUERIES,
            "logits_equal": True, "launches": launches}


def planner_phase(torch, device, ds, item, train, sds, ckpt):
    """Phase 11: ``Engine("auto")`` on the training data (P = 16, phase
    7's seeded weights and first batch): (a) :func:`caps_sweep`; (b)
    :func:`topology_fit`; (c) :func:`analytic_tier`; (d) the tier-1
    ``planner.autotune`` over every three-part spec (a second call must
    launch nothing); (e) :func:`auto_trainer`; (f) :func:`auto_serving`.
    Every record goes under ``build/`` through the three env vars, which
    are restored afterwards with ``tune.reset()``.  The phase fails if it
    takes longer than ``PLANNER_PHASE_S`` (90 s).  Returns (record,
    launches by path)."""
    from repro_torch.engine import EngineConfig, planner
    from repro_torch.kernels import tune

    rng = np.random.default_rng(11)
    saved = {var: os.environ.get(var) for var in PLANNER_RECORDS}
    for var, name in PLANNER_RECORDS.items():
        path = os.path.join(OUT_DIR, name)
        if os.path.exists(path):
            os.remove(path)
        os.environ[var] = path
    tune.reset()
    out, launches, t_all = {}, {}, time.perf_counter()
    try:
        t0 = time.perf_counter()
        out["caps"] = caps_sweep(device)
        out["caps"]["phase_s"] = time.perf_counter() - t0
        stats = planner.GraphStats.from_layers(item[0].layers,
                                               ds.stats.feat_dim)
        out["graph_stats"] = {"bucket": stats.bucket(),
                              **stats.__dict__}
        t0 = time.perf_counter()
        model, out["topology"] = topology_fit(device, stats)
        out["topology"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["tier2"] = analytic_tier(torch, device, model, stats)
        out["tier2"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tier1 = {}
        entry = counted(tier1, planner.autotune, stats, n_cores=TRAIN_CORES,
                        n_steps=PLANNER_STEPS, n_trials=PLANNER_TRIALS,
                        device=device)
        if not entry["loss_match"]:
            raise AssertionError("tier 1: first-step losses differ by more "
                                 "than 1e-5 across the specs")
        again = {}
        if counted(again, planner.autotune, stats, n_cores=TRAIN_CORES,
                   device=device) != entry or any(again.values()):
            raise AssertionError(f"a second autotune measured again "
                                 f"({again})")
        winner = EngineConfig.from_spec(entry["spec"]).spec
        out["tier1"] = {"entry": entry, "winner": winner,
                        "launches": tier1, "second_call_launches": again,
                        "phase_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        out["trainer"] = auto_trainer(torch, device, ds, train, winner)
        out["trainer"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["serving"] = auto_serving(device, sds, ckpt, rng)
        out["serving"]["phase_s"] = time.perf_counter() - t0
    finally:
        for var, value in saved.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value
        tune.reset()
    out["phase_s"] = time.perf_counter() - t_all
    if out["phase_s"] > PLANNER_PHASE_S:
        raise AssertionError(f"phase 11 took {out['phase_s']:.1f} s, over "
                             f"its {PLANNER_PHASE_S:.0f} s limit")
    launches["planner caps sweep"] = out["caps"]["launches"]
    launches["planner topology sweep"] = out["topology"]["launches"]
    launches["planner count_work"] = out["tier2"]["launches"]
    launches["planner autotune"] = out["tier1"]["launches"]
    launches["planner auto trainer"] = out["trainer"]["auto"]["launches"]
    launches[f"planner {winner} trainer"] = \
        out["trainer"]["concrete"]["launches"]
    launches["planner auto serving"] = out["serving"]["launches"]
    return out, launches


# ---------------------------------------------------------------------------
# Phase 12: out-of-core feature stores through the Trainer, the
# InferenceEngine and the serve CLI.
# ---------------------------------------------------------------------------
def store_steps(torch, tr, n_warmup, n_steps, ckpt_step=None):
    """``n_warmup + n_steps`` counted steps of ``tr`` (stall statistics
    reset after the warm-up, a checkpoint at ``ckpt_step``): (losses, ms
    per step, launches each step)."""
    losses, step_ms, per_step = [], [], []
    for i in range(n_warmup + n_steps):
        if i == n_warmup:
            tr.reset_stall_stats()
        if tr.global_step == ckpt_step:
            tr.save(sync=True)
        counts = dict.fromkeys(KERNELS, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += counted(counts, tr.train_steps, 1)  # float(loss) syncs
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(counts)
    return losses, step_ms, per_step


def same_as_dense(spec, losses, per_step, dense, what):
    """Losses and each step's launches equal to phase 7's dense arm over
    the same steps."""
    n = len(losses)
    if losses != dense["losses"][:n]:
        raise AssertionError(f"{what}: losses {losses} != the dense "
                             f"{spec} arm's {dense['losses'][:n]}")
    if per_step != dense["launches_each_step"][:n]:
        raise AssertionError(f"{what}: launches {per_step} != the dense "
                             f"arm's {dense['launches_each_step'][:n]}")


def store_ell_arm(torch, device, mds, params, dense):
    """(b) and (d): ``ell+pipelined`` from the mmap dataset's store behind
    a hot-vertex cache of a tenth of the nodes, through the staged chain;
    then its step-5 checkpoint resumed for steps 6-10."""
    spec = "ell+pipelined"
    trainer = seeded_trainer(mds, params, spec, tag="store")
    rows = mds.graph.n_nodes // STORE_CACHE_SHARE
    kw = dict(input_pipeline="prefetch", device=device, feature_store="mmap",
              cache_capacity=rows)
    tr = trainer(spec, "card", **kw)
    if tr.store is not mds.features or tr.feature_mode != "mmap":
        raise AssertionError("the Trainer does not train from the "
                             "dataset's mmap store")
    cache = tr.cache
    pinned = cache.device_rows
    if pinned.device != tr.device or not torch.equal(
            pinned.cpu(), torch.from_numpy(cache._rows[:cache.n_pinned])):
        raise AssertionError("the cache's device rows are not its pinned "
                             "host rows on the Trainer's device")
    gather_ms, inner = [], cache.gather

    def timed_gather(ids):
        t0 = time.perf_counter()
        rows_ = inner(ids)
        gather_ms.append((time.perf_counter() - t0) * 1e3)
        return rows_
    cache.gather = timed_gather        # the gather stage reads the instance
    losses, step_ms, per_step = store_steps(torch, tr, STORE_WARMUP,
                                            STORE_STEPS, STORE_CKPT_STEP)
    same_as_dense(spec, losses, per_step, dense, "store ell")
    stall_ms = tr.stall_per_step * 1e3
    place_ms = tr.place_per_step * 1e3
    stages = {k: v * 1e3 for k, v in tr.fetcher.stage_stalls().items()}
    stats = cache.stats()
    store = {"gather_calls": tr.store.gather_calls,
             "bytes_gathered": tr.store.bytes_gathered}
    tr.fetcher.close()
    del cache.gather
    host, _ = host_split(torch, tr)
    tr.close()

    resumed = trainer(spec, "card", **kw)
    if resumed.global_step != STORE_CKPT_STEP:
        raise AssertionError(f"store ell resumed at step "
                             f"{resumed.global_step}")
    again, _, again_steps = store_steps(torch, resumed, 0, STORE_CKPT_STEP)
    resumed.close()
    want = losses[STORE_CKPT_STEP:2 * STORE_CKPT_STEP]
    if again != want:
        raise AssertionError(f"store ell resume: steps 6-10 {again} != "
                             f"{want}")
    measured = step_ms[STORE_WARMUP:]
    return {"losses": losses, "resumed_losses_6_10": again,
            "cache_rows": rows, "cache_pinned": cache.n_pinned,
            "ms_per_step_median": float(np.median(measured)),
            "dense_ms_per_step_median": dense["ms_per_step_median"],
            "host_stall_ms_per_step": stall_ms,
            "dense_host_stall_ms_per_step": dense["host_stall_ms_per_step"],
            "place_ms_per_step": place_ms,
            "stage_stall_ms_per_step": stages,
            "cache_gather_ms_per_batch_median": float(np.median(gather_ms)),
            "cache_gather_batches": len(gather_ms),
            "cache_stats": stats, "store": store, "host_batch_ms": host,
            "step_ms": step_ms, "launches_each_step": per_step,
            "launches": {k: sum(c[k] for c in per_step + again_steps)
                         for k in KERNELS}}


def store_host_arm(torch, device, tds, params, dense, spec):
    """(c): ``spec`` with the dense dataset wrapped in a host store (the
    Trainer's own, closed with it) and no cache, 3 warm-up + 10 steps."""
    tr = seeded_trainer(tds, params, spec, tag="store")(
        spec, "card", input_pipeline="prefetch", device=device,
        feature_store="host")
    if tr.feature_mode != "host" or tr.cache is not None:
        raise AssertionError(f"{spec} store arm: not a bare host store")
    losses, step_ms, per_step = store_steps(torch, tr, STORE_WARMUP,
                                            STORE_HOST_STEPS)
    same_as_dense(spec, losses, per_step, dense, f"host store {spec}")
    out = {"losses": losses,
           "ms_per_step_median": float(np.median(step_ms[STORE_WARMUP:])),
           "dense_ms_per_step_median": dense["ms_per_step_median"],
           "host_stall_ms_per_step": tr.stall_per_step * 1e3,
           "stage_stall_ms_per_step": {
               k: v * 1e3 for k, v in tr.fetcher.stage_stalls().items()},
           "store": {"gather_calls": tr.store.gather_calls,
                     "bytes_gathered": tr.store.bytes_gathered},
           "step_ms": step_ms,
           "launches": {k: sum(c[k] for c in per_step) for k in KERNELS}}
    tr.fetcher.close()
    out["host_batch_ms"], _ = host_split(torch, tr)
    tr.close()
    return out


def store_budget(device, tds, mds):
    """(e): a dense Trainer over a ``device_budget_bytes`` below its
    feature matrix raises; the same budget on the mmap store builds."""
    from repro_torch.launch.trainer import Trainer

    budget = tds.features.nbytes // 2
    kw = dict(n_cores=TRAIN_CORES, hidden=HIDDEN, batch_size=TRAIN_BATCH,
              fanouts=TRAIN_FANOUTS, device=device,
              device_budget_bytes=budget)
    try:
        Trainer("ell+pipelined", tds, **kw).close()
    except ValueError as e:
        if "device_budget_bytes" not in str(e):
            raise
    else:
        raise AssertionError(f"dense features of {tds.features.nbytes} B "
                             f"trained under a {budget} B budget")
    tr = Trainer("ell+pipelined", mds, feature_store="mmap", **kw)
    mode = tr.feature_mode
    tr.close()
    if mode != "mmap":
        raise AssertionError(f"the budgeted store Trainer runs {mode}")
    return {"budget_bytes": budget, "dense_bytes": tds.features.nbytes,
            "dense_raised": True, "store_built": True}


def store_serving(device, sds, ckpt, path, rng):
    """(f): ``InferenceEngine("ell+pipelined")`` over an ``MmapStore`` of
    phase 4's features with a 4096-row feature cache: 8 cold queries give
    a dense engine's logits bit for bit, and the feature cache hits."""
    import torch

    from repro_torch.featurestore import HotVertexCache, MmapStore
    from repro_torch.serving import InferenceEngine

    store = MmapStore.from_array(sds.features, path=path)
    try:
        eng = InferenceEngine("ell+pipelined", sds.graph, store,
                              ckpt_dir=ckpt, device=device,
                              feature_cache_capacity=STORE_SERVE_CACHE_ROWS)
        dense = InferenceEngine("ell+pipelined", sds.graph, sds.features,
                                ckpt_dir=ckpt, device=device)
        if not isinstance(eng.features, HotVertexCache):
            raise AssertionError("the engine did not wrap its store")
        launches = dict.fromkeys(KERNELS, 0)
        for _ in range(STORE_QUERIES):
            nodes = rng.choice(sds.graph.n_nodes, AUTO_MAX_BATCH,
                               replace=False)
            got = counted(launches, eng.query, nodes, use_cache=False)
            if not np.array_equal(got, dense.query(nodes, use_cache=False)):
                raise AssertionError(f"store serving logits differ on "
                                     f"{nodes.tolist()}")
        if launches["spmm_ell"] <= 0 or launches["gemm"] <= 0 or any(
                launches[k] for k in ("spmm_ell_t", "spmm_block", "spmm",
                                      "flash_mha")):
            raise AssertionError(f"store serving launched {launches}, not "
                                 "spmm_ell and gemm")
        fc = eng.stats()["feature_cache"]
        if fc["hits"] <= 0:
            raise AssertionError(f"the feature cache never hit: {fc}")
        rows = eng.features.device_rows
        if rows.device != eng.device or not torch.equal(
                rows.cpu(), torch.from_numpy(
                    eng.features._rows[:eng.features.n_pinned])):
            raise AssertionError("serving cache device rows differ")
        return {"queries": STORE_QUERIES, "logits_equal": True,
                "feature_cache": fc, "store_gather_calls": store.gather_calls,
                "store_bytes_gathered": store.bytes_gathered,
                "launches": launches}
    finally:
        store.close()


def serve_cli():
    """(g): the GCN serving CLI's smoke as a process of its own."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, *SERVE_SMOKE_ARGS], cwd=HERE,
                          env=env, capture_output=True, text=True,
                          timeout=FEATURE_STORE_PHASE_S)
    tail = proc.stdout.strip().splitlines()[-4:]
    if proc.returncode != 0:
        raise AssertionError(f"serve --smoke exited {proc.returncode}:\n"
                             + proc.stdout[-2000:] + proc.stderr[-2000:])
    return {"rc": proc.returncode, "s": time.perf_counter() - t0,
            "tail": tail}


def feature_store_phase(torch, device, tds, train, sds, ckpt):
    """Phase 12: feature stores on phase 7's training data, seeded weights
    and Trainer configuration (P = 16), and on phase 4's serving graph:
    (a) the mmap dataset, equal to the dense one; (b) + (d)
    :func:`store_ell_arm`; (c) :func:`store_host_arm` for
    ``block+pipelined``, and for ``ell+pipelined`` beside (b)'s cache; (e)
    :func:`store_budget`; (f) :func:`store_serving`; (g) :func:`serve_cli`.
    Both store files live under ``build/`` and are deleted at the end.  The
    phase fails if it takes longer than ``FEATURE_STORE_PHASE_S``.
    Returns (record, launches by path)."""
    from repro_torch.featurestore import MmapStore
    from repro_torch.graph import make_dataset

    rng = np.random.default_rng(12)
    paths = [os.path.join(OUT_DIR, f"chip_smoke_{k}_features.npy")
             for k in ("train", "serve")]
    out, t_all, mds = {}, time.perf_counter(), None
    params = train_params(tds)
    os.makedirs(OUT_DIR, exist_ok=True)
    try:
        t0 = time.perf_counter()
        mds = make_dataset(tds.stats.name, scale=tds.scale, seed=0,
                           features="mmap", store_path=paths[0])
        gen_s = time.perf_counter() - t0
        if not isinstance(mds.features, MmapStore) or not (
                np.array_equal(mds.features.as_array(), tds.features)
                and np.array_equal(mds.labels, tds.labels)
                and np.array_equal(mds.graph.indices, tds.graph.indices)):
            raise AssertionError("the mmap dataset differs from the dense "
                                 "one")
        out["dataset"] = {"store_bytes": mds.features.nbytes,
                          "file_bytes": os.path.getsize(paths[0]),
                          "generation_s": gen_s, "equal_to_dense": True,
                          "phase_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        out["ell"] = store_ell_arm(torch, device, mds, params,
                                   train["ell+pipelined"])
        out["ell"]["phase_s"] = time.perf_counter() - t0
        out["host"] = {}
        for spec in TRAIN_SPECS[::-1]:
            t0 = time.perf_counter()
            out["host"][spec] = store_host_arm(torch, device, tds, params,
                                               train[spec], spec)
            out["host"][spec]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["budget"] = store_budget(device, tds, mds)
        out["budget"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["serving"] = store_serving(device, sds, ckpt, paths[1], rng)
        out["serving"]["phase_s"] = time.perf_counter() - t0
        out["serve_cli"] = serve_cli()
    finally:
        if mds is not None:
            mds.features.close()
        for path in paths:
            if os.path.exists(path):
                os.remove(path)
    out["phase_s"] = time.perf_counter() - t_all
    if out["phase_s"] > FEATURE_STORE_PHASE_S:
        raise AssertionError(f"phase 12 took {out['phase_s']:.1f} s, over "
                             f"its {FEATURE_STORE_PHASE_S:.0f} s limit")
    launches = {"store ell+pipelined trainer": out["ell"]["launches"],
                "store serving": out["serving"]["launches"]}
    for spec, arm in out["host"].items():
        launches[f"host store {spec} trainer"] = arm["launches"]
    return out, launches


def print_feature_store(store):
    """Phase 12's lines of the log."""
    sd, sell = store["dataset"], store["ell"]
    print(f"feature store dataset: mmap {sd['store_bytes']} B "
          f"({sd['file_bytes']} B on disk) generated in "
          f"{sd['generation_s']:.1f}s, rows and labels equal to the dense "
          f"dataset", flush=True)
    print(f"feature store ell+pipelined (mmap, cache {sell['cache_rows']} "
          f"rows, {sell['cache_pinned']} pinned): ms_per_step="
          f"{sell['ms_per_step_median']:.3f} (dense "
          f"{sell['dense_ms_per_step_median']:.3f}) host_stall_ms_per_step="
          f"{sell['host_stall_ms_per_step']:.3f} (dense "
          f"{sell['dense_host_stall_ms_per_step']:.3f}; placement "
          f"{sell['place_ms_per_step']:.3f}) stage_stall_ms_per_step="
          + json.dumps(sell["stage_stall_ms_per_step"])
          + f" cache_gather_ms_per_batch="
          f"{sell['cache_gather_ms_per_batch_median']:.3f} (median of "
          f"{sell['cache_gather_batches']}, on its producer thread) "
          f"host_batch_ms={json.dumps(sell['host_batch_ms'])} cache="
          + json.dumps(sell["cache_stats"]) + " store="
          + json.dumps(sell["store"]) + f"; losses and launches equal to "
          f"the dense arm, resume 6-10 equal ({sell['phase_s']:.1f}s)",
          flush=True)
    for spec, arm in store["host"].items():
        print(f"feature store {spec} (host, no cache): ms_per_step="
              f"{arm['ms_per_step_median']:.3f} (dense "
              f"{arm['dense_ms_per_step_median']:.3f}) "
              f"host_stall_ms_per_step={arm['host_stall_ms_per_step']:.3f} "
              f"stage_stall_ms_per_step="
              + json.dumps(arm["stage_stall_ms_per_step"])
              + f" host_batch_ms={json.dumps(arm['host_batch_ms'])} store="
              + json.dumps(arm["store"]) + f"; losses and launches equal "
              f"to the dense arm ({arm['phase_s']:.1f}s)", flush=True)
    ssrv, scli = store["serving"], store["serve_cli"]
    print(f"feature store budget: {json.dumps(store['budget'])}; serving "
          f"over mmap: {ssrv['queries']} cold queries equal to dense, "
          f"feature_cache={json.dumps(ssrv['feature_cache'])}; serve "
          f"--smoke exit {scli['rc']} in {scli['s']:.1f}s "
          + json.dumps(scli["tail"]) + f"; feature store phase "
          f"{store['phase_s']:.1f}s", flush=True)


def lm_params(torch, cfg, device, seed):
    """Random f32 weights for ``cfg`` from a seeded generator on ``device``
    (what ``lm_serve.Server(seed=)`` draws)."""
    from repro_torch.models import lm

    gen = torch.Generator(device=device).manual_seed(seed)
    return lm.init_params(gen, cfg, dtype=torch.float32)


def flash_bound(bh, s, hd, causal, itemsize, bw, rate, products=1,
                window=None, sk=None, backward=False):
    """(ms, "bytes" | "operations") of attention over ``s`` queries and
    ``sk`` (default ``s``) keys (``kernels.work.attention_work``, the
    wrappers' own count): q, k, v read once and o written once against the
    memory rate, 4·hd flops per live (i, j) pair (``kernels.flash.
    live_pairs``: j <= i when causal, i - j < window with one); with
    ``backward``, q, k, v, o, dO and lse read and dq, dk, dv written, 10·hd
    flops a pair (five products).  Each multiply-add is done as
    ``products`` products at ``rate`` (the f32 forward kernel: 3 TF32
    products at the TF32 tensor rate; bf16: 1 at the bf16 rate)."""
    from repro_torch.kernels.flash import live_pairs
    from repro_torch.kernels.work import attention_work

    sk = s if sk is None else sk
    flops, nbytes = attention_work(bh, s, sk, hd,
                                   live_pairs(s, sk, causal, window),
                                   itemsize, backward)
    t_bytes = nbytes / bw
    t_ops = products * flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def flash_kernel_phase(torch, device, params, cfg, tokens, rng):
    """``flash_mha`` against its plain version at layer 0's real prefill
    shape (q, k, v from the model's own ``gqa_project`` + ``apply_rope``
    on the prompt) and at the edge cases; the layer-0 shape timed against
    the plain version, a bound and SDPA.  Returns (record, detail)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_mha, mha_ref
    from repro_torch.models import transformer as tf

    s = tokens.shape[1]
    qh, kh, vh = layer0_qkv(torch, params, cfg, tokens)
    blocks = dict(q_block=tf.Q_BLOCK, k_block=tf.K_BLOCK)
    got = flash_mha(qh, kh, vh, causal=True, **blocks)
    torch.cuda.synchronize()
    want = mha_ref(qh, kh, vh, causal=True, q_block=tf.Q_BLOCK)
    errs = {"layer0": max_err(got, want)}
    if not torch.isfinite(got).all() or errs["layer0"] > FLASH_TOL:
        raise AssertionError(f"flash_mha layer-0 prefill shape: max |err| "
                             f"{errs['layer0']} > {FLASH_TOL}")
    q4, k4, v4 = qh[None], kh[None], vh[None]   # SDPA's fused kernels: 4-D
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)[0]
    lib_err = max_err(lib, want)
    del got, want, lib
    for bh, sq, sk, hd, qb, kb, causal, dt in FLASH_EDGES:
        dtype = getattr(torch, dt)
        a, b_, c = (torch.from_numpy(rng.standard_normal(
            (bh, n, hd)).astype(np.float32)).to(device, dtype)
            for n in (sq, sk, sk))
        out = flash_mha(a, b_, c, causal=causal, q_block=qb, k_block=kb)
        torch.cuda.synchronize()
        ref = mha_ref(a, b_, c, causal=causal, q_block=qb)
        key = f"bh{bh}_sq{sq}_sk{sk}_hd{hd}_qb{qb}_kb{kb}_" \
              f"{'causal' if causal else 'full'}_{dt}"
        errs[key] = max_err(out.float(), ref.float())
        tol = FLASH_BF16_TOL if dt == "bfloat16" else FLASH_TOL
        if out.dtype != dtype or not torch.isfinite(out).all() \
                or errs[key] > tol:
            raise AssertionError(f"flash_mha {key}: max |err| {errs[key]} "
                                 f"> {tol}")
    peaks = device_peaks(torch)
    bh, _, hd = qh.shape
    bound_ms, bound_by = flash_bound(bh, s, hd, True, 4, peaks.bw,
                                     peaks.tf32, products=3)
    ms = time_ms(torch, lambda: flash_mha(qh, kh, vh, causal=True, **blocks))
    only = kernel_ms(torch, lambda: flash_mha(qh, kh, vh, causal=True,
                                              **blocks), flash_mha)
    plain = time_ms(torch, lambda: mha_ref(qh, kh, vh, causal=True,
                                           q_block=tf.Q_BLOCK))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        library = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))
        library_only = queued_ms(torch, lambda: (
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)))[0]
    rec = {"max_abs_err": max(e for k, e in errs.items()
                              if not k.endswith("bfloat16")),
           "max_abs_err_bf16": max(e for k, e in errs.items()
                                   if k.endswith("bfloat16")),
           "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library,
           "kernel_only_ms": only[0], "kernel_only_count": only[1],
           "host_ms": host_ms(torch, lambda: flash_mha(
               qh, kh, vh, causal=True, **blocks)),
           "library_kernel_only_ms": library_only}
    detail = {"flash_mha_max_abs_err": errs,
              "flash_mha_layer0_shape": [bh, s, hd],
              "flash_mha_layer0_tflops": 4.0 * bh * hd * s * (s + 1) / 2
              / (ms * 1e-3) / 1e12,
              "flash_mha_sdpa_vs_plain_max_abs_err": lib_err,
              "flash_mha_fma_bound_ms": flash_bound(
                  bh, s, hd, True, 4, peaks.bw, peaks.fp32)[0]}
    detail.update(flash_f64_errors(torch, qh, kh, vh, blocks))
    detail.update(flash_bf16_arm(torch, qh, kh, vh, blocks, peaks))
    return rec, detail


def flash_f64_errors(torch, qh, kh, vh, blocks):
    """Largest |err| against a float64 ``mha_ref`` at the layer-0 shape of
    the f32 kernel, of SDPA (memory-efficient) and of the plain f32
    version; and the same with q and k doubled (logits 4× larger: where
    the split products' rounding shows most)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_mha, mha_ref
    from repro_torch.models import transformer as tf

    out = {}
    for tag, gain in (("", 1.0), ("_logits_x4", 2.0)):
        q, k = qh * gain, kh * gain
        want = mha_ref(q.double(), k.double(), vh.double(), causal=True,
                       q_block=tf.Q_BLOCK)
        got = flash_mha(q, k, vh, causal=True, **blocks)
        plain = mha_ref(q, k, vh, causal=True, q_block=tf.Q_BLOCK)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib = F.scaled_dot_product_attention(
                q[None], k[None], vh[None], is_causal=True)[0]
        out[f"flash_mha_f64_max_abs_err{tag}"] = {
            "kernel": max_err(got, want), "sdpa": max_err(lib, want),
            "plain_f32": max_err(plain, want)}
        del q, k, want, got, plain, lib
    return out


def flash_bf16_arm(torch, qh, kh, vh, blocks, peaks):
    """The layer-0 q, k, v cast to bf16: the kernel against ``mha_ref`` in
    bf16 (``FLASH_BF16_TOL``), its event, kernel-only (launch count gated)
    and host ms against the bf16 bound and SDPA's flash backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_mha, mha_ref
    from repro_torch.models import transformer as tf

    qb, kb, vb = (t.to(torch.bfloat16) for t in (qh, kh, vh))
    bh, s, hd = qb.shape
    got = flash_mha(qb, kb, vb, causal=True, **blocks)
    torch.cuda.synchronize()
    want = mha_ref(qb, kb, vb, causal=True, q_block=tf.Q_BLOCK)
    err = max_err(got.float(), want.float())
    if got.dtype != torch.bfloat16 or not torch.isfinite(got.float()).all() \
            or err > FLASH_BF16_TOL:
        raise AssertionError(f"flash_mha bf16 layer-0 shape: max |err| "
                             f"{err} > {FLASH_BF16_TOL}")
    q4, k4, v4 = qb[None], kb[None], vb[None]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib_err = max_err(F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)[0].float(), want.float())
    del got, want
    call = lambda: flash_mha(qb, kb, vb, causal=True, **blocks)  # noqa: E731
    only = kernel_ms(torch, call, flash_mha)
    bound_ms, bound_by = flash_bound(bh, s, hd, True, 2, peaks.bw,
                                     peaks.bf16)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=True)
        library, library_only = time_ms(torch, lib), queued_ms(torch, lib)[0]
    return {"flash_mha_bf16_max_abs_err": err,
            "flash_mha_bf16_ms": time_ms(torch, call),
            "flash_mha_bf16_kernel_only_ms": only[0],
            "flash_mha_bf16_kernel_only_count": only[1],
            "flash_mha_bf16_host_ms": host_ms(torch, call),
            "flash_mha_bf16_bound_ms": bound_ms,
            "flash_mha_bf16_bound_by": bound_by,
            "flash_mha_bf16_library_ms": library,
            "flash_mha_bf16_library_kernel_only_ms": library_only,
            "flash_mha_bf16_sdpa_vs_plain_max_abs_err": lib_err}


def attention_share(torch, fn):
    """Share of the device's time in one ``fn()`` spent in ``flash_mha``'s
    kernel (``None`` when the profiler recorded no device time), the device
    ms, and the count of ``flash_mha`` records, from ``torch.profiler``
    after its warm-up step."""
    events, _ = profiled(torch, fn)
    total, _ = device_records(events)
    flash, flash_n = device_records(events, "flash_mha_kernel")
    return (flash / total if total else None), total, flash_n


def prefill_phase(torch, device, params, cfg, tokens, launches):
    """``prefill_fn`` at b = 1, s = 16384 (1 warm-up, 3 measured, each
    counted on its own: exactly one ``flash_mha`` launch per layer), the
    attention share from the profiler, and a prefill at s = 2048 (no
    flash launch)."""
    from repro_torch.models import lm

    prefill = lm.prefill_fn(cfg)
    batch = {"tokens": tokens}
    times = []
    for i in range(1 + LM_PREFILL_REPS):
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = counted(counts, prefill, params, batch)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        if counts["flash_mha"] != cfg.n_layers:
            raise AssertionError(f"prefill s={tokens.shape[1]} launched "
                                 f"flash_mha {counts['flash_mha']} times, "
                                 f"not {cfg.n_layers}")
        if logits.shape != (1, 1, cfg.vocab) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 "not finite or misshaped")
        for k, n in counts.items():
            launches["lm prefill s=16384"][k] += n
    share, device_ms, flash_records = attention_share(
        torch, lambda: prefill(params, batch))
    counts = {}
    short = counted(counts, prefill, params,
                    {"tokens": tokens[:, :LM_SHORT_S].contiguous()})
    torch.cuda.synchronize()
    if counts["flash_mha"] != 0 or not torch.isfinite(short).all():
        raise AssertionError(f"prefill s={LM_SHORT_S} launched flash_mha "
                             f"{counts['flash_mha']} times")
    for k, n in counts.items():
        launches["lm prefill s=2048"][k] += n
    ms = float(np.median(times))
    s = tokens.shape[1]
    return {"s": s, "ms_median": ms, "ms_each": times,
            "tokens_per_s": s / (ms / 1e3),
            "flash_share_of_device_time": share,
            "flash_records_profiled": flash_records,
            "device_kernel_ms_profiled": device_ms,
            "device_busy_share": device_ms / ms,
            "flash_launches_per_prefill": cfg.n_layers}


def prefill_gate(torch, device, cfg, rng, launches):
    """Last-position prefill logits on the card against the port's CPU run
    on the same weights and prompt: full width, 2 layers, s = 9216 (the
    flash branch; the CPU runs the plain version)."""
    import copy

    from repro_torch.models import lm

    cfg2 = cfg.scaled(n_layers=LM_GATE_LAYERS)
    card_params = lm_params(torch, cfg2, device, seed=1)
    cpu_params = copy.deepcopy(card_params).cpu()
    tokens = rng.integers(0, cfg.vocab, (1, LM_GATE_S))
    prefill = lm.prefill_fn(cfg2)
    counts = {}
    card = counted(counts, prefill, card_params,
                   {"tokens": torch.from_numpy(tokens).to(device)})
    if counts["flash_mha"] != LM_GATE_LAYERS:
        raise AssertionError(f"gate prefill launched flash_mha "
                             f"{counts['flash_mha']} times")
    for k, n in counts.items():
        launches["lm prefill gate"][k] += n
    t0 = time.perf_counter()
    cpu = prefill(cpu_params, {"tokens": torch.from_numpy(tokens)})
    cpu_s = time.perf_counter() - t0
    err = max_err(card.cpu(), cpu)
    if err > LM_LOGIT_TOL or not torch.isfinite(card).all():
        raise AssertionError(f"card vs CPU prefill logits differ by {err}")
    return {"layers": LM_GATE_LAYERS, "s": LM_GATE_S,
            "card_vs_cpu_max_abs": err, "cpu_s": cpu_s}


def lm_traffic(vocab):
    """``lm_serve.main``'s requests: prompts of 4-12 tokens from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, rng.integers(4, 12)).astype(np.int32)
            for _ in range(LM_REQUESTS)]


def serve_phase_lm(torch, device, params, cfg, launches):
    """The continuous-batching server at full width (``slots`` 4,
    ``max_seq`` 128, 8 requests of ``max_new`` 16): every request
    completes, each one's greedy tokens equal a run of it alone in the
    same 4-slot server (the masked merge keeps other slots' caches), no
    ``flash_mha`` launch; decode calls timed against the weight bytes; the
    teacher-forced forward against token-by-token decode."""
    from repro_torch.launch.lm_serve import Request, Server
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf

    def server():
        return Server(LM_ARCH, smoke=False, slots=LM_SLOTS,
                      max_seq=LM_MAX_SEQ, device=device, params=params)

    prompts = lm_traffic(cfg.vocab)
    srv = server()
    for i, prompt in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=prompt, max_new=LM_MAX_NEW))
    counts = {}
    stats = counted(counts, srv.run)
    for k, n in counts.items():
        launches["lm serve"][k] += n
    if counts["flash_mha"] != 0:
        raise AssertionError(f"the server launched flash_mha "
                             f"{counts['flash_mha']} times")
    done = {r.rid: r.generated for r in srv.completed}
    if sorted(done) != list(range(LM_REQUESTS)) or any(
            len(g) != LM_MAX_NEW for g in done.values()):
        raise AssertionError(f"server completed {sorted(done)}")
    for i, prompt in enumerate(prompts):
        solo = server()
        solo.submit(Request(rid=i, prompt=prompt, max_new=LM_MAX_NEW))
        counted(launches["lm serve solo"], solo.run)
        if solo.completed[0].generated != done[i]:
            raise AssertionError(f"request {i}: batched tokens {done[i]} != "
                                 f"alone {solo.completed[0].generated}")
    calls = srv.decode_calls
    tokens = np.zeros((LM_SLOTS, 1), np.int32)
    mask = np.ones(LM_SLOTS, bool)
    call_ms = time_ms(torch, lambda: srv.decode(tokens, 20, mask))
    events, _ = profiled(torch, lambda: [srv.decode(tokens, 20, mask)
                                         for _ in range(REPS)])
    call_device_ms, call_records = device_records(events)
    call_device_ms /= REPS
    bw = device_peaks(torch).bw
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    cache_bytes = 2 * srv.cache.k.numel() * srv.cache.k.element_size()

    # teacher-forced logits vs token-by-token decode (one sequence)
    seq = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, LM_TF_S))).to(device)
    with torch.no_grad():
        full = counted(launches["lm decode vs forward"], tf.dense_forward,
                       params, seq, cfg)
    cache = lm.init_cache(cfg, 1, LM_TF_S, dtype=torch.float32,
                          device=device)
    step = lm.decode_fn(cfg)
    outs = []
    for t in range(LM_TF_S):
        lg, cache = counted(launches["lm decode vs forward"], step, params,
                            cache, seq[:, t:t + 1], t)
        outs.append(lg[:, 0])
    tf_err = max_err(torch.stack(outs, 1), full)
    if tf_err > LM_LOGIT_TOL:
        raise AssertionError(f"decode vs teacher-forced logits differ by "
                             f"{tf_err}")
    return {"requests": LM_REQUESTS, "completed": len(done),
            "steps": stats["steps"], "tokens": stats["tokens"],
            "wall_s": stats["wall_s"], "tok_per_s": stats["tok_per_s"],
            "decode_calls": calls,
            "wall_ms_per_decode_call": stats["wall_s"] / calls * 1e3,
            "decode_call_ms_median": call_ms,
            "decode_call_device_ms": call_device_ms,
            "decode_device_records": call_records,
            "decode_call_bound_ms": (weight_bytes + cache_bytes) / bw * 1e3,
            "weight_bytes": weight_bytes,
            "solo_tokens_equal": True,
            "decode_vs_forward_max_abs": tf_err}


def lm_phase(torch, device, rng):
    """Phase 9: llama3.2-1b serving at its published widths — the
    ``flash_mha`` kernel checks, the long-prompt prefill, the card vs CPU
    gate and the server.  Returns (flash_mha record, detail, launches by
    path)."""
    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    launches = {k: dict.fromkeys(KERNELS, 0)
                for k in ("lm prefill s=16384", "lm prefill s=2048",
                          "lm prefill gate", "lm serve", "lm serve solo",
                          "lm decode vs forward")}
    t0 = time.perf_counter()
    params = lm_params(torch, cfg, device, seed=0)
    n_params = sum(p.numel() for p in params.parameters())
    gains = (2 * cfg.n_layers + 1) * cfg.d_model   # the RMSNorm gains
    if n_params - gains != cfg.param_count():
        raise AssertionError(f"{n_params} parameters ({gains} norm gains), "
                             f"the config counts {cfg.param_count()}")
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, LM_PREFILL_S))).to(device)
    torch.cuda.synchronize()
    detail = {"params": n_params, "init_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    rec, kdetail = flash_kernel_phase(torch, device, params, cfg, tokens,
                                      rng)
    detail.update(kdetail)
    detail["flash_checks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    detail["prefill"] = prefill_phase(torch, device, params, cfg, tokens,
                                      launches)
    detail["prefill"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    detail["prefill"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    detail["gate"] = prefill_gate(torch, device, cfg, rng, launches)
    detail["gate"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    detail["serve"] = serve_phase_lm(torch, device, params, cfg, launches)
    detail["serve"]["phase_s"] = time.perf_counter() - t0
    return rec, detail, launches


def fig9(torch):
    """(a) The Fig. 9 series: ``fuse_experiment(g, 1000, seed=0)`` for
    g = 1..4, gated as the reference's ``test_fig9_fuse_scaling``, and
    §5.2's bandwidth arithmetic at the Fuse4 average period."""
    from repro_torch.core.routing import (aggregate_bandwidth_model,
                                          fuse_experiment)

    t0 = time.perf_counter()
    stats = [fuse_experiment(g, n_trials=FIG9_TRIALS, seed=FIG9_SEED)
             for g in (1, 2, 3, 4)]
    avgs = [st["avg_cycles"] for st in stats]
    if avgs != sorted(avgs) or not 4.0 <= avgs[-1] <= 6.5 \
            or any(hi - lo > 1.5 for lo, hi in zip(avgs, avgs[1:])) \
            or min(avgs) < 3.0:
        raise AssertionError(f"Fig. 9 averages {avgs} break the reference's "
                             "conditions")
    period_ns = avgs[-1] * FIG9_PERIOD_NS
    bw = aggregate_bandwidth_model(period_ns)
    return {"series": stats, "fuse4_period_ns": period_ns,
            "effective_TBps": bw["effective_Bps"] / 1e12,
            "raw_TBps": bw["raw_Bps"] / 1e12, "paper_TBps": PAPER_TBPS,
            "host_s": time.perf_counter() - t0}


def hop_waves(item, widths):
    """(b) Each hop of the first batch as Block-Message waves over P = 16:
    every wave routed by Algorithm 1 and validated, Σ ``total_nnz`` equal
    to the off-diagonal nnz, Σ ``total_msgs`` equal to the distinct
    off-diagonal rows ``sender_merge_flat`` gives over the senders, and the
    analytic hypercube bytes equal to the topology's plan."""
    from repro_torch.core.blockmsg import (build_waves, sender_merge_flat,
                                           wave_statistics)
    from repro_torch.core.routing import route_messages, validate_routing
    from repro_torch.core.schedule import compare_schedules
    from repro_torch.distributed import schedule_bytes
    from repro_torch.engine.registry import get_topology
    from repro_torch.graph.partition import block_partition

    P, out = TRAIN_CORES, {}
    for hop, coo in enumerate(item[0].layers):
        t0 = time.perf_counter()
        blocked = block_partition(coo, P)
        waves = build_waves(blocked, WAVE_GROUP)
        off_nnz = sum(len(e[0]) for (i, j), e in blocked.block_edges.items()
                      if i != j)
        dpc = blocked.dst_per_core
        off_rows = 0
        for j in range(P):
            rows = sender_merge_flat(blocked, j)[0]
            off_rows += len(np.unique(rows[rows // dpc != j]))
        if sum(w.total_nnz for w in waves) != off_nnz:
            raise AssertionError(f"hop {hop}: the waves carry "
                                 f"{sum(w.total_nnz for w in waves)} edges, "
                                 f"the blocks off the diagonal {off_nnz}")
        if sum(w.total_msgs for w in waves) != off_rows:
            raise AssertionError(f"hop {hop}: the waves send "
                                 f"{sum(w.total_msgs for w in waves)} "
                                 f"messages, sender_merge_flat gives "
                                 f"{off_rows} off-diagonal rows")
        per_wave = []
        for w in waves:
            res = route_messages(w.src, w.dst, seed=w.stage)
            validate_routing(res, w.src, w.dst)
            per_wave.append({"stage": w.stage, "blocks": len(w.messages),
                             **compare_schedules(w.src, w.dst, seed=w.stage)})
        d = widths[hop]
        analytic = schedule_bytes(coo.n_dst, coo.n_src, d, P)
        plan = get_topology("hypercube").plan(coo.n_dst, d, P)
        if analytic["hypercube_bytes_per_device"] != plan.bytes_per_core:
            raise AssertionError(f"hop {hop}: schedule_bytes "
                                 f"{analytic['hypercube_bytes_per_device']} "
                                 f"!= the hypercube plan's "
                                 f"{plan.bytes_per_core}")
        out[f"hop{hop}"] = {
            "n_dst": coo.n_dst, "n_src": coo.n_src, "nnz": int(coo.nnz),
            "d": d, "stats": wave_statistics(waves), "waves": per_wave,
            "off_diagonal_rows": off_rows, "schedule_bytes": analytic,
            "host_s": time.perf_counter() - t0}
    return out


def per_core_grads(torch, bundle, batch, ws):
    """The gradient of each core's rows' share of the bundle's loss (the
    global-batch mean NLL), ``[P, n_params]`` flat, and the bundle's own
    gradient of that loss."""
    import torch.nn.functional as F

    P = bundle.n_cores
    logits = bundle._forward([{"w": w} for w in ws], batch["edges"],
                             batch["dims"], batch["x"])
    nll = F.cross_entropy(logits, batch["labels"], reduction="none")
    shares = nll.reshape(P, -1).sum(1) / nll.numel()
    flat = [torch.cat([g.reshape(-1) for g in torch.autograd.grad(
        shares[p], ws, retain_graph=True)]) for p in range(P)]
    whole = torch.autograd.grad(bundle.loss([{"w": w} for w in ws], batch),
                                ws)
    return torch.stack(flat), torch.cat([g.reshape(-1) for g in whole])


def weight_bank_sync(torch, device, tds, item, launches):
    """(c) Phase 7's seeded weights and first batch at P = 16: the 16
    per-core gradients sum to the bundle's; ``compressed_psum`` of them on
    the card equals the port's CPU run bit for bit and the exact sum within
    ``PSUM_RTOL``; ``EF_REPEATS`` error-feedback steps keep the mean's bias
    under ``EF_BIAS``; ``compressed_psum`` and the f32 fold timed with CUDA
    events beside their wire bytes."""
    from repro_torch.distributed import (compressed_psum, ef_compress_grads,
                                         hypercube_allgather,
                                         hypercube_reduce_scatter,
                                         init_error_state)
    from repro_torch.engine import Engine

    P = TRAIN_CORES
    bundle = Engine("ell+pipelined").build(n_cores=P, device=device)
    batch = bundle.shard_batch(*item)
    ws = [torch.from_numpy(p["w"]).to(device).requires_grad_(True)
          for p in train_params(tds)]
    stacked, whole = counted(launches, per_core_grads, torch, bundle, batch,
                             ws)
    n = stacked.shape[1]
    sum_err = float((stacked.double().sum(0) - whole.double()).abs().max()
                    / whole.abs().max())
    if sum_err > GRAD_SUM_RTOL:
        raise AssertionError(f"the per-core gradients sum to the bundle's "
                             f"within {sum_err}, over {GRAD_SUM_RTOL}")
    stacked = stacked.detach().contiguous()
    card = counted(launches, compressed_psum, stacked, n_cores=P)
    cpu = compressed_psum(stacked.cpu(), n_cores=P)
    if not torch.equal(card.cpu(), cpu):
        raise AssertionError("compressed_psum on the card differs from the "
                             "CPU run")
    exact = stacked.double().sum(0)
    psum_err = float((card[0].double() - exact).abs().max()
                     / exact.abs().max())
    if psum_err >= PSUM_RTOL or not bool((card == card[:1]).all()):
        raise AssertionError(f"compressed_psum error {psum_err} (bound "
                             f"{PSUM_RTOL}) or cores disagree")
    shapes = [tuple(w.shape) for w in ws]
    sizes = [int(np.prod(sh)) for sh in shapes]
    grads = {f"w{i}": g.reshape(P, *sh) for i, (g, sh) in enumerate(zip(
        stacked.split(sizes, dim=1), shapes))}
    err = init_error_state({k: g[0] for k, g in grads.items()}, P)
    acc = {k: torch.zeros_like(g[0]) for k, g in grads.items()}
    for _ in range(EF_REPEATS):
        mean, err = counted(launches, ef_compress_grads, grads, err,
                            n_cores=P)
        for k in acc:
            acc[k] += mean[k][0]
    want = torch.cat([g.mean(0).reshape(-1) for g in grads.values()])
    got = torch.cat([a.reshape(-1) / EF_REPEATS for a in acc.values()])
    bias = float((got - want).abs().max() / want.abs().max())
    if bias >= EF_BIAS:
        raise AssertionError(f"error feedback left a bias of {bias} "
                             f"(bound {EF_BIAS})")

    def fold():
        red = hypercube_reduce_scatter(stacked.reshape(P, P, -1), P)
        return hypercube_allgather(red, P).reshape(P, -1)

    psum_ms = time_ms(torch, lambda: compressed_psum(stacked, n_cores=P))
    fold_ms = time_ms(torch, fold)
    ndim = P.bit_length() - 1
    int8_bytes = 2 * (n - n // P) + 4 * ndim + 4 * (P - 1)
    return {"n_params": n, "cores": P, "grad_sum_rel_err": sum_err,
            "psum_rel_err": psum_err, "card_equals_cpu": True,
            "ef_bias": bias, "ef_repeats": EF_REPEATS,
            "psum_ms": psum_ms, "f32_fold_ms": fold_ms,
            "wire_bytes_per_core": {"int8_and_scales": int8_bytes,
                                    "f32": 8 * (n - n // P)},
            "note": "one card: the exchange is a copy on the device, so the "
                    "times count rounds and copies, not a network"}


def network_phase(torch, device, tds, item):
    """Phase 13: the paper's network layer (:func:`fig9`,
    :func:`hop_waves`, :func:`weight_bank_sync`).  Fails past
    ``NETWORK_PHASE_S``.  Returns (record, launches by path)."""
    t0 = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)
    widths = {len(item[0].layers) - 1: item[1].shape[1], 0: HIDDEN}
    out = {"fig9": fig9(torch), "waves": hop_waves(item, widths),
           "sync": weight_bank_sync(torch, device, tds, item, launches)}
    out["phase_s"] = time.perf_counter() - t0
    if out["phase_s"] > NETWORK_PHASE_S:
        raise AssertionError(f"phase 13 took {out['phase_s']:.1f} s, over "
                             f"its {NETWORK_PHASE_S:.0f} s limit")
    return out, {"network weight-bank sync": launches}


def lm_full_width(torch, device, launches):
    """(a) ``train_lm`` on the published llama3.2-1b config on the card:
    finite losses, no ``flash_mha`` launch; ms per step (median of steps
    1-5), parameters and peak device memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_lm

    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counts = {}
    out = counted(counts, train_lm, LM_ARCH, smoke=False,
                  steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
                  seq=LM_TRAIN_SEQ, log_every=0, device=device)
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts.items():
        launches[k] += v
    if not all(np.isfinite(out["losses"])) or counts["flash_mha"]:
        raise AssertionError(f"full-width LM training: losses "
                             f"{out['losses']}, flash_mha launches "
                             f"{counts['flash_mha']}")
    n_params = (cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
                + cfg.d_model + cfg.n_layers * (
                    cfg.d_model * cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
                    + cfg.n_heads * cfg.hd * cfg.d_model
                    + 3 * cfg.d_model * cfg.d_ff + 2 * cfg.d_model))
    return {"arch": LM_ARCH, "layers": cfg.n_layers, "params": n_params,
            "steps": LM_TRAIN_STEPS, "batch": LM_TRAIN_BATCH,
            "seq": LM_TRAIN_SEQ, "losses": out["losses"],
            "ms_per_step_median": float(np.median(out["step_s"][1:]) * 1e3),
            "ms_per_step": [t * 1e3 for t in out["step_s"]],
            "peak_bytes": int(peak), "peak_above_start_bytes":
            int(peak - base), "state_bytes": 4 * 4 * n_params}


def lm_train_gate(torch, device, launches):
    """(b) A 2-layer model at full width: ``LM_TRAIN_GATE_STEPS`` AdamW
    steps on the card and on the port's CPU from the same seeded weights,
    losses within ``LM_TRAIN_LOSS_RTOL``."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = get_config(LM_ARCH).scaled(n_layers=LM_GATE_LAYERS)
    cpu_params = lm_params(torch, cfg, torch.device("cpu"), seed=2)
    losses = {}
    t0 = time.perf_counter()
    for where, params in (("card", copy.deepcopy(cpu_params).to(device)),
                          ("cpu", cpu_params)):
        dev = device if where == "card" else torch.device("cpu")
        opt = adamw(1e-3)
        state = opt[0](lm.param_tree(params))
        step = lm.train_step_fn(cfg, opt, chunk=16)
        losses[where] = []
        for i in range(LM_TRAIN_GATE_STEPS):
            b = {k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(
                0, i, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.vocab).items()}
            counts = {}
            params, state, m = counted(counts, step, params, state, b) \
                if where == "card" else step(params, state, b)
            for k, v in counts.items():
                launches[k] += v
            losses[where].append(float(m["loss"]))
        del params, state
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                 losses["cpu"]))
    if rel > LM_TRAIN_LOSS_RTOL:
        raise AssertionError(f"LM training card vs CPU: losses "
                             f"{losses} differ by {rel} relative")
    return {"layers": LM_GATE_LAYERS, "losses": losses,
            "card_vs_cpu_rel": rel, "s": time.perf_counter() - t0}


def lm_fault_path(torch, device, launches):
    """(c) The smoke config on the card: a worker dies at step
    ``LM_FAULT_AT`` (survivors [0, 1, 2], a checkpoint at the miss), the
    resume to ``LM_RESUME_STEPS`` equals an uninterrupted run, and
    ``examples/torch_elastic_restart.py`` exits 0."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import train_lm

    ck = os.path.join(OUT_DIR, "chip_smoke_lm_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(smoke=True, batch=LM_TRAIN_BATCH, seq=LM_FAULT_SEQ,
              log_every=0, device=device)
    counts = {}
    out = counted(counts, train_lm, LM_ARCH, steps=LM_FAULT_STEPS,
                  ckpt_dir=ck, fault_at=LM_FAULT_AT, **kw)
    saved = CheckpointManager(ck).latest_step()
    if out["survivors"] != [0, 1, 2] or saved != LM_FAULT_AT + 1:
        raise AssertionError(f"fault path: survivors {out['survivors']}, "
                             f"checkpoint at step {saved}")
    resumed = counted(counts, train_lm, LM_ARCH, steps=LM_RESUME_STEPS,
                      ckpt_dir=ck, resume=True, **kw)
    whole = counted(counts, train_lm, LM_ARCH, steps=LM_RESUME_STEPS, **kw)
    for k, v in counts.items():
        launches[k] += v
    tail = whole["losses"][saved:]
    drift = max(abs(a - b) for a, b in zip(resumed["losses"], tail))
    if len(resumed["losses"]) != len(tail) or drift > LM_RESUME_TOL:
        raise AssertionError(f"resume drift {drift} over {LM_RESUME_TOL}")
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.perf_counter()
    ex = subprocess.run([sys.executable, *ELASTIC_EXAMPLE_ARGS], cwd=HERE,
                        env=dict(os.environ, PYTHONPATH=SRC),
                        capture_output=True, text=True,
                        timeout=LM_TRAIN_PHASE_S)
    if ex.returncode != 0:
        raise AssertionError(f"torch_elastic_restart.py exited "
                             f"{ex.returncode}: {ex.stderr[-2000:]}")
    survivors = [ln for ln in ex.stdout.splitlines()
                 if ln.startswith("survivors:")]
    return {"survivors": out["survivors"], "checkpoint_step": saved,
            "resume_drift": drift, "losses": out["losses"],
            "resumed_losses": resumed["losses"],
            "example_s": time.perf_counter() - t0,
            "example_survivors": survivors}


def lm_train_phase(torch, device):
    """Phase 14: LM training (:func:`lm_full_width`, :func:`lm_train_gate`,
    :func:`lm_fault_path`).  Fails past ``LM_TRAIN_PHASE_S``.  Returns
    (record, launches by path)."""
    t0 = time.perf_counter()
    launches = {k: dict.fromkeys(KERNELS, 0)
                for k in ("lm training", "lm training gate",
                          "lm training fault path")}
    out = {"full": lm_full_width(torch, device, launches["lm training"])}
    torch.cuda.empty_cache()
    out["gate"] = lm_train_gate(torch, device, launches["lm training gate"])
    out["fault"] = lm_fault_path(torch, device,
                                 launches["lm training fault path"])
    out["phase_s"] = time.perf_counter() - t0
    if out["phase_s"] > LM_TRAIN_PHASE_S:
        raise AssertionError(f"phase 14 took {out['phase_s']:.1f} s, over "
                             f"its {LM_TRAIN_PHASE_S:.0f} s limit")
    return out, launches


def layer0_qkv(torch, params, cfg, tokens):
    """Layer 0's q, k, v on ``tokens`` [1, s] — the model's own projection
    and rotary embedding, K/V repeated to every query head — in
    ``flash_mha``'s heads-first layout ``[h, s, hd]``."""
    import torch.nn.functional as F

    from repro_torch.models import transformer as tf

    s = tokens.shape[1]
    with torch.no_grad():
        p = params.layers[0]
        x = tf.rmsnorm(F.embedding(tokens.long(), params.embed), p.ln_attn,
                       cfg.norm_eps)
        q, k, v = tf.gqa_project(x, p, cfg)
        pos = torch.arange(s, device=tokens.device)[None]
        q = tf.apply_rope(q, pos, cfg.rope_theta)
        k = tf.apply_rope(k, pos, cfg.rope_theta)
        k, v = tf._repeat_kv(k, v, cfg.n_heads)
        return tuple(tf.heads_first(t) for t in (q, k, v))


def window_kernel_phase(torch, device, qh, kh, vh, window, rng):
    """(a) The windowed ``flash_mha`` at gemma3's layer-0 shape (its own
    q, k, v; ``window`` its 1024 keys) against the plain version in f32
    and bf16, ``window >= s`` equal to the causal call bit for bit, the
    edge cases of ``WINDOW_EDGES``; event, kernel-only and host ms against
    the causal call at the same shape, the live-pair bound, the plain
    version and SDPA (memory-efficient, the backend that takes a mask) with
    the same boolean band mask.  Returns (record, detail)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_mha, mha_ref
    from repro_torch.kernels.flash import live_pairs
    from repro_torch.models import transformer as tf

    bh, s, hd = qh.shape
    blocks = dict(q_block=tf.Q_BLOCK, k_block=tf.K_BLOCK)

    def call():
        return flash_mha(qh, kh, vh, causal=True, window=window, **blocks)

    def causal_call():
        return flash_mha(qh, kh, vh, causal=True, **blocks)

    def plain():
        return mha_ref(qh, kh, vh, causal=True, q_block=tf.Q_BLOCK,
                       window=window)

    got = call()
    torch.cuda.synchronize()
    want = plain()
    errs = {"gemma3_layer0": max_err(got, want)}
    if not torch.isfinite(got).all() or errs["gemma3_layer0"] > FLASH_TOL:
        raise AssertionError(f"windowed flash_mha at gemma3's shape: max "
                             f"|err| {errs['gemma3_layer0']} > {FLASH_TOL}")
    i = torch.arange(s, device=device)
    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    q4, k4, v4 = qh[None], kh[None], vh[None]

    def sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  attn_mask=band)

    def sdpa_causal():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    lib_err = max_err(sdpa()[0], want)
    del got, want
    causal = causal_call()
    for w in (s, s + 1, 2 ** 31 - 1):
        if not torch.equal(flash_mha(qh, kh, vh, causal=True, window=w,
                                     **blocks), causal):
            raise AssertionError(f"flash_mha with window {w} >= s = {s} is "
                                 "not the causal call's bits")
    del causal
    qb, kb, vb = (t.to(torch.bfloat16) for t in (qh, kh, vh))
    got = flash_mha(qb, kb, vb, causal=True, window=window, **blocks)
    want = mha_ref(qb, kb, vb, causal=True, q_block=tf.Q_BLOCK,
                   window=window)
    errs["gemma3_layer0_bfloat16"] = max_err(got.float(), want.float())
    if errs["gemma3_layer0_bfloat16"] > FLASH_BF16_TOL:
        raise AssertionError(f"windowed flash_mha bf16: max |err| "
                             f"{errs['gemma3_layer0_bfloat16']}")
    del qb, kb, vb, got, want
    for e_bh, sq, sk, e_hd, w, dt in WINDOW_EDGES:
        dtype = getattr(torch, dt)
        a, b_, c = (torch.from_numpy(rng.standard_normal(
            (e_bh, n, e_hd)).astype(np.float32)).to(device, dtype)
            for n in (sq, sk, sk))
        out = flash_mha(a, b_, c, causal=True, window=w, q_block=8,
                        k_block=8)
        torch.cuda.synchronize()
        ref = mha_ref(a, b_, c, causal=True, q_block=128, window=w)
        key = f"bh{e_bh}_sq{sq}_sk{sk}_hd{e_hd}_w{w}_{dt}"
        errs[key] = max_err(out.float(), ref.float())
        tol = FLASH_BF16_TOL if dt == "bfloat16" else FLASH_TOL
        if out.dtype != dtype or not torch.isfinite(out.float()).all() \
                or errs[key] > tol:
            raise AssertionError(f"windowed flash_mha {key}: max |err| "
                                 f"{errs[key]} > {tol}")
    peaks = device_peaks(torch)
    bound_ms, bound_by = flash_bound(bh, s, hd, True, 4, peaks.bw,
                                     peaks.tf32, products=3, window=window)
    only = kernel_ms(torch, call, flash_mha)
    causal_only = kernel_ms(torch, causal_call, flash_mha)
    rec = {"max_abs_err": max(e for k, e in errs.items()
                              if not k.endswith("bfloat16")),
           "max_abs_err_bf16": max(e for k, e in errs.items()
                                   if k.endswith("bfloat16")),
           "ms": time_ms(torch, call),
           "plain_ms": time_ms(torch, plain, YARDSTICK_REPS),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": time_ms(torch, sdpa, YARDSTICK_REPS),
           "kernel_only_ms": only[0], "kernel_only_count": only[1],
           "host_ms": host_ms(torch, call),
           "library_kernel_only_ms": queued_ms(torch, sdpa)[0]}
    detail = {"shape": [bh, s, hd], "window": window,
              "max_abs_err": errs, "sdpa_vs_plain_max_abs_err": lib_err,
              "causal_ms": time_ms(torch, causal_call),
              "causal_kernel_only_ms": causal_only[0],
              "causal_library_ms": time_ms(torch, sdpa_causal,
                                           YARDSTICK_REPS),
              "causal_library_kernel_only_ms": queued_ms(torch,
                                                         sdpa_causal)[0],
              "causal_bound_ms": flash_bound(bh, s, hd, True, 4, peaks.bw,
                                             peaks.tf32, products=3)[0],
              "live_pairs": live_pairs(s, s, True, window),
              "causal_live_pairs": live_pairs(s, s, True)}
    del band
    return rec, detail


def timed_prefills(torch, params, cfg, batch, launches, key, want):
    """``prefill_fn`` on ``batch``: 1 warm-up and ``FAMILY_PREFILL_REPS``
    measured, each counted on its own; every call must launch exactly
    ``want`` (kernel → count, the others 0) and give finite logits.
    Returns (median ms, peak bytes above the start)."""
    from repro_torch.models import lm

    prefill = lm.prefill_fn(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(1 + FAMILY_PREFILL_REPS):
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = counted(counts, prefill, params, batch)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        got = {k: counts.get(k, 0) for k in KERNELS if counts.get(k, 0)}
        if got != {k: n for k, n in want.items() if n} \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"{key}: launched {got}, expected {want} "
                                 f"(logits finite: "
                                 f"{bool(torch.isfinite(logits).all())})")
        for k, n in counts.items():
            launches[key][k] += n
        del logits
    peak = torch.cuda.max_memory_allocated() - base
    return float(np.median(times)), int(peak)


def card_vs_cpu(torch, device, cfg, seed, batch_np, launches, key, want):
    """Last-position prefill logits of ``cfg`` (seeded weights drawn on the
    CPU and copied to the card) on the card against the port's CPU run,
    within ``LM_LOGIT_TOL``; the card's launches must be ``want``."""
    import copy

    from repro_torch.models import lm

    cpu_params = lm_params(torch, cfg, torch.device("cpu"), seed)
    card_params = copy.deepcopy(cpu_params).to(device)
    prefill = lm.prefill_fn(cfg)
    counts = {}
    card = counted(counts, prefill, card_params,
                   {k: torch.from_numpy(v).to(device)
                    for k, v in batch_np.items()})
    got = {k: counts.get(k, 0) for k in KERNELS if counts.get(k, 0)}
    if got != {k: n for k, n in want.items() if n}:
        raise AssertionError(f"{key}: launched {got}, expected {want}")
    for k, n in counts.items():
        launches[key][k] += n
    del card_params
    t0 = time.perf_counter()
    cpu = prefill(cpu_params, {k: torch.from_numpy(v)
                               for k, v in batch_np.items()})
    cpu_s = time.perf_counter() - t0
    err = max_err(card.cpu(), cpu)
    if err > LM_LOGIT_TOL or not torch.isfinite(card).all():
        raise AssertionError(f"{key}: card vs CPU logits differ by {err}")
    return {"layers": cfg.n_layers, "card_vs_cpu_max_abs": err,
            "cpu_s": cpu_s}


def gemma_family(torch, device, rng, launches, during_gate):
    """(a) and (b): gemma3-27b at full width cut to ``GEMMA_LAYERS`` layers
    (one 5:1 local:global period): the window kernel on layer 0's own
    q, k, v; a prefill at s = 16384 launching ``flash_mha`` once and its
    windowed form 5 times; card vs CPU at 2 layers, s = 9216.
    ``during_gate()`` is called as the gate starts (the card is idle for
    most of it, while the CPU computes its half)."""
    from repro_torch.configs import get_config

    cfg = get_config(GEMMA_ARCH).scaled(n_layers=GEMMA_LAYERS)
    params = lm_params(torch, cfg, device, seed=3)
    n_params = sum(p.numel() for p in params.parameters())
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, FAMILY_S))).to(device)
    qkv = layer0_qkv(torch, params, cfg, tokens)
    krec, kdetail = window_kernel_phase(torch, device, *qkv,
                                        cfg.sliding_window, rng)
    del qkv
    n_local = sum(1 for i in range(cfg.n_layers)
                  if (i + 1) % cfg.global_every)
    ms, peak = timed_prefills(torch, params, cfg, {"tokens": tokens},
                              launches, "gemma3 prefill s=16384",
                              {"flash_mha": cfg.n_layers - n_local,
                               "flash_mha_window": n_local})
    del params, tokens
    torch.cuda.empty_cache()
    during_gate()
    gate_cfg = cfg.scaled(n_layers=FAMILY_GATE_LAYERS)
    gate = card_vs_cpu(torch, device, gate_cfg, 4, {
        "tokens": rng.integers(0, cfg.vocab, (1, FAMILY_GATE_S))},
        launches, "gemma3 prefill gate",
        {"flash_mha_window": FAMILY_GATE_LAYERS})
    torch.cuda.empty_cache()
    return krec, {"window_kernel": kdetail, "layers": cfg.n_layers,
                  "params": n_params, "s": FAMILY_S,
                  "flash_launches": cfg.n_layers - n_local,
                  "window_launches": n_local, "prefill_ms": ms,
                  "tokens_per_s": FAMILY_S / (ms / 1e3),
                  "peak_above_weights_bytes": peak,
                  "weight_bytes": 4 * n_params, "gate": gate}


class RouteLog:
    """Records each MoE layer's expert choices (``moe._route``'s ids) while
    active: ``with RouteLog() as log: ...`` then ``log.ids`` (one ``[b, s,
    k]`` host array per call, in call order)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.ids, self._mod, self._route = [], moe, moe._route

        def logged(x, p, cfg):
            out = self._route(x, p, cfg)
            self.ids.append(out[1].cpu().numpy())
            return out

        moe._route = logged
        return self

    def __exit__(self, *exc):
        self._mod._route = self._route


def moe_gate(torch, device, cfg, launches):
    """Card vs CPU for the MoE family at ``FAMILY_GATE_LAYERS`` layers,
    s = 9216, on seeded tokens: each layer's routes compared first,
    (token, layer) slots whose expert sets differ counted as flips (a
    router logit ~1e-7 apart can swap a near-tied k-th and (k+1)-th
    expert) and failing above ``MOE_FLIP_SHARE``; then the logits, within
    ``LM_LOGIT_TOL``, of up to ``MOE_GATE_ROWS`` rows (evenly spaced, the
    last among them) of the rows no flip reaches: a row whose own route
    agrees in every layer and that no earlier token's flip reaches through
    a later layer's attention (the rows before the first token flipped
    in a layer before the last).  A flipped token's changed hidden state
    moves the rows after it through attention by far more than 1e-3 (1.69
    on a route-agreeing row in one run), so those are counted, not
    compared."""
    import copy

    from repro_torch.models import lm, moe

    gcfg = cfg.scaled(n_layers=FAMILY_GATE_LAYERS)
    cpu_params = lm_params(torch, gcfg, torch.device("cpu"), seed=6)
    card_params = copy.deepcopy(cpu_params).to(device)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab,
                                               (1, FAMILY_GATE_S))
    logits_of = moe._logits
    moe._logits = lambda params, x, c: x       # keep the final hidden rows
    try:
        out = {}
        for where, params in (("card", card_params), ("cpu", cpu_params)):
            dev = device if where == "card" else torch.device("cpu")
            counts = {}
            t0 = time.perf_counter()
            with RouteLog() as log, torch.no_grad():
                hidden, _ = counted(counts, lm.forward, params, {
                    "tokens": torch.from_numpy(tokens).to(dev)}, gcfg)
            out[where] = (hidden, log.ids, time.perf_counter() - t0)
            if where == "card" and (counts["flash_mha"] != FAMILY_GATE_LAYERS
                                    or counts["flash_mha_window"]):
                raise AssertionError(f"moe gate launched {counts}")
            if where == "card":
                for k, n in counts.items():
                    launches["moe prefill gate"][k] += n
    finally:
        moe._logits = logits_of
    (card_h, card_ids, _), (cpu_h, cpu_ids, cpu_s) = out["card"], out["cpu"]
    if len(card_ids) != FAMILY_GATE_LAYERS or len(cpu_ids) != len(card_ids):
        raise AssertionError(f"moe gate logged {len(card_ids)} / "
                             f"{len(cpu_ids)} routings")
    flips = np.stack([(np.sort(a, -1) != np.sort(b, -1)).any(-1)[0]
                      for a, b in zip(card_ids, cpu_ids)])   # [layers, s]
    n_flips = int(flips.sum())
    share = n_flips / flips.size
    upstream = flips[:-1].any(0)
    first = int(np.argmax(upstream)) if upstream.any() else FAMILY_GATE_S
    clean = ~flips.any(0) & (np.arange(FAMILY_GATE_S) < first)
    idx = np.flatnonzero(clean)
    rows = idx[np.unique(np.linspace(0, len(idx) - 1, MOE_GATE_ROWS).round()
                         .astype(np.int64))] if len(idx) else idx
    with torch.no_grad():
        card = logits_of(card_params, card_h[:, torch.from_numpy(rows).to(
            device)], gcfg).cpu()
        cpu = logits_of(cpu_params, cpu_h[:, torch.from_numpy(rows)], gcfg)
    del card_params, card_h
    err = max_err(card, cpu)
    if share > MOE_FLIP_SHARE or not len(rows) or err > LM_LOGIT_TOL \
            or not torch.isfinite(card).all():
        raise AssertionError(f"moe card vs CPU: {n_flips} flipped routes "
                             f"(share {share}), logits on {len(rows)} rows "
                             f"no flip reaches differ by {err}")
    return {"layers": FAMILY_GATE_LAYERS, "s": FAMILY_GATE_S,
            "flipped_token_layer_slots": n_flips, "flip_share": share,
            "flips_per_layer": [int(f.sum()) for f in flips],
            "first_upstream_flip": first, "rows_unreached": int(clean.sum()),
            "rows_compared": len(rows), "card_vs_cpu_max_abs": err,
            "cpu_s": cpu_s}


def served(torch, device, arch, cfg, params, launches, key,
           requests=LM_REQUESTS, max_new=LM_MAX_NEW):
    """``lm_serve.Server`` (``LM_SLOTS`` slots, ``max_seq``
    ``LM_MAX_SEQ``) on the first ``requests`` of ``lm_serve.main``'s
    traffic for ``cfg``: every request completes with ``max_new`` tokens
    and nothing launches ``flash_mha``."""
    from repro_torch.launch.lm_serve import Request, Server

    srv = Server(arch, slots=LM_SLOTS, max_seq=LM_MAX_SEQ, device=device,
                 params=params, cfg=cfg)
    for i, prompt in enumerate(lm_traffic(cfg.vocab)[:requests]):
        srv.submit(Request(rid=i, prompt=prompt, max_new=max_new))
    counts = {}
    stats = counted(counts, srv.run)
    for k, n in counts.items():
        launches[key][k] += n
    done = {r.rid: r.generated for r in srv.completed}
    if sorted(done) != list(range(requests)) or any(
            len(g) != max_new for g in done.values()) \
            or counts["flash_mha"] or counts["flash_mha_window"]:
        raise AssertionError(f"{key}: completed {sorted(done)}, launches "
                             f"{counts}")
    return {"completed": len(done), "tokens": stats["tokens"],
            "steps": stats["steps"], "tok_per_s": stats["tok_per_s"],
            "decode_calls": srv.decode_calls,
            "wall_ms_per_decode_call": stats["wall_s"] / srv.decode_calls
            * 1e3}


def moe_family(torch, device, rng, launches):
    """(c) moonshot-v1-16b-a3b at full width cut to ``MOE_LAYERS`` layers:
    a prefill at s = 16384 (4 ``flash_mha`` launches), each layer's drop
    fraction at the default capacity factor, the server, decode against
    the teacher-forced forward at capacity factor 8, and the card vs CPU
    gate with its route flips."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm, moe

    cfg = get_config(MOE_ARCH).scaled(n_layers=MOE_LAYERS)
    params = lm_params(torch, cfg, device, seed=5)
    n_params = sum(p.numel() for p in params.parameters())
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, FAMILY_S))).to(device)
    ms, peak = timed_prefills(torch, params, cfg, {"tokens": tokens},
                              launches, "moe prefill s=16384",
                              {"flash_mha": cfg.n_layers})
    drops, ffn = [], moe.moe_ffn

    def dropping(x, p, c, capacity_factor=1.25, ep_spec=None):
        drops.append(moe.drop_fraction(x, p, c, capacity_factor))
        return ffn(x, p, c, capacity_factor, ep_spec)

    moe.moe_ffn = dropping
    try:
        lm.prefill_fn(cfg)(params, {"tokens": tokens})
    finally:
        moe.moe_ffn = ffn
    del tokens
    serve = served(torch, device, MOE_ARCH, cfg, params, launches,
                   "moe serve")
    seq = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, LM_TF_S))).to(device)
    with torch.no_grad():
        full, _ = counted(launches["moe decode vs forward"],
                          moe.moe_forward, params, seq, cfg,
                          capacity_factor=MOE_DECODE_CF)
        cache = lm.init_cache(cfg, 1, LM_TF_S, dtype=torch.float32,
                              device=device)
        outs = []
        for t in range(LM_TF_S):
            lg, cache = counted(launches["moe decode vs forward"],
                                moe.moe_decode_step, params, cache,
                                seq[:, t:t + 1], t, cfg,
                                capacity_factor=MOE_DECODE_CF)
            outs.append(lg[:, 0])
    tf_err = max_err(torch.stack(outs, 1), full)
    if tf_err > LM_LOGIT_TOL:
        raise AssertionError(f"moe decode vs teacher-forced logits differ by "
                             f"{tf_err}")
    del params, cache, full
    torch.cuda.empty_cache()
    gate = moe_gate(torch, device, cfg, launches)
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "params": n_params, "s": FAMILY_S,
            "prefill_ms": ms, "tokens_per_s": FAMILY_S / (ms / 1e3),
            "peak_above_weights_bytes": peak, "weight_bytes": 4 * n_params,
            "drop_fraction_per_layer": drops, "serve": serve,
            "decode_vs_forward_max_abs": tf_err, "gate": gate}


def recurrent_families(torch, device, rng, launches):
    """(d) mamba2-1.3b (48 layers: no ``flash_mha`` at s = 16384) and
    zamba2-1.2b (38 layers: one launch per shared-block application, 6)
    at their published configs: the prefill and the server
    (``RECURRENT_REQUESTS`` requests of ``RECURRENT_MAX_NEW`` tokens)."""
    from repro_torch.configs import get_config

    out = {}
    for arch, seed in ((SSM_ARCH, 7), (HYBRID_ARCH, 8)):
        cfg = get_config(arch)
        params = lm_params(torch, cfg, device, seed)
        n_params = sum(p.numel() for p in params.parameters())
        apps = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (1, FAMILY_S))).to(device)
        ms, peak = timed_prefills(torch, params, cfg, {"tokens": tokens},
                                  launches, f"{cfg.family} prefill s=16384",
                                  {"flash_mha": apps})
        del tokens
        out[arch] = {"layers": cfg.n_layers, "params": n_params,
                     "s": FAMILY_S, "flash_launches": apps,
                     "prefill_ms": ms, "tokens_per_s": FAMILY_S / (ms / 1e3),
                     "peak_above_weights_bytes": peak,
                     "serve": served(torch, device, arch, cfg, params,
                                     launches, f"{cfg.family} serve",
                                     RECURRENT_REQUESTS, RECURRENT_MAX_NEW)}
        del params
        torch.cuda.empty_cache()
    return out


class FlashLog:
    """Records each ``flash_mha`` call the transformer makes while active:
    ``(sq, sk, causal, window)``."""

    def __enter__(self):
        from repro_torch.models import transformer as tf

        self.calls, self._mod, self._fn = [], tf, tf.flash_mha

        def logged(q, k, v, **kw):
            self.calls.append((q.shape[1], k.shape[1], kw["causal"],
                               kw.get("window")))
            return self._fn(q, k, v, **kw)

        tf.flash_mha = logged
        return self

    def __exit__(self, *exc):
        self._mod.flash_mha = self._fn


def encdec_family(torch, device, rng, launches):
    """(d) seamless-m4t-medium at its published config (12 + 12 layers) on
    ``ENC_FRAMES`` stub frames and ``DEC_TOKENS`` decoder tokens: the
    encoder's 12 non-causal ``flash_mha`` calls over the frames, the cross
    attention's 12 non-causal calls with sq != sk, none for the decoder's
    self-attention; then ``prefill_cross`` and ``ENCDEC_DECODE_STEPS``
    greedy ``encdec_decode_step``s."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_frames
    from repro_torch.models import encdec, lm

    cfg = get_config(ENCDEC_ARCH)
    params = lm_params(torch, cfg, device, seed=9)
    n_params = sum(p.numel() for p in params.parameters())
    frames = torch.from_numpy(synthetic_frames(
        0, 1, ENC_FRAMES, cfg.d_model)).to(device)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, DEC_TOKENS))).to(device)
    batch = {"frames": frames, "tokens": tokens}
    with FlashLog() as log:
        ms, peak = timed_prefills(
            torch, params, cfg, batch, launches, "encdec prefill",
            {"flash_mha": cfg.enc_layers + cfg.n_layers})
    per_call = log.calls[:cfg.enc_layers + cfg.n_layers]
    enc = [c for c in per_call if c[0] == ENC_FRAMES]
    cross = [c for c in per_call if c[0] == DEC_TOKENS]
    if enc != [(ENC_FRAMES, ENC_FRAMES, False, None)] * cfg.enc_layers \
            or cross != [(DEC_TOKENS, ENC_FRAMES, False, None)] \
            * cfg.n_layers:
        raise AssertionError(f"encdec flash calls {per_call}")
    with torch.no_grad():
        counts = {}
        memory = counted(counts, encdec.encode, params, frames, cfg)
        t0 = time.perf_counter()
        cache = counted(counts, encdec.prefill_cross, params, memory, cfg, 1,
                        ENCDEC_DECODE_STEPS, torch.float32)
        step = lm.decode_fn(cfg)
        tok = tokens[:, -1:]
        picks = []
        for t in range(ENCDEC_DECODE_STEPS):
            lg, cache = counted(counts, step, params, cache, tok, t)
            if not torch.isfinite(lg).all():
                raise AssertionError(f"encdec decode step {t} not finite")
            tok = lg[:, -1].argmax(-1, keepdim=True)
            picks.append(int(tok))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    if counts["flash_mha"] != cfg.enc_layers or counts["flash_mha_window"]:
        raise AssertionError(f"encdec encode + decode launched {counts}")
    for k, n in counts.items():
        launches["encdec decode"][k] += n
    del params, memory, cache, frames, tokens
    torch.cuda.empty_cache()
    return {"enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers,
            "params": n_params, "frames": ENC_FRAMES,
            "dec_tokens": DEC_TOKENS, "prefill_ms": ms,
            "frames_per_s": ENC_FRAMES / (ms / 1e3),
            "peak_above_weights_bytes": peak,
            "encoder_calls": len(enc), "cross_calls": len(cross),
            "decode_steps": ENCDEC_DECODE_STEPS, "decode_tokens": picks,
            "prefill_cross_and_decode_s": decode_s}


def family_training(torch, device, launches):
    """(e) ``train_lm(arch, smoke=True, steps=FAMILY_TRAIN_STEPS)`` for one
    architecture of each new family, on the card and on the port's CPU from
    the same seeded weights (drawn on the CPU): finite losses within
    ``LM_TRAIN_LOSS_RTOL``."""
    import copy

    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import train_lm

    out = {}
    for i, arch in enumerate(FAMILY_TRAIN_ARCHS):
        cfg = get_smoke(arch)
        cpu_params = lm_params(torch, cfg, torch.device("cpu"), 10 + i)
        kw = dict(smoke=True, steps=FAMILY_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
                  seq=LM_TRAIN_SEQ, log_every=0)
        card = counted(launches["family training"], train_lm, arch,
                       device=device, params=copy.deepcopy(cpu_params).to(
                           device), **kw)
        cpu = train_lm(arch, device="cpu", params=cpu_params, **kw)
        rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                     cpu["losses"]))
        if not np.all(np.isfinite(card["losses"])) \
                or rel > LM_TRAIN_LOSS_RTOL:
            raise AssertionError(f"{arch} training card vs CPU: losses "
                                 f"{card['losses']} vs {cpu['losses']}")
        out[arch] = {"losses": card["losses"], "card_vs_cpu_rel": rel,
                     "ms_per_step": [t * 1e3 for t in card["step_s"]]}
    return out


def lm_families_phase(torch, device, rng):
    """Phase 15: the LM families.  Returns (the ``flash_mha_window``
    record, detail, launches by path).  Fails past
    ``LM_FAMILIES_PHASE_S``."""
    t0 = time.perf_counter()
    launches = {k: dict.fromkeys(KERNELS, 0) for k in (
        "gemma3 prefill s=16384", "gemma3 prefill gate",
        "moe prefill s=16384", "moe serve", "moe decode vs forward",
        "moe prefill gate", "ssm prefill s=16384", "ssm serve",
        "hybrid prefill s=16384", "hybrid serve", "encdec prefill",
        "encdec decode", "family training")}
    detail, example = {}, []

    def start_example():
        # the example serves on the card while the CPU computes gemma3's
        # gate, when nothing of this process is timed on the card
        example.append((time.perf_counter(), subprocess.Popen(
            [sys.executable, *SERVE_EXAMPLE_ARGS], cwd=HERE,
            env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))

    try:
        rec, detail["gemma3"] = gemma_family(torch, device, rng, launches,
                                             start_example)
        detail["gemma3"]["phase_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        detail["moe"] = moe_family(torch, device, rng, launches)
        detail["moe"]["phase_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        detail["recurrent"] = recurrent_families(torch, device, rng,
                                                 launches)
        detail["recurrent_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        detail["encdec"] = encdec_family(torch, device, rng, launches)
        detail["encdec"]["phase_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        detail["training"] = family_training(torch, device, launches)
        detail["training_s"] = time.perf_counter() - t1
        started, proc = example[0]
        out, err = proc.communicate(timeout=LM_FAMILIES_PHASE_S)
    finally:
        for _, proc in example:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"torch_serve_lm.py exited {proc.returncode}: "
                             f"{err[-2000:]}")
    detail["serve_example"] = {"started_after_s": started - t0,
                               "stdout": out.splitlines()[:1]}
    detail["phase_s"] = time.perf_counter() - t0
    if detail["phase_s"] > LM_FAMILIES_PHASE_S:
        raise AssertionError(f"phase 15 took {detail['phase_s']:.1f} s, over "
                             f"its {LM_FAMILIES_PHASE_S:.0f} s limit")
    return rec, detail, launches


def bwd_inputs(torch, device, rng, bh, sq, sk, hd, dtype):
    """Seeded q, k, v and the output's gradient dO."""
    return tuple(torch.from_numpy(rng.standard_normal(
        (bh, n, hd)).astype(np.float32)).to(device, dtype)
        for n in (sq, sk, sk, sq))


def bwd_gate(torch, key, q, k, v, do, causal, window):
    """``flash_mha_bwd`` on the kernel's own ``o`` and ``lse`` (``o`` the
    same bits as a call without ``lse``) against ``mha_bwd_ref`` on the
    same inputs; f32 also against a float64 plain backward (each of dq, dk,
    dv within ``BWD_F64_FACTOR`` × the plain f32 version's own L2
    distance, or ``BWD_F64_FLOOR`` of its norm), bf16 each within
    ``BWD_BF16_TOL`` of its own largest entry (``BWD_BF16_FLOOR`` at the
    least); a row with no live key has dq 0 and o the plain version's
    mean of v.  Returns (record, (o, lse))."""
    from repro_torch.kernels import (flash_mha, flash_mha_bwd, mha_bwd_ref,
                                     mha_ref)

    mask = dict(causal=causal, window=window)
    o, lse = flash_mha(q, k, v, q_block=1, k_block=1, return_lse=True,
                       **mask)
    if not torch.equal(o, flash_mha(q, k, v, q_block=1, k_block=1, **mask)):
        raise AssertionError(f"flash_mha {key}: o with lse is not o without")
    got = flash_mha_bwd(q, k, v, o, lse, do, **mask)
    torch.cuda.synchronize()
    want = mha_bwd_ref(q, k, v, o, lse, do, **mask)
    names = ("dq", "dk", "dv")
    rec = {"vs_plain": dict(zip(names, (max_err(a.float(), b.float())
                                        for a, b in zip(got, want))))}
    if any(g.dtype != q.dtype or not torch.isfinite(g.float()).all()
           for g in got):
        raise AssertionError(f"flash_mha_bwd {key}: wrong type or not "
                             "finite")
    dead = torch.isneginf(lse)
    rec["rows_without_keys"] = int(dead.sum())
    # such a row averages v, in the kernel as in the plain forward and the
    # reference, and gives dq nothing
    if dead.any():
        tol = FLASH_TOL if q.dtype == torch.float32 else FLASH_BF16_TOL
        plain_o = mha_ref(q, k, v, **mask)
        rec["dead_rows_o_vs_plain"] = max_err(o[dead].float(),
                                              plain_o[dead].float())
        if got[0][dead].any() or rec["dead_rows_o_vs_plain"] > tol:
            raise AssertionError(
                f"flash_mha_bwd {key}: a row with no live key has a nonzero "
                f"dq or an o {rec['dead_rows_o_vs_plain']} from the plain "
                "version's mean of v")
    if q.dtype == torch.float32:
        wide = tuple(t.double() for t in (q, k, v, do))
        o64, lse64 = mha_ref(*wide[:3], return_lse=True, **mask)
        exact = mha_bwd_ref(*wide[:3], o64, lse64, wide[3], **mask)
        po, plse = mha_ref(q, k, v, return_lse=True, **mask)
        plain = mha_bwd_ref(q, k, v, po, plse, do, **mask)
        rec["f64"] = {}
        for name, g, p, e in zip(names, got, plain, exact):
            kernel = float(torch.linalg.vector_norm(g.double() - e))
            own = float(torch.linalg.vector_norm(p.double() - e))
            limit = max(BWD_F64_FACTOR * own,
                        BWD_F64_FLOOR * float(torch.linalg.vector_norm(e)))
            rec["f64"][name] = {"kernel_l2": kernel, "plain_f32_l2": own,
                                "kernel_max": max_err(g, e),
                                "plain_f32_max": max_err(p, e)}
            if kernel > limit:
                raise AssertionError(f"flash_mha_bwd {key} {name}: {kernel} "
                                     f"from float64, over {limit} (plain "
                                     f"f32: {own})")
        del wide, o64, lse64, exact, po, plse, plain
    else:
        rec["bf16_limit"] = {}
        for name, w in zip(names, want):
            limit = max(BWD_BF16_TOL * float(w.float().abs().max()),
                        BWD_BF16_FLOOR)
            rec["bf16_limit"][name] = limit
            if rec["vs_plain"][name] > limit:
                raise AssertionError(f"flash_mha_bwd {key} {name}: "
                                     f"{rec['vs_plain'][name]} over {limit}")
    return rec, (o, lse)


def sdpa_bwd_ms(torch, q, k, v, do, window):
    """Event ms and kernel-only ms (:func:`queued_ms`) of SDPA's backward
    (``torch.autograd.grad`` through ``scaled_dot_product_attention`` on
    the memory-efficient backend, the one that takes f32 and a mask:
    ``is_causal``, or the boolean band mask with a window), the library's
    yardstick for ``flash_mha_bwd``, and the backend's name."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    s = q.shape[1]
    mask = None
    if window is not None:
        i = torch.arange(s, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                             is_causal=mask is None)
    def grad():
        return torch.autograd.grad(out, (q4, k4, v4), do[None],
                                   retain_graph=True)

    return (time_ms(torch, grad, YARDSTICK_REPS), queued_ms(torch, grad)[0],
            "memory-efficient")


def bwd_timed(torch, q, k, v, o, lse, do, window, peaks):
    """Event, kernel-only (``REPS`` calls queued, launches counted) and
    host ms of ``flash_mha_bwd``, the plain version's and SDPA's backward
    ms, and the bound: the five products at the forward's rate (f32: 3
    TF32 products at the TF32 rate; bf16: the bf16 rate)."""
    from repro_torch.kernels import flash_mha_bwd, mha_bwd_ref

    mask = dict(causal=True, window=window)

    def call():
        return flash_mha_bwd(q, k, v, o, lse, do, **mask)

    bh, s, hd = q.shape
    f32 = q.dtype == torch.float32
    bound_ms, bound_by = flash_bound(
        bh, s, hd, True, q.element_size(), peaks.bw,
        peaks.tf32 if f32 else peaks.bf16, products=3 if f32 else 1,
        window=window, backward=True)
    only = kernel_ms(torch, call, flash_mha_bwd)
    library, library_only, backend = sdpa_bwd_ms(torch, q, k, v, do, window)
    return {"ms": time_ms(torch, call), "kernel_only_ms": only[0],
            "kernel_only_count": only[1], "host_ms": host_ms(torch, call),
            "plain_ms": time_ms(torch, lambda: mha_bwd_ref(
                q, k, v, o, lse, do, **mask), YARDSTICK_REPS),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "fma_bound_ms": flash_bound(
                bh, s, hd, True, q.element_size(), peaks.bw, peaks.fp32,
                window=window, backward=True)[0],
            "library_ms": library, "library_kernel_only_ms": library_only,
            "library_backend": backend}


PTXAS_ENTRY = re.compile(r"Compiling entry function '[^']*?"
                         r"(dq_kernel|dkv_kernel)I(f|13__nv_bfloat16)"
                         r"Li(\d+)E")


def ptxas_usage(log):
    """Registers and local memory of each ``flash_mha_bwd`` instantiation
    from its build's ``ptxas -v`` output: ``{"dq_kernel<float, 64>":
    {"registers", "stack", "spill_stores", "spill_loads"}}`` (bytes)."""
    out, name = {}, None
    for line in log.splitlines():
        m = PTXAS_ENTRY.search(line)
        if m:
            dtype = "float" if m.group(2) == "f" else "bf16"
            name = f"{m.group(1)}<{dtype}, {m.group(3)}>"
            out[name] = {"registers": None, "stack": 0, "spill_stores": 0,
                         "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def bwd_kernel_phase(torch, device, rng):
    """(a) ``flash_mha_bwd`` at llama3.2-1b's layer shape (causal f32) and
    gemma3's (w 1024, f32 and bf16), and at ``BWD_EDGES``, each through
    :func:`bwd_gate`; the two shapes timed (:func:`bwd_timed`).  Returns
    the ``flash_mha_bwd`` and ``flash_mha_bwd_window`` records and the
    detail."""
    peaks = device_peaks(torch)
    detail, recs = {"shapes": {}, "edges": {}}, {}
    for arch, (bh, s, hd, window) in BWD_SHAPES.items():
        dtypes = ("float32",) if window is None else ("float32", "bfloat16")
        for dt in dtypes:
            q, k, v, do = bwd_inputs(torch, device, rng, bh, s, s, hd,
                                     getattr(torch, dt))
            key = bwd_shape_key(arch, dt)
            gate, (o, lse) = bwd_gate(torch, key, q, k, v, do, True, window)
            gate.update(bwd_timed(torch, q, k, v, o, lse, do, window,
                                  peaks))
            detail["shapes"][key] = gate
            recs[(window is not None, dt)] = gate
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    for bh, sq, sk, hd, causal, w, dt in BWD_EDGES:
        q, k, v, do = bwd_inputs(torch, device, rng, bh, sq, sk, hd,
                                 getattr(torch, dt))
        key = f"bh{bh}_sq{sq}_sk{sk}_hd{hd}_" \
              f"{'causal' if causal else 'full'}_w{w}_{dt}"
        detail["edges"][key] = bwd_gate(torch, key, q, k, v, do, causal,
                                        w)[0]

    def worst(dt, windowed=None):
        return max(max(g["vs_plain"].values())
                   for key, g in {**detail["shapes"],
                                  **detail["edges"]}.items()
                   if key.endswith(dt) and (windowed is None or (
                       "_wNone_" not in key) == windowed))

    out = {}
    for name, windowed in (("flash_mha_bwd", False),
                           ("flash_mha_bwd_window", True)):
        g = recs[(windowed, "float32")]
        out[name] = {k: g[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_kernel_only_ms", "kernel_only_ms", "kernel_only_count",
            "host_ms")}
        out[name]["max_abs_err"] = worst("float32", windowed)
        out[name]["max_abs_err_bf16"] = worst("bfloat16", windowed)
    return out["flash_mha_bwd"], out["flash_mha_bwd_window"], detail


def long_batch(torch, device, cfg, seed, step, batch, s):
    from repro_torch.data import make_lm_batch

    return {k: torch.from_numpy(v).to(device)
            for k, v in make_lm_batch(seed, step, batch, s, cfg.vocab).items()}


def long_full_width(torch, device, launches):
    """(b) llama3.2-1b at full width through ``build_step(cfg, "train")``
    (remat on, AdamW), batch 1 × ``LONG_TRAIN_S``: ``LONG_TRAIN_WARMUP`` +
    ``LONG_TRAIN_STEPS`` steps, each launching ``flash_mha`` 2 × 16 times
    (forward and recompute) and ``flash_mha_bwd`` 16 times, with finite
    losses and grad norms; ms a step and peak memory; then one more step
    under the profiler (after its warm-up step), whose device records give
    the forward's and the backward's kernel time in that step and their
    shares of its wall time; then at ``LONG_REMAT_LAYERS`` layers one step
    with remat on and one with it off, remat's peak the lower."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = get_config(LM_ARCH)
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_mha=2 * cfg.n_layers, flash_mha_bwd=cfg.n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm_params(torch, cfg, device, seed=3)
    state = adamw(3e-4)[0](lm.param_tree(params))
    step = build_step(cfg, "train")
    out = {"layers": cfg.n_layers, "s": LONG_TRAIN_S, "losses": [],
           "grad_norms": [], "ms_per_step": []}
    for i in range(LONG_TRAIN_WARMUP + LONG_TRAIN_STEPS):
        batch = long_batch(torch, device, cfg, 3, i, 1, LONG_TRAIN_S)
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = counted(counts, step, params, state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        out["ms_per_step"].append((time.perf_counter() - t0) * 1e3)
        if counts != want:
            raise AssertionError(f"long training step {i}: launched "
                                 f"{counts}, expected {want}")
        for k, v in counts.items():
            launches[f"lm long training s={LONG_TRAIN_S}"][k] += v
    out["peak_bytes"] = int(torch.cuda.max_memory_allocated())
    if not np.all(np.isfinite(out["losses"] + out["grad_norms"])):
        raise AssertionError(f"long training: losses {out['losses']}, grad "
                             f"norms {out['grad_norms']}")
    measured = out["ms_per_step"][LONG_TRAIN_WARMUP:]
    out["ms_per_step_median"] = float(np.median(measured))
    held = {"params": params, "state": state}

    def one_step():
        held["params"], held["state"], _ = step(held["params"],
                                                held["state"], batch)

    counts = {}
    events, wall = counted(counts, profiled, torch, one_step)
    if counts != {k: 2 * v for k, v in want.items()}:   # with the warm-up
        raise AssertionError(f"profiled long training steps: launched "
                             f"{counts}, expected twice {want}")
    for k, v in counts.items():
        launches[f"lm long training s={LONG_TRAIN_S}"][k] += v
    device_ms, _ = device_records(events)
    fwd_ms, fwd_n = device_records(events, "flash_mha_kernel")
    dq_ms, dq_n = device_records(events, "dq_kernel<")
    dkv_ms, dkv_n = device_records(events, "dkv_kernel<")
    out["profiled"] = {
        "step_ms": wall * 1e3, "device_ms": device_ms,
        "flash_mha_ms": fwd_ms, "flash_mha_records": fwd_n,
        "flash_mha_bwd_ms": dq_ms + dkv_ms,
        "flash_mha_bwd_records": dq_n + dkv_n}
    # None where the profiler recorded no device time (not measured)
    for name in ("device", "flash_mha", "flash_mha_bwd"):
        out["profiled"][f"{name}_share"] = (
            out["profiled"][f"{name}_ms"] / out["profiled"]["step_ms"]
            if device_ms else None)
    del params, state, step, held
    torch.cuda.empty_cache()
    cut = cfg.scaled(n_layers=LONG_REMAT_LAYERS)
    out["remat"] = {}
    for remat in (True, False):
        params = lm_params(torch, cut, device, seed=4)
        state = adamw(3e-4)[0](lm.param_tree(params))
        batch = long_batch(torch, device, cut, 4, 0, 1, LONG_TRAIN_S)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counts = {}
        t0 = time.perf_counter()
        params, state, m = counted(counts, build_step(cut, "train",
                                                      remat=remat),
                                   params, state, batch)
        loss = float(m["loss"])
        out["remat"][remat] = {
            "loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
            "peak_bytes": int(torch.cuda.max_memory_allocated()),
            "start_bytes": int(base), "launches": {
                k: v for k, v in counts.items() if v}}
        for k, v in counts.items():
            launches["lm long remat peaks"][k] += v
        del params, state, batch
        torch.cuda.empty_cache()
    on, off = out["remat"][True], out["remat"][False]
    if not on["peak_bytes"] < off["peak_bytes"] or on["loss"] != off["loss"] \
            or on["launches"].get("flash_mha") != 2 * LONG_REMAT_LAYERS \
            or off["launches"].get("flash_mha") != LONG_REMAT_LAYERS:
        raise AssertionError(f"remat at {LONG_REMAT_LAYERS} layers: "
                             f"{out['remat']}")
    return out


def long_gate_grads(torch, device):
    """(c)'s loss and gradient leaves (host numpy, ``lm.param_tree``'s
    order) of llama3.2-1b's smoke config (2 layers) at ``LONG_GATE_S``
    with remat, from weights drawn on the CPU, on ``device``."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves

    cfg = get_smoke(LM_ARCH)
    params = lm_params(torch, cfg, torch.device("cpu"), seed=5).to(device)
    batch = long_batch(torch, device, cfg, 5, 0, 1, LONG_GATE_S)
    leaves = tree_leaves(lm.param_tree(params))
    with torch.enable_grad():
        loss = lm.lm_loss(params, batch, cfg, remat=True)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.cpu().numpy() for g in grads]


def long_family(torch, device, i, arch):
    """(d) ``train_lm(arch, smoke=True)`` past the threshold on
    ``device`` from weights drawn on the CPU: its result."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import train_lm

    params = lm_params(torch, get_smoke(arch), torch.device("cpu"),
                       30 + i).to(device)
    return train_lm(arch, smoke=True, steps=LONG_FAMILY_STEPS,
                    batch=LONG_FAMILY_BATCH,
                    seq=LONG_FAMILY_S.get(arch, LONG_GATE_S), log_every=0,
                    device=device, params=params)


def long_cpu_side(path: str, jobs) -> None:
    """Part of phase 16's CPU halves, in a process of its own that runs
    beside the card's (a) and (b): ``jobs`` names (c) (``"gate"``: its
    loss and gradients) and (d)'s architectures (their losses), run on the
    port's CPU (the plain versions) and saved to ``path`` (``.npz``)."""
    sys.path.insert(0, SRC)
    import torch

    torch.set_num_threads(LONG_CPU_THREADS)
    cpu = torch.device("cpu")
    out = {}
    for job in jobs:
        t0 = time.perf_counter()
        if job == "gate":
            loss, grads = long_gate_grads(torch, cpu)
            out["gate_loss"] = np.float64(loss)
            out.update({f"gate_grad_{j}": g for j, g in enumerate(grads)})
        else:
            out[f"losses_{job}"] = np.asarray(long_family(
                torch, cpu, LONG_FAMILY_ARCHS.index(job), job)["losses"],
                np.float64)
        out[f"s_{job}"] = np.float64(time.perf_counter() - t0)
    np.savez(path, **out)


def lm_long_train_phase(torch, device, rng):
    """Phase 16: LM training past ``FLASH_THRESHOLD``.  The CPU halves of
    (c) and (d) start first, in processes of their own
    (:func:`long_cpu_side`, ``LONG_CPU_PARTS``); (a) :func:`bwd_kernel_phase`, (b)
    :func:`long_full_width`, then the card halves of (c) (loss within
    ``LM_TRAIN_LOSS_RTOL``, every gradient leaf within ``GRAD_RTOL`` /
    ``GRAD_ATOL``; ``flash_mha`` 2 and ``flash_mha_bwd`` 1 a layer) and
    (d) (losses within ``LM_TRAIN_LOSS_RTOL``, ``flash_mha_bwd``
    launched).  Returns (the ``flash_mha_bwd`` and
    ``flash_mha_bwd_window`` records, detail, launches by path).  Fails
    past ``LM_LONG_TRAIN_PHASE_S``."""
    from repro_torch.configs import get_smoke

    t0 = time.perf_counter()
    launches = {k: dict.fromkeys(KERNELS, 0) for k in (
        f"lm long training s={LONG_TRAIN_S}", "lm long remat peaks",
        "lm long gate", "lm long family training")}
    os.makedirs(OUT_DIR, exist_ok=True)
    paths = [os.path.join(OUT_DIR, f"chip_smoke_long_cpu_{i}.npz")
             for i in range(len(LONG_CPU_PARTS))]
    procs = []
    for path, jobs in zip(paths, LONG_CPU_PARTS):
        if os.path.exists(path):
            os.remove(path)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.long_cpu_side({path!r}, {jobs!r})"],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                (SRC, HERE))),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    try:
        rec, rec_w, detail = bwd_kernel_phase(torch, device, rng)
        detail["kernels_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        detail["full"] = long_full_width(torch, device, launches)
        detail["full_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        counts = launches["lm long gate"]
        loss, grads = counted(counts, long_gate_grads, torch, device)
        layers = get_smoke(LM_ARCH).n_layers
        if counts["flash_mha"] != 2 * layers \
                or counts["flash_mha_bwd"] != layers:
            raise AssertionError(f"long gate launched {counts}")
        fams = {}
        for i, arch in enumerate(LONG_FAMILY_ARCHS):
            counts = {}
            fams[arch] = counted(counts, long_family, torch, device, i,
                                 arch)
            fams[arch]["launches"] = {k: v for k, v in counts.items() if v}
            for k, v in counts.items():
                launches["lm long family training"][k] += v
            if counts["flash_mha_bwd"] + counts["flash_mha_bwd_window"] \
                    <= 0 or (arch == "gemma3-27b"
                             and not counts["flash_mha_bwd_window"]):
                raise AssertionError(f"{arch} past the threshold launched "
                                     f"{counts}")
        detail["card_halves_s"] = time.perf_counter() - t1
        for proc in procs:
            _, err = proc.communicate(timeout=max(
                LM_LONG_TRAIN_PHASE_S - (time.perf_counter() - t0), 1.0))
            if proc.returncode != 0:
                raise AssertionError(f"phase 16's CPU halves exited "
                                     f"{proc.returncode}: {err[-2000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cpu = {}
    for path in paths:
        with np.load(path) as part:
            cpu.update({k: part[k] for k in part.files})
        os.remove(path)
    rel = abs(loss - float(cpu["gate_loss"])) / abs(float(cpu["gate_loss"]))
    worst = max(float(np.max(np.abs(g - cpu[f"gate_grad_{j}"])
                             / (GRAD_ATOL + GRAD_RTOL
                                * np.abs(cpu[f"gate_grad_{j}"]))))
                for j, g in enumerate(grads))
    detail["gate"] = {"s": LONG_GATE_S, "layers": layers, "loss": loss,
                      "cpu_loss": float(cpu["gate_loss"]),
                      "card_vs_cpu_rel": rel, "grad_leaves": len(grads),
                      "grad_worst_share_of_tol": worst,
                      "cpu_s": float(cpu["s_gate"])}
    if rel > LM_TRAIN_LOSS_RTOL or worst > 1.0:
        raise AssertionError(f"long gate card vs CPU: {detail['gate']}")
    detail["families"] = {}
    for arch, card in fams.items():
        want = cpu[f"losses_{arch}"]
        rel = float(np.max(np.abs(np.asarray(card["losses"]) - want)
                           / np.abs(want)))
        detail["families"][arch] = {
            "s": LONG_FAMILY_S.get(arch, LONG_GATE_S),
            "losses": card["losses"], "cpu_losses": want.tolist(),
            "card_vs_cpu_rel": rel, "launches": card["launches"],
            "ms_per_step": [t * 1e3 for t in card["step_s"]],
            "cpu_s": float(cpu[f"s_{arch}"])}
        if not np.all(np.isfinite(card["losses"])) \
                or rel > LM_TRAIN_LOSS_RTOL:
            raise AssertionError(f"{arch} past the threshold, card vs CPU: "
                                 f"{detail['families'][arch]}")
    detail["phase_s"] = time.perf_counter() - t0
    if detail["phase_s"] > LM_LONG_TRAIN_PHASE_S:
        raise AssertionError(f"phase 16 took {detail['phase_s']:.1f} s, over "
                             f"its {LM_LONG_TRAIN_PHASE_S:.0f} s limit")
    return rec, rec_w, detail, launches


def bwd_shape_key(arch, dt):
    bh, s, hd, window = BWD_SHAPES[arch]
    return f"{arch}_bh{bh}_s{s}_hd{hd}_w{window}_{dt}"


def print_lm_long_train(rec, rec_w, detail, smi):
    shapes = detail["shapes"]
    for name, r, key in (
            ("flash_mha_bwd", rec, bwd_shape_key(LM_ARCH, "float32")),
            ("flash_mha_bwd_window", rec_w,
             bwd_shape_key("gemma3-27b", "float32"))):
        g = shapes[key]
        print(f"lm long kernels: {name} {key}: ms={r['ms']:.3f} "
              f"kernel_only={r['kernel_only_ms']:.3f} host="
              f"{r['host_ms']:.3f} bound={r['bound_ms']:.3f} "
              f"({r['bound_by']}; FMA {g['fma_bound_ms']:.3f}) plain="
              f"{r['plain_ms']:.3f} sdpa_bwd={r['library_ms']:.3f} "
              f"kernel_only={r['library_kernel_only_ms']:.3f} "
              f"({g['library_backend']}) ({smi}); vs float64 "
              + json.dumps(g["f64"]) + f"; |err| vs plain f32 "
              f"{r['max_abs_err']:.3g} bf16 {r['max_abs_err_bf16']:.3g}",
              flush=True)
    bf = shapes[bwd_shape_key("gemma3-27b", "bfloat16")]
    full = detail["full"]
    on, off = full["remat"][True], full["remat"][False]
    print(f"lm long kernels: gemma3 bf16 ms={bf['ms']:.3f} kernel_only="
          f"{bf['kernel_only_ms']:.3f} bound={bf['bound_ms']:.3f} sdpa_bwd="
          f"{bf['library_ms']:.3f} kernel_only="
          f"{bf['library_kernel_only_ms']:.3f}; {len(detail['edges'])} edge "
          "cases",
          flush=True)
    print(f"lm long training {LM_ARCH} full width ({full['layers']} layers, "
          f"remat, f32 AdamW, batch 1 x s={full['s']}): ms_per_step="
          f"{full['ms_per_step_median']:.3f} (median of "
          f"{LONG_TRAIN_STEPS}; {smi}) peak_gb={full['peak_bytes'] / 1e9:.2f}"
          " losses " + json.dumps(full["losses"])
          + "; profiled step " + json.dumps(full["profiled"])
          + f"; {LONG_REMAT_LAYERS} layers "
          f"peak_gb remat {on['peak_bytes'] / 1e9:.2f} vs off "
          f"{off['peak_bytes'] / 1e9:.2f}", flush=True)
    gate = detail["gate"]
    print(f"lm long gate ({gate['layers']} layers, smoke width, s="
          f"{gate['s']}): loss card vs CPU {gate['card_vs_cpu_rel']:.3g} "
          f"relative, gradients at {gate['grad_worst_share_of_tol']:.3g} of "
          f"their tolerance (CPU {gate['cpu_s']:.1f}s); families "
          + json.dumps({a: f["card_vs_cpu_rel"]
                        for a, f in detail["families"].items()})
          + f"; phase 16 {detail['phase_s']:.1f}s", flush=True)


def print_lm_families(rec, fam, smi):
    g, m, r, e = fam["gemma3"], fam["moe"], fam["recurrent"], fam["encdec"]
    k = g["window_kernel"]
    print(f"lm families window kernel: flash_mha_window gemma3 layer-0 "
          f"shape {k['shape']} w={k['window']}: {rec['ms']:.3f} ms (kernel "
          f"only {rec['kernel_only_ms']:.3f} of {rec['kernel_only_count']} "
          f"launches; bound {rec['bound_ms']:.3f} by {rec['bound_by']} from "
          f"{k['live_pairs']} live pairs; plain {rec['plain_ms']:.3f}; sdpa "
          f"with the band mask {rec['library_ms']:.3f} / kernel only "
          f"{rec['library_kernel_only_ms']:.3f}) vs the causal call "
          f"{k['causal_ms']:.3f} ms (kernel only "
          f"{k['causal_kernel_only_ms']:.3f}, bound "
          f"{k['causal_bound_ms']:.3f}; sdpa causal "
          f"{k['causal_library_ms']:.3f} / kernel only "
          f"{k['causal_library_kernel_only_ms']:.3f}); worst |err| f32 "
          f"{rec['max_abs_err']:.3g}, bf16 {rec['max_abs_err_bf16']:.3g} "
          f"over {len(k['max_abs_err'])} checks; w >= s bit-equal to causal "
          f"({smi})", flush=True)
    print(f"lm families gemma3-27b ({g['layers']} layers, {g['params']} "
          f"params, full width) prefill s={g['s']}: {g['prefill_ms']:.3f} ms "
          f"({g['tokens_per_s']:.1f} tokens/s; flash_mha "
          f"{g['flash_launches']} + windowed {g['window_launches']}) peak "
          f"above the weights {g['peak_above_weights_bytes'] / 1e9:.2f} GB; "
          f"card vs CPU ({g['gate']['layers']} layers, s={FAMILY_GATE_S}) "
          f"{g['gate']['card_vs_cpu_max_abs']:.3g} (CPU "
          f"{g['gate']['cpu_s']:.1f}s); {g['phase_s']:.1f}s", flush=True)
    print(f"lm families moonshot ({m['layers']} layers, {m['params']} "
          f"params) prefill s={m['s']}: {m['prefill_ms']:.3f} ms "
          f"({m['tokens_per_s']:.1f} tokens/s) peak above the weights "
          f"{m['peak_above_weights_bytes'] / 1e9:.2f} GB; drop fraction per "
          f"layer at cf 1.25 " + json.dumps(m["drop_fraction_per_layer"])
          + f"; serve {m['serve']['tokens']} tokens "
          f"{m['serve']['tok_per_s']:.2f} tok/s "
          f"({m['serve']['wall_ms_per_decode_call']:.3f} ms a decode call); "
          f"decode vs forward (cf 8) {m['decode_vs_forward_max_abs']:.3g}; "
          f"card vs CPU ({m['gate']['layers']} layers, s={m['gate']['s']}): "
          f"{m['gate']['flipped_token_layer_slots']} flipped routes "
          f"{json.dumps(m['gate']['flips_per_layer'])} (the first before "
          f"the last layer at token {m['gate']['first_upstream_flip']}), "
          f"logits on {m['gate']['rows_compared']} of the "
          f"{m['gate']['rows_unreached']} rows no flip reaches "
          f"{m['gate']['card_vs_cpu_max_abs']:.3g} (CPU "
          f"{m['gate']['cpu_s']:.1f}s); {m['phase_s']:.1f}s", flush=True)
    for arch, rr in r.items():
        print(f"lm families {arch} ({rr['layers']} layers, {rr['params']} "
              f"params) prefill s={rr['s']}: {rr['prefill_ms']:.3f} ms "
              f"({rr['tokens_per_s']:.1f} tokens/s, flash_mha "
              f"{rr['flash_launches']}) peak above the weights "
              f"{rr['peak_above_weights_bytes'] / 1e9:.2f} GB; serve "
              f"{rr['serve']['tokens']} tokens {rr['serve']['tok_per_s']:.2f} "
              f"tok/s ({rr['serve']['wall_ms_per_decode_call']:.3f} ms a "
              f"decode call)", flush=True)
    print(f"lm families seamless ({e['enc_layers']}+{e['dec_layers']} "
          f"layers, {e['params']} params) prefill {e['frames']} frames + "
          f"{e['dec_tokens']} tokens: {e['prefill_ms']:.3f} ms "
          f"({e['encoder_calls']} encoder + {e['cross_calls']} cross "
          f"flash_mha calls, non-causal) peak above the weights "
          f"{e['peak_above_weights_bytes'] / 1e9:.2f} GB; prefill_cross + "
          f"{e['decode_steps']} decode steps {e['prefill_cross_and_decode_s']:.2f}s; "
          f"training card vs CPU " + json.dumps(
              {a: t["card_vs_cpu_rel"] for a, t in fam["training"].items()})
          + f"; serve example exit 0 (run beside gemma3's CPU gate); "
          f"phase 15 {fam['phase_s']:.1f}s", flush=True)


def print_network(net, smi):
    f9, sync = net["fig9"], net["sync"]
    print(f"network Fig. 9 (fuse_experiment, {FIG9_TRIALS} trials, seed "
          f"{FIG9_SEED}): " + " ".join(
        f"Fuse{int(st['fuse'])} avg {st['avg_cycles']:.3f} p95 "
        f"{st['p95_cycles']:.0f} max {st['max_cycles']:.0f}"
        for st in f9["series"]) + f"; at {f9['fuse4_period_ns']:.3f} ns a "
        f"Fuse4 wave (250 MHz) the §5.2 model gives "
        f"{f9['effective_TBps']:.3f} TB/s effective (raw "
        f"{f9['raw_TBps']:.3f}; the paper's {f9['paper_TBps']}) "
        f"({f9['host_s']:.1f}s on the host)", flush=True)
    for hop, rec in net["waves"].items():
        st = rec["stats"]
        print(f"network waves {hop} (n_dst {rec['n_dst']}, n_src "
              f"{rec['n_src']}, nnz {rec['nnz']}, P={TRAIN_CORES}): "
              f"{st['waves']:.0f} waves, {st['blocks']:.0f} blocks, "
              f"{st['raw_edges']:.0f} edges -> {st['wire_messages']:.0f} "
              f"messages ({st['compression']:.4f}x); adaptive / static "
              f"cycles per wave " + json.dumps(
                  [(w["adaptive_cycles"], w["static_cycles"])
                   for w in rec["waves"]]) + f"; schedule_bytes at d "
              f"{rec['d']} " + json.dumps(rec["schedule_bytes"]), flush=True)
    print(f"network weight-bank sync ({sync['n_params']} params, P="
          f"{sync['cores']}): per-core gradients sum within "
          f"{sync['grad_sum_rel_err']:.3g}; compressed_psum card == CPU, "
          f"error {sync['psum_rel_err']:.4g}, EF bias over "
          f"{sync['ef_repeats']} steps {sync['ef_bias']:.4g}; "
          f"compressed_psum {sync['psum_ms']:.4f} ms vs f32 fold "
          f"{sync['f32_fold_ms']:.4f} ms, wire bytes a core "
          + json.dumps(sync["wire_bytes_per_core"]) + f" ({sync['note']}; "
          f"{smi}); phase 13 {net['phase_s']:.1f}s", flush=True)


def print_lm_train(lmt, smi):
    full, gate, fault = lmt["full"], lmt["gate"], lmt["fault"]
    print(f"lm training {full['arch']} full width ({full['layers']} layers, "
          f"{full['params']} params, f32 AdamW, batch {full['batch']} x seq "
          f"{full['seq']}): ms_per_step={full['ms_per_step_median']:.3f} "
          f"(median of steps 1-{full['steps'] - 1}; {smi}) peak_gb="
          f"{full['peak_bytes'] / 1e9:.2f} (params + grads + moments "
          f"{full['state_bytes'] / 1e9:.2f}) losses "
          + json.dumps(full["losses"]), flush=True)
    print(f"lm training gate ({gate['layers']} layers, full width): card vs "
          f"CPU losses within {gate['card_vs_cpu_rel']:.3g} relative "
          + json.dumps(gate["losses"]) + f" ({gate['s']:.1f}s); fault path: "
          f"survivors {fault['survivors']}, checkpoint at step "
          f"{fault['checkpoint_step']}, resume drift "
          f"{fault['resume_drift']:.3g}, elastic example exit 0 "
          f"({fault['example_s']:.1f}s); phase 14 {lmt['phase_s']:.1f}s",
          flush=True)


def hd80_forward(torch, qh, kh, vh, peaks):
    """(a)'s forward at the layer shape: f32 against ``mha_ref`` and a
    float64 plain forward (each within ``FLASH_TOL``), bf16 against
    ``mha_ref`` in bf16 (``FLASH_BF16_TOL``); event, kernel-only (launches
    counted) and host ms of the f32 call against the plain version, the
    bound (3 TF32 products at the TF32 rate) and SDPA (memory-efficient,
    causal); bf16 kernel-only ms against its bound and SDPA's flash
    backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_mha, mha_ref
    from repro_torch.models import transformer as tf

    blocks = dict(q_block=tf.Q_BLOCK, k_block=tf.K_BLOCK)
    bh, s, hd = qh.shape
    got = flash_mha(qh, kh, vh, causal=True, **blocks)
    torch.cuda.synchronize()
    want = mha_ref(qh, kh, vh, causal=True, q_block=tf.Q_BLOCK)
    exact = mha_ref(qh.double(), kh.double(), vh.double(), causal=True,
                    q_block=tf.Q_BLOCK)
    out = {"vs_plain": max_err(got, want),
           "f64": {"kernel": max_err(got, exact),
                   "plain_f32": max_err(want, exact)}}
    if not torch.isfinite(got).all() or out["vs_plain"] > FLASH_TOL \
            or out["f64"]["kernel"] > FLASH_TOL:
        raise AssertionError(f"flash_mha hd 80 layer shape: {out}")
    del got, want, exact
    q4, k4, v4 = qh[None], kh[None], vh[None]
    call = lambda: flash_mha(qh, kh, vh, causal=True, **blocks)  # noqa: E731
    only = kernel_ms(torch, call, flash_mha)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=True)
        out.update(library_ms=time_ms(torch, lib),
                   library_kernel_only_ms=queued_ms(torch, lib)[0])
    out.update(ms=time_ms(torch, call), kernel_only_ms=only[0],
               kernel_only_count=only[1], host_ms=host_ms(torch, call),
               plain_ms=time_ms(torch, lambda: mha_ref(
                   qh, kh, vh, causal=True, q_block=tf.Q_BLOCK),
                   YARDSTICK_REPS))
    out["bound_ms"], out["bound_by"] = flash_bound(
        bh, s, hd, True, 4, peaks.bw, peaks.tf32, products=3)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (qh, kh, vh))
    got = flash_mha(qb, kb, vb, causal=True, **blocks)
    torch.cuda.synchronize()
    want = mha_ref(qb, kb, vb, causal=True, q_block=tf.Q_BLOCK)
    out["bf16_vs_plain"] = max_err(got.float(), want.float())
    if not torch.isfinite(got.float()).all() \
            or out["bf16_vs_plain"] > FLASH_BF16_TOL:
        raise AssertionError(f"flash_mha hd 80 bf16: {out['bf16_vs_plain']}")
    del got, want
    call = lambda: flash_mha(qb, kb, vb, causal=True, **blocks)  # noqa: E731
    out["bf16_kernel_only_ms"] = kernel_ms(torch, call, flash_mha)[0]
    out["bf16_bound_ms"] = flash_bound(bh, s, hd, True, 2, peaks.bw,
                                       peaks.bf16)[0]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out["bf16_library_kernel_only_ms"] = queued_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qb[None], kb[None], vb[None], is_causal=True))[0]
    return out


def hd80_kernels(torch, device, qh, kh, vh, rng):
    """(a) Both kernels at head dim 80: the forward (:func:`hd80_forward`)
    and the backward (:func:`bwd_gate`, timed by :func:`bwd_timed`) at
    stablelm-3b's layer shape on layer 0's own q, k, v (f32 and bf16), and
    both at ``HD80_EDGES``, the forward against ``mha_ref`` there too.
    Returns the ``flash_mha_hd80`` and ``flash_mha_bwd_hd80`` records and
    the detail."""
    from repro_torch.kernels import flash_mha, flash_mha_bwd, mha_ref

    peaks = device_peaks(torch)
    detail = {"shape": list(qh.shape), "edges": {}}
    fwd = detail["forward"] = hd80_forward(torch, qh, kh, vh, peaks)
    do = torch.from_numpy(rng.standard_normal(tuple(qh.shape)).astype(
        np.float32)).to(device)
    gate, (o, lse) = bwd_gate(torch, "stablelm hd80 float32", qh, kh, vh,
                              do, True, None)
    gate.update(bwd_timed(torch, qh, kh, vh, o, lse, do, None, peaks))
    del o, lse
    detail["backward"] = gate
    low = [t.to(torch.bfloat16) for t in (qh, kh, vh, do)]
    gate16, (o, lse) = bwd_gate(torch, "stablelm hd80 bfloat16", *low, True,
                                None)
    gate16["kernel_only_ms"] = kernel_ms(torch, lambda: flash_mha_bwd(
        *low[:3], o, lse, low[3]), flash_mha_bwd)[0]
    detail["backward_bf16"] = gate16
    del low, o, lse, do
    fwd_errs, bwd_errs = {"float32": [], "bfloat16": []}, {
        "float32": [], "bfloat16": []}
    for bh, sq, sk, causal, w, dt in HD80_EDGES:
        dtype = getattr(torch, dt)
        q, k, v, g = bwd_inputs(torch, device, rng, bh, sq, sk, 80, dtype)
        key = f"bh{bh}_sq{sq}_sk{sk}_{'causal' if causal else 'full'}_w{w}" \
              f"_{dt}"
        out = flash_mha(q, k, v, causal=causal, window=w, q_block=1,
                        k_block=1)
        torch.cuda.synchronize()
        err = max_err(out.float(), mha_ref(q, k, v, causal=causal,
                                           window=w).float())
        tol = FLASH_BF16_TOL if dt == "bfloat16" else FLASH_TOL
        if not torch.isfinite(out.float()).all() or err > tol:
            raise AssertionError(f"flash_mha hd 80 {key}: {err} > {tol}")
        rec = bwd_gate(torch, f"hd80 {key}", q, k, v, g, causal, w)[0]
        detail["edges"][key] = {"forward_vs_plain": err, **rec}
        fwd_errs[dt].append(err)
        bwd_errs[dt].append(max(rec["vs_plain"].values()))
        del q, k, v, g, out
    bwd_errs["float32"].append(max(gate["vs_plain"].values()))
    bwd_errs["bfloat16"].append(max(gate16["vs_plain"].values()))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_kernel_only_ms", "kernel_only_ms", "kernel_only_count",
            "host_ms")
    rec_f = {k: fwd[k] for k in keys}
    rec_f["max_abs_err"] = max([fwd["vs_plain"]] + fwd_errs["float32"])
    rec_f["max_abs_err_bf16"] = max([fwd["bf16_vs_plain"]]
                                    + fwd_errs["bfloat16"])
    rec_b = {k: gate[k] for k in keys}
    rec_b["max_abs_err"] = max(bwd_errs["float32"])
    rec_b["max_abs_err_bf16"] = max(bwd_errs["bfloat16"])
    return rec_f, rec_b, detail


def stablelm_train(torch, device, cfg, params, launches):
    """(b)'s training step: ``build_step(cfg, "train")`` (remat, AdamW) at
    batch 1 × ``HD80_S``, 1 warm-up + 1 measured step, each launching
    ``flash_mha`` twice a layer (forward and recompute) and
    ``flash_mha_bwd`` once; finite losses; ms a step and peak memory."""
    from repro_torch.launch.steps import build_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_mha_hd80=2 * cfg.n_layers,
                flash_mha_bwd_hd80=cfg.n_layers)
    state = adamw(3e-4)[0](lm.param_tree(params))
    step = build_step(cfg, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "ms": []}
    for i in range(2):
        batch = long_batch(torch, device, cfg, HD80_GATE_SEED, i, 1, HD80_S)
        counts = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = counted(counts, step, params, state, batch)
        out["losses"].append(float(m["loss"]))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if counts != want:
            raise AssertionError(f"stablelm training step {i}: launched "
                                 f"{counts}, expected {want}")
        for k, v in counts.items():
            launches["stablelm training s=16384"][k] += v
    out["peak_bytes"] = int(torch.cuda.max_memory_allocated())
    out["ms_per_step"] = out["ms"][-1]
    if not np.all(np.isfinite(out["losses"])):
        raise AssertionError(f"stablelm training losses {out['losses']}")
    return out


def dryrun_vs_card(torch, device, cfg, launches):
    """(c) For (b)'s two cells (prefill at 1 × ``HD80_S`` and the training
    step at 1 × ``HD80_S``, f32 weights): the dry-run helper's trace on
    fake ``cuda`` tensors against the real call on the card, run with only
    its inputs live: (flops, bytes) equal to ``count_work`` of the call,
    and the traced ``peak_bytes`` within ``DRYRUN_PEAK_RTOL`` of
    ``torch.cuda.max_memory_allocated()`` over it."""
    from repro_torch.configs import Shape
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.roofline import count_work
    from repro_torch.launch.steps import build_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    out = {}
    for kind in ("prefill", "train"):
        shape = Shape(f"stablelm-3b-{cfg.n_layers}l-{kind}-{HD80_S}", kind,
                      HD80_S, 1)
        est = trace_step(cfg, shape, device=device,
                         param_dtype=torch.float32)
        torch.cuda.empty_cache()
        params = lm_params(torch, cfg, device, seed=HD80_GATE_SEED)
        batch = long_batch(torch, device, cfg, HD80_GATE_SEED, 0, 1, HD80_S)
        if kind == "prefill":
            batch.pop("labels")
            args = (params, batch)
        else:
            args = (params, adamw(3e-4)[0](lm.param_tree(params)), batch)
        step = build_step(cfg, kind)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        counts = {}
        flops, nbytes = counted(counts, count_work, step, *args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        for k, v in counts.items():
            launches[f"stablelm dry-run check {kind}"][k] += v
        rec = {"traced_flops": est["hlo_flops_per_device"],
               "traced_bytes": est["hlo_bytes_per_device"],
               "card_flops": flops, "card_bytes": nbytes,
               "traced_memory": est["memory"], "card_start_bytes": start,
               "card_peak_bytes": peak,
               "peak_rel": est["memory"]["peak_bytes"] / peak - 1.0,
               "trace_s": est["trace_s"], "fits": est["fits"],
               "launches": {k: v for k, v in counts.items() if v}}
        out[kind] = rec
        del params, batch, args, step
        torch.cuda.empty_cache()
        if (flops, nbytes) != (est["hlo_flops_per_device"],
                               est["hlo_bytes_per_device"]) \
                or abs(rec["peak_rel"]) > DRYRUN_PEAK_RTOL:
            raise AssertionError(f"dry run vs the card, stablelm {kind}: "
                                 f"{rec}")
    return out


def hd80_gate_inputs(torch, cfg, seed, s):
    """The gates' weights (drawn on the CPU) and tokens, the same in both
    processes."""
    params = lm_params(torch, cfg, torch.device("cpu"), seed)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (1, s + 1))
    return params, tokens


def hd80_gate_configs():
    """(b)'s two card-vs-CPU configs: stablelm-3b at full width cut to
    ``HD80_GATE_LAYERS`` layers (prefill), and its smoke config at head dim
    80 (training)."""
    from repro_torch.configs import get_config, get_smoke

    return (get_config(STABLELM_ARCH).scaled(n_layers=HD80_GATE_LAYERS),
            get_smoke(STABLELM_ARCH).scaled(head_dim=80))


def hd80_gate(torch, device, kind):
    """One of (b)'s gates on ``device``: ``"prefill"`` the last-position
    logits (host numpy), ``"train"`` the smoke training step's loss and
    gradient leaves (``lm.param_tree``'s order; remat on), both at
    ``HD80_GATE_S``."""
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves

    prefill_cfg, train_cfg = hd80_gate_configs()
    if kind == "prefill":
        params, tokens = hd80_gate_inputs(torch, prefill_cfg, HD80_GATE_SEED,
                                          HD80_GATE_S)
        params = params.to(device)
        logits = lm.prefill_fn(prefill_cfg)(params, {
            "tokens": torch.from_numpy(tokens[:, :-1]).to(device)})
        return logits.cpu().numpy()
    params, tokens = hd80_gate_inputs(torch, train_cfg, HD80_GATE_SEED + 1,
                                      HD80_GATE_S)
    params = params.to(device)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]).to(device),
             "labels": torch.from_numpy(tokens[:, 1:]).to(device)}
    leaves = tree_leaves(lm.param_tree(params))
    with torch.enable_grad():
        loss = lm.lm_loss(params, batch, train_cfg, remat=True)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.cpu().numpy() for g in grads]


def hd80_cpu_side(path: str) -> None:
    """Phase 17's CPU halves, in a process of its own beside the card's
    work: :func:`hd80_gate` on the port's CPU (the plain versions), saved
    to ``path`` (``.npz``)."""
    sys.path.insert(0, SRC)
    import torch

    torch.set_num_threads(HD80_CPU_THREADS)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    out = {"prefill_logits": hd80_gate(torch, cpu, "prefill"),
           "s_prefill": np.float64(time.perf_counter() - t0)}
    t0 = time.perf_counter()
    loss, grads = hd80_gate(torch, cpu, "train")
    out.update({"train_loss": np.float64(loss),
                "s_train": np.float64(time.perf_counter() - t0)})
    out.update({f"train_grad_{j}": g for j, g in enumerate(grads)})
    np.savez(path, **out)


def hd80_card_gates(torch, device, cpu, launches):
    """(b)'s gates: the card halves of :func:`hd80_gate` against the CPU's
    (``cpu``, :func:`hd80_cpu_side`'s arrays): prefill logits within
    ``LM_LOGIT_TOL``, the training loss within ``LM_TRAIN_LOSS_RTOL`` and
    every gradient leaf within ``GRAD_RTOL`` / ``GRAD_ATOL``; each launching
    the hd-80 kernels once a layer (``flash_mha_bwd`` and ``flash_mha``'s
    recompute in training)."""
    prefill_cfg, train_cfg = hd80_gate_configs()
    counts = {}
    logits = counted(counts, hd80_gate, torch, device, "prefill")
    if counts["flash_mha_hd80"] != prefill_cfg.n_layers:
        raise AssertionError(f"hd 80 prefill gate launched {counts}")
    for k, v in counts.items():
        launches["stablelm gates"][k] += v
    err = float(np.max(np.abs(logits.astype(np.float64)
                              - cpu["prefill_logits"])))
    counts = {}
    loss, grads = counted(counts, hd80_gate, torch, device, "train")
    if counts["flash_mha_hd80"] != 2 * train_cfg.n_layers \
            or counts["flash_mha_bwd_hd80"] != train_cfg.n_layers:
        raise AssertionError(f"hd 80 training gate launched {counts}")
    for k, v in counts.items():
        launches["stablelm gates"][k] += v
    rel = abs(loss - float(cpu["train_loss"])) / abs(float(cpu["train_loss"]))
    worst = max(float(np.max(np.abs(g - cpu[f"train_grad_{j}"])
                             / (GRAD_ATOL + GRAD_RTOL
                                * np.abs(cpu[f"train_grad_{j}"]))))
                for j, g in enumerate(grads))
    out = {"prefill": {"layers": prefill_cfg.n_layers, "s": HD80_GATE_S,
                       "card_vs_cpu_max_abs": err,
                       "cpu_s": float(cpu["s_prefill"])},
           "train": {"config": "smoke, head_dim 80", "s": HD80_GATE_S,
                     "loss": loss, "cpu_loss": float(cpu["train_loss"]),
                     "card_vs_cpu_rel": rel, "grad_leaves": len(grads),
                     "grad_worst_share_of_tol": worst,
                     "cpu_s": float(cpu["s_train"])}}
    if err > LM_LOGIT_TOL or not np.all(np.isfinite(logits)) \
            or rel > LM_TRAIN_LOSS_RTOL or worst > 1.0:
        raise AssertionError(f"hd 80 card vs CPU: {out}")
    return out


def run_example(path, args, counts):
    """``path`` (an example script) run in this process as ``__main__`` with
    ``args`` (none: the card, the example's defaults), its launches added
    to ``counts``; returns what it printed."""
    import contextlib
    import io
    import runpy

    argv, buf = sys.argv, io.StringIO()
    sys.argv = [path, *args]
    try:
        with contextlib.redirect_stdout(buf):
            counted(counts, runpy.run_path, os.path.join(HERE, path),
                    run_name="__main__")
    finally:
        sys.argv = argv
    return buf.getvalue()


def dryrun_records(out: str):
    """(c) The dry run's process: its records (``DRYRUN_RECORDS`` runnable
    cells, ``DRYRUN_SKIPS`` skips, ``stablelm-3b × prefill_32k`` among the
    records) summarized per cell."""
    with open(os.path.join(HERE, DRYRUN_ARGS[-1])) as f:
        records = json.load(f)
    cells = [r for r in records if not r.get("skipped")]
    skips = [r for r in records if r.get("skipped")]
    if len(cells) != DRYRUN_RECORDS or len(skips) != DRYRUN_SKIPS \
            or not any(r["arch"] == STABLELM_ARCH
                       and r["shape"] == "prefill_32k" for r in cells):
        raise AssertionError(f"dry run: {len(cells)} records, {len(skips)} "
                             f"skips: {out[-2000:]}")
    return {f"{r['arch']} x {r['shape']}": {
        "flops": r["hlo_flops_per_device"],
        "bytes": r["hlo_bytes_per_device"],
        "peak_bytes": r["memory"]["peak_bytes"], "fits": r["fits"],
        "dominant": r["roofline"]["dominant"],
        "t_compute_ms": r["roofline"]["t_compute"] * 1e3,
        "t_memory_ms": r["roofline"]["t_memory"] * 1e3,
        "trace_s": r["trace_s"]} for r in cells}


def hd80_phase(torch, device, rng):
    """Phase 17: head dim 80, the dry run, the examples.  The dry run
    (``DRYRUN_ARGS``, fake ``cuda`` tensors) and the CPU halves of (b)'s
    gates (:func:`hd80_cpu_side`) start first, in processes of their own;
    then (a) :func:`hd80_kernels` on layer 0 of stablelm-3b at full width
    cut to ``STABLELM_LAYERS`` layers, (b) its prefill at 1 × ``HD80_S``
    (one ``flash_mha`` launch a layer) and :func:`stablelm_train`, (c)
    :func:`dryrun_vs_card`, (d) both examples (:func:`run_example`), each
    launching its kernels, then (b)'s gates against the CPU halves and
    (c)'s records.  Returns (the ``flash_mha_hd80`` and
    ``flash_mha_bwd_hd80`` records, detail, launches by path).  Fails past
    ``HD80_PHASE_S``."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    launches = {k: dict.fromkeys(KERNELS, 0) for k in (
        "stablelm prefill s=16384", "stablelm training s=16384",
        "stablelm dry-run check prefill", "stablelm dry-run check train",
        "stablelm gates", *(f"example {p}" for p, _, _ in HD80_EXAMPLES))}
    os.makedirs(OUT_DIR, exist_ok=True)
    cpu_path = os.path.join(OUT_DIR, "chip_smoke_hd80_cpu.npz")
    for path in (cpu_path, os.path.join(HERE, DRYRUN_ARGS[-1])):
        if os.path.exists(path):
            os.remove(path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((SRC, HERE)))
    procs = {
        "dry run": subprocess.Popen(
            [sys.executable, *DRYRUN_ARGS], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "cpu halves": subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.hd80_cpu_side({cpu_path!r})"], cwd=HERE, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)}
    detail = {}
    try:
        cfg = get_config(STABLELM_ARCH).scaled(n_layers=STABLELM_LAYERS)
        if cfg.hd != 80:
            raise AssertionError(f"{STABLELM_ARCH} head dim {cfg.hd}")
        params = lm_params(torch, cfg, device, seed=HD80_GATE_SEED)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (1, HD80_S))).to(device)
        qkv = layer0_qkv(torch, params, cfg, tokens)
        rec, rec_b, detail["kernels"] = hd80_kernels(torch, device, *qkv,
                                                     rng)
        del qkv
        torch.cuda.empty_cache()
        detail["kernels_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        key = "stablelm prefill s=16384"
        ms, peak = timed_prefills(torch, params, cfg, {"tokens": tokens},
                                  launches, key,
                                  {"flash_mha_hd80": cfg.n_layers})
        n_params = sum(p.numel() for p in params.parameters())
        detail["model"] = {"layers": cfg.n_layers, "params": n_params,
                           "s": HD80_S, "prefill_ms": ms,
                           "tokens_per_s": HD80_S / (ms / 1e3),
                           "prefill_peak_above_weights_bytes": peak,
                           "weight_bytes": 4 * n_params}
        del tokens
        detail["model"]["train"] = stablelm_train(torch, device, cfg, params,
                                                  launches)
        del params
        torch.cuda.empty_cache()
        detail["model_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        detail["dryrun_vs_card"] = dryrun_vs_card(torch, device, cfg,
                                                  launches)
        detail["dryrun_vs_card_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        detail["examples"] = {}
        for path, args, kernels in HD80_EXAMPLES:
            counts = {}
            t2 = time.perf_counter()
            printed = run_example(path, args, counts)
            launches[f"example {path}"] = {k: counts.get(k, 0)
                                           for k in KERNELS}
            detail["examples"][path] = {
                "s": time.perf_counter() - t2,
                "launches": {k: v for k, v in counts.items() if v},
                "tail": printed.strip().splitlines()[-2:]}
            if any(counts.get(k, 0) <= 0 for k in kernels):
                raise AssertionError(f"{path} launched {counts}, expected "
                                     f"each of {kernels}")
        detail["examples_s"] = time.perf_counter() - t1
        waited = {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=max(
                HD80_PHASE_S - (time.perf_counter() - t0), 1.0))
            waited[name] = out if name == "dry run" else err
            if proc.returncode != 0:
                raise AssertionError(f"phase 17's {name} exited "
                                     f"{proc.returncode}: "
                                     f"{waited[name][-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    detail["dryrun"] = dryrun_records(waited["dry run"])
    detail["dryrun_tail"] = waited["dry run"].strip().splitlines()[-1]
    with np.load(cpu_path) as part:
        cpu = {k: part[k] for k in part.files}
    os.remove(cpu_path)
    detail["gates"] = hd80_card_gates(torch, device, cpu, launches)
    detail["phase_s"] = time.perf_counter() - t0
    if detail["phase_s"] > HD80_PHASE_S:
        raise AssertionError(f"phase 17 took {detail['phase_s']:.1f} s, over "
                             f"its {HD80_PHASE_S:.0f} s limit")
    return rec, rec_b, detail, launches


def print_hd80(rec, rec_b, detail, smi):
    k = detail["kernels"]
    fwd, bwd, b16 = k["forward"], k["backward"], k["backward_bf16"]
    print(f"hd80 kernels at stablelm-3b's layer shape {k['shape']} causal: "
          f"flash_mha_hd80 {rec['ms']:.3f} ms (kernel only "
          f"{rec['kernel_only_ms']:.3f} of {rec['kernel_only_count']} "
          f"launches, host {rec['host_ms']:.3f}; bound {rec['bound_ms']:.3f} "
          f"by {rec['bound_by']}; plain {rec['plain_ms']:.3f}; sdpa "
          f"{rec['library_ms']:.3f} / kernel only "
          f"{rec['library_kernel_only_ms']:.3f}) vs float64 "
          + json.dumps(fwd["f64"]) + f"; bf16 kernel only "
          f"{fwd['bf16_kernel_only_ms']:.3f} (bound "
          f"{fwd['bf16_bound_ms']:.3f}, sdpa flash "
          f"{fwd['bf16_library_kernel_only_ms']:.3f}); flash_mha_bwd_hd80 "
          f"{rec_b['ms']:.3f} ms (kernel only {rec_b['kernel_only_ms']:.3f} "
          f"of {rec_b['kernel_only_count']} launches, host "
          f"{rec_b['host_ms']:.3f}; bound {rec_b['bound_ms']:.3f} by "
          f"{rec_b['bound_by']}; plain {rec_b['plain_ms']:.3f}; sdpa_bwd "
          f"{rec_b['library_ms']:.3f} / kernel only "
          f"{rec_b['library_kernel_only_ms']:.3f}) vs float64 "
          + json.dumps(bwd["f64"]) + f"; bf16 kernel only "
          f"{b16['kernel_only_ms']:.3f}; |err| vs plain f32 "
          f"{rec['max_abs_err']:.3g} / {rec_b['max_abs_err']:.3g}, bf16 "
          f"{rec['max_abs_err_bf16']:.3g} / {rec_b['max_abs_err_bf16']:.3g} "
          f"over {len(k['edges'])} edge cases ({smi}; "
          f"{detail['kernels_s']:.1f}s)", flush=True)
    m, tr = detail["model"], detail["model"]["train"]
    g = detail["gates"]
    print(f"stablelm-3b full width {m['layers']} layers ({m['params']} "
          f"params, f32): prefill s={m['s']} {m['prefill_ms']:.3f} ms "
          f"(tokens_per_s={m['tokens_per_s']:.1f}, peak above weights "
          f"{m['prefill_peak_above_weights_bytes'] / 1e9:.2f} GB); training "
          f"step 1 x {m['s']} (remat, AdamW) {tr['ms_per_step']:.3f} ms "
          f"(warm-up {tr['ms'][0]:.3f}), peak {tr['peak_bytes'] / 1e9:.2f} "
          f"GB, losses {json.dumps(tr['losses'])}; card vs CPU: prefill "
          f"({g['prefill']['layers']} layers, s={g['prefill']['s']}) "
          f"{g['prefill']['card_vs_cpu_max_abs']:.3g}, smoke hd-80 training "
          f"loss {g['train']['card_vs_cpu_rel']:.3g} relative, gradients at "
          f"{g['train']['grad_worst_share_of_tol']:.3g} of their tolerance "
          f"({smi})", flush=True)
    for kind, r in detail["dryrun_vs_card"].items():
        print(f"dry run vs card, stablelm {kind}: flops "
              f"{r['traced_flops']} == {r['card_flops']}, bytes "
              f"{r['traced_bytes']} == {r['card_bytes']}; peak traced "
              f"{r['traced_memory']['peak_bytes']} vs card "
              f"{r['card_peak_bytes']} ({100 * r['peak_rel']:+.2f}%), "
              f"inputs traced {r['traced_memory']['argument_bytes']} vs card "
              f"{r['card_start_bytes']}", flush=True)
    print(f"dry run: {len(detail['dryrun'])} cells traced on fake cuda, "
          f"{DRYRUN_SKIPS} skips; {detail['dryrun_tail']}; examples "
          + json.dumps({p: {"s": round(e["s"], 1), "launches": e["launches"]}
                        for p, e in detail["examples"].items()})
          + f"; phase 17 {detail['phase_s']:.1f}s", flush=True)


# ---------------------------------------------------------------------------
# Phase 18: the torch.distributed mesh on one rank.
# ---------------------------------------------------------------------------
def mesh_grad_accum(torch, device, mesh):
    """``grad_accum`` over the mesh's ``model`` axis, bucketed or not,
    against the local call: (max |loss diff| + |grad diff|, all bit-equal)
    — one rank's sum is its own bits."""
    from repro_torch.distributed import grad_accum
    from repro_torch.distributed.sharding import use_mesh

    gen = torch.Generator(device="cpu").manual_seed(5)
    rows, d_in, d_out = MESH_GA_SHAPE
    params = {"w": torch.randn(d_in, d_out, generator=gen).to(device)}
    batch = {"x": torch.randn(rows, d_in, generator=gen).to(device),
             "y": torch.randn(rows, d_out, generator=gen).to(device)}

    def loss_fn(p, b):
        err = b["x"] @ p["w"] - b["y"]
        return (err * err).mean()

    local = grad_accum(loss_fn, params, batch, n_micro=2)
    same, worst = True, 0.0
    with use_mesh(mesh):
        for bucketed in (False, True):
            got = grad_accum(loss_fn, params, batch, n_micro=2,
                             axis_names=("model",), bucketed=bucketed)
            same &= torch.equal(got[0], local[0]) \
                and torch.equal(got[1]["w"], local[1]["w"])
            worst = max(worst, max_err(got[0], local[0]),
                        max_err(got[1]["w"], local[1]["w"]))
    return worst, bool(same)


def mesh_all_reduce(torch, tr, events):
    """The Weight-Bank sync's device time: the NCCL records of a
    profiled step (``events``; ms and record count), and one
    ``all_reduce`` of a buffer of the step's gradient size timed alone by
    CUDA events (median of ``REPS``)."""
    import torch.distributed as dist

    ms, count = 0.0, 0
    for name in ("nccl", "AllReduce"):
        got = device_records(events, name)
        if got[1] > count:
            ms, count = got
    n = sum(p["w"].numel() for p in tr.params) + 1
    buf = torch.zeros(n, dtype=torch.float32, device=tr.device)
    group = tr.bundle.layout.group
    alone = time_ms(torch, lambda: dist.all_reduce(buf, group=group))
    return {"profiled_ms": ms, "profiled_records": count,
            "alone_ms": alone, "floats": n}


def mesh_arm(torch, tr, base, what):
    """One arm of phase 18: ``MESH_WARMUP`` + ``MESH_STEPS`` steps of
    ``tr``, each counted on its own, its losses equal to phase 7's
    ``ell+pipelined`` losses (``base``) for the same steps and each step's
    ``spmm_ell`` / ``spmm_ell_t`` launches equal to phase 7's.  Returns
    (record, launches)."""
    zero = dict.fromkeys(KERNELS, 0)
    launches, losses, step_ms, per_step = dict(zero), [], [], []
    for i in range(MESH_WARMUP + MESH_STEPS):
        if i == MESH_WARMUP:
            tr.reset_stall_stats()
        counts = dict(zero)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses += counted(counts, tr.train_steps, 1)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        want = base["launches_each_step"][i]
        for k in ("spmm_ell", "spmm_ell_t"):
            if counts[k] != want[k] or counts[k] <= 0:
                raise AssertionError(
                    f"{what} step {i + 1} launched {k} {counts[k]} "
                    f"times, phase 7 {want[k]}")
        per_step.append(counts)
        for k in zero:
            launches[k] += counts[k]
    same = base["losses"][:len(losses)]
    if losses != same:
        raise AssertionError(f"{what} losses {losses} != phase 7's {same}")
    return {"losses": losses,
            "ms_per_step_median": float(np.median(step_ms[MESH_WARMUP:])),
            "host_stall_ms_per_step": tr.stall_per_step * 1e3,
            "place_ms_per_step": tr.place_per_step * 1e3,
            "step_ms": step_ms, "launches_each_step": per_step}, launches


def mesh_torus_arm(torch, device, tds):
    """Phase 18's torus2d arm: ``MESH_TORUS_SPEC`` from a seeded step-0
    checkpoint for ``MESH_TORUS_STEPS`` steps stacked, then on the one-rank
    mesh from ``make_topology_mesh(TRAIN_CORES, "torus2d")``, each step
    counted; the mesh run's losses ``torch.equal`` to the stacked run's and
    its ``spmm_ell`` / ``spmm_ell_t`` launches equal each step, the arm
    within ``MESH_TORUS_S``.  Returns (record, the mesh run's launches)."""
    from repro_torch.launch.mesh import make_topology_mesh

    t0 = time.perf_counter()
    trainer = seeded_trainer(tds, train_params(tds), MESH_TORUS_SPEC,
                             tag="mesh")
    runs = {}
    for tag in ("stacked", "mesh"):
        kw = {"device": device} if tag == "stacked" else {
            "mesh": make_topology_mesh(TRAIN_CORES, "torus2d",
                                       device_type=MESH_DEVICE)}
        tr = trainer(MESH_TORUS_SPEC, "card", input_pipeline="prefetch",
                     **kw)
        losses, step_ms, per_step = [], [], []
        for _ in range(MESH_TORUS_STEPS):
            counts = dict.fromkeys(KERNELS, 0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses += counted(counts, tr.train_steps, 1)
            step_ms.append((time.perf_counter() - t1) * 1e3)
            per_step.append(counts)
        tr.close()
        runs[tag] = {"losses": losses, "step_ms": step_ms,
                     "per_step": per_step}
    got, want = runs["mesh"], runs["stacked"]
    if got["losses"] != want["losses"]:
        raise AssertionError(f"{MESH_TORUS_SPEC} on the mesh: losses "
                             f"{got['losses']} != stacked {want['losses']}")
    for i, (a, b) in enumerate(zip(got["per_step"], want["per_step"])):
        for k in ("spmm_ell", "spmm_ell_t"):
            if a[k] != b[k] or a[k] <= 0:
                raise AssertionError(
                    f"{MESH_TORUS_SPEC} on the mesh step {i + 1} launched "
                    f"{k} {a[k]} times, stacked {b[k]}")
    arm_s = time.perf_counter() - t0
    if arm_s > MESH_TORUS_S:
        raise AssertionError(f"the torus2d arm took {arm_s:.1f}s, over its "
                             f"{MESH_TORUS_S:.0f} s limit")
    launches = {k: sum(c[k] for c in got["per_step"]) for k in KERNELS}
    return {"losses": got["losses"],
            "ms_per_step_median": float(np.median(got["step_ms"])),
            "stacked_ms_per_step_median": float(np.median(want["step_ms"])),
            "step_ms": got["step_ms"], "stacked_step_ms": want["step_ms"],
            "launches_each_step": got["per_step"], "arm_s": arm_s}, launches


def mesh_compressed_psum(torch, device, mesh):
    """One int8 ``compressed_psum`` over the mesh's core layout against the
    stacked call on the same rows: (max |diff|, bit-equal)."""
    from repro_torch.distributed.compress import compressed_psum
    from repro_torch.engine.engine import core_layout

    gen = torch.Generator(device="cpu").manual_seed(29)
    x = (torch.randn(TRAIN_CORES, TRAIN_CORES * MESH_PSUM_PER_CORE,
                     generator=gen)
         * torch.rand(TRAIN_CORES, 1, generator=gen) * 10).to(device)
    got = compressed_psum(x, n_cores=TRAIN_CORES,
                          layout=core_layout(mesh, TRAIN_CORES))
    want = compressed_psum(x, n_cores=TRAIN_CORES)
    return max_err(got, want), bool(torch.equal(got, want))


def mesh_phase(torch, device, tds, train):
    """Phase 18: the port's mesh backend on one rank (module docstring).
    Returns (record, launches by path)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_topology_mesh

    t0 = time.perf_counter()
    spec = "ell+pipelined"
    base = train[spec]
    trainer = seeded_trainer(tds, train_params(tds), spec, tag="mesh")
    arms = {}

    def stacked(tag):
        tr = trainer(spec, "card", input_pipeline="prefetch", device=device)
        arms[tag], _ = mesh_arm(torch, tr, base, f"mesh phase {tag}")
        tr.close()

    stacked("stacked, no group")
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "chip_smoke_mesh_store")
    if os.path.exists(path):
        os.remove(path)
    dist.init_process_group(MESH_BACKEND, store=dist.FileStore(path, 1),
                            rank=0, world_size=1)
    try:
        mesh = make_topology_mesh(TRAIN_CORES, "hypercube",
                                  device_type=MESH_DEVICE)
        nccl = torch.cuda.nccl.version() if MESH_BACKEND == "nccl" \
            else None
        out = {"device_count": torch.cuda.device_count(),
               "nccl_version": ".".join(map(str, nccl))
               if isinstance(nccl, tuple) else nccl,
               "ranks": mesh.size(), "cores": TRAIN_CORES}
        print(f"mesh: {MESH_BACKEND} on {MESH_DEVICE}, device_count="
              f"{out['device_count']} nccl={out['nccl_version']} ranks="
              f"{out['ranks']} cores={TRAIN_CORES}", flush=True)
        # stacked, mesh, mesh, stacked: the two paths back to back over
        # the same steps, in one process with the group up
        stacked("stacked 1")
        tr = trainer(spec, "card", input_pipeline="prefetch", mesh=mesh)
        arms["mesh 1"], launches = mesh_arm(torch, tr, base, "mesh 1")
        events, wall_s = profiled(torch, lambda: tr.train_steps(1))
        sync = mesh_all_reduce(torch, tr, events)
        tr.close()
        tr = trainer(spec, "card", input_pipeline="prefetch", mesh=mesh)
        arms["mesh 2"], again = mesh_arm(torch, tr, base, "mesh 2")
        tr.close()
        stacked("stacked 2")
        ga_err, ga_same = mesh_grad_accum(torch, device, mesh)
        if not ga_same:
            raise AssertionError(f"grad_accum over the mesh's model axis "
                                 f"differs from the local call by {ga_err}")
        torus, torus_launches = mesh_torus_arm(torch, device, tds)
        psum_err, psum_same = mesh_compressed_psum(torch, device, mesh)
        if not psum_same:
            raise AssertionError(f"compressed_psum over the mesh's layout "
                                 f"differs from the stacked call by "
                                 f"{psum_err}")
    finally:
        dist.destroy_process_group()
    for k in launches:
        launches[k] += again[k]

    def pooled(*tags):
        return float(np.median([t for a in tags
                                for t in arms[a]["step_ms"][MESH_WARMUP:]]))
    first = arms["mesh 1"]
    out.update({
        "losses": first["losses"], "equal_to_phase7": True,
        "ms_per_step_median": pooled("mesh 1", "mesh 2"),
        "stacked_ms_per_step_median": pooled("stacked 1", "stacked 2"),
        "phase7_ms_per_step": base["ms_per_step_median"],
        "host_stall_ms_per_step": first["host_stall_ms_per_step"],
        "phase7_host_stall_ms_per_step": base["host_stall_ms_per_step"],
        "phase7_place_ms_per_step": base["place_ms_per_step"],
        "arms": arms, "profiled_step_s": wall_s,
        "weight_bank_all_reduce": sync, "grad_accum_equal": ga_same,
        "torus2d": torus, "compressed_psum_equal": psum_same,
        "launches_each_step": first["launches_each_step"],
        "step_ms": first["step_ms"], "phase_s": time.perf_counter() - t0})
    if out["phase_s"] > MESH_PHASE_S:
        raise AssertionError(f"mesh phase took {out['phase_s']:.1f}s, over "
                             f"its {MESH_PHASE_S:.0f} s limit")
    return out, {f"mesh {spec}": launches,
                 f"mesh {MESH_TORUS_SPEC}": torus_launches}


def print_mesh(out, smi):
    sync = out["weight_bank_all_reduce"]
    arms = "; ".join(
        f"{tag}: {a['ms_per_step_median']:.3f} ms/step, host stall "
        f"{a['host_stall_ms_per_step']:.3f}, place "
        f"{a['place_ms_per_step']:.3f}" for tag, a in out["arms"].items())
    print(f"mesh training ell+pipelined (P={out['cores']} over "
          f"{out['ranks']} rank, batch={TRAIN_BATCH}): ms_per_step="
          f"{out['ms_per_step_median']:.3f} (stacked back to back "
          f"{out['stacked_ms_per_step_median']:.3f}, phase 7 "
          f"{out['phase7_ms_per_step']:.3f}; phase 7 host stall "
          f"{out['phase7_host_stall_ms_per_step']:.3f}, place "
          f"{out['phase7_place_ms_per_step']:.3f}) arms [{arms}]; "
          f"Weight-Bank all_reduce of {sync['floats']} floats: profiled "
          f"{sync['profiled_ms']:.4f} ms device ({sync['profiled_records']} "
          f"records), alone {sync['alone_ms']:.4f} ms; losses equal to "
          f"phase 7's over {len(out['losses'])} steps in every arm; "
          f"spmm_ell / spmm_ell_t launches each step equal; grad_accum over "
          f"'model' bit-equal={out['grad_accum_equal']} ({smi}; mesh phase "
          f"{out['phase_s']:.1f}s)", flush=True)
    torus = out["torus2d"]
    print(f"mesh training {MESH_TORUS_SPEC} (P={out['cores']} over "
          f"{out['ranks']} rank, batch={TRAIN_BATCH}, "
          f"{len(torus['losses'])} steps): ms_per_step="
          f"{torus['ms_per_step_median']:.3f} (stacked beside it "
          f"{torus['stacked_ms_per_step_median']:.3f}); arm "
          f"{torus['arm_s']:.2f}s; losses and spmm_ell / spmm_ell_t "
          f"launches each step equal to the stacked run's; int8 "
          f"compressed_psum over the mesh layout bit-equal="
          f"{out['compressed_psum_equal']} ({smi})", flush=True)


class CollectiveLog:
    """Records the ``torch.distributed`` collectives run while active (the
    expert-parallel fold's): ``(name, elements, bytes)`` per call."""

    NAMES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
             "all_to_all_single", "all_gather", "broadcast")

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self._saved = [], {n: getattr(dist, n)
                                       for n in self.NAMES}

        def logged(name, fn):
            def call(*args, **kwargs):
                t = args[0]
                self.calls.append((name, int(t.numel()),
                                   int(t.numel() * t.element_size())))
                return fn(*args, **kwargs)
            return call

        for name, fn in self._saved.items():
            setattr(dist, name, logged(name, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def lm_mesh_state(torch, device, cfg):
    """Seeded f32 weights of ``cfg`` on ``device`` and their AdamW
    state."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    params = lm_params(torch, cfg, device, LM_MESH_SEED)
    return params, adamw(3e-4)[0](lm.param_tree(params))


def lm_mesh_step(torch, step, params, state, batch, counts):
    """One train step, counted, its routes logged and its peak read:
    (params, state, record, routes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with RouteLog() as log:
        params, state, m = counted(counts, step, params, state, batch)
    torch.cuda.synchronize()
    rec = {"ms": (time.perf_counter() - t0) * 1e3,
           "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "loss_tensor": m["loss"].detach().cpu(),
           "start_bytes": int(start),
           "peak_bytes": int(torch.cuda.max_memory_allocated()),
           "launches": {k: v for k, v in counts.items() if v}}
    return params, state, rec, log.ids


def lm_mesh_params_gate(torch, device, got, want):
    """Each leaf of ``got`` (a model on ``device``) against ``want`` (its
    leaves on the host), one at a time: (worst |diff| / the leaf's largest
    |p|, every leaf bit-equal)."""
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves

    worst, same = 0.0, True
    with torch.no_grad():
        for g, w in zip(tree_leaves(lm.param_tree(got)), want, strict=True):
            w = w.to(device)
            worst = max(worst, float((g - w).abs().max())
                        / max(float(w.abs().max()), 1e-30))
            same &= bool(torch.equal(g, w))
    return worst, same


def lm_mesh_split(torch, device, cfg, mesh, ep_spec, b, s):
    """(d'): ``launch/steps.py::tp_plan`` of ``cfg`` on ``mesh`` (the
    blocks the train and prefill steps ran split over ``model``), and one
    dense layer at ``cfg``'s width (``d_model``, heads, ``d_ff``) run
    forward at ``[b, s]`` under the mesh's ``Split``: its collectives
    (:class:`CollectiveLog`) — none on one rank, g's two all-reduces (after
    the attention pair and after the FFN pair) at W > 1."""
    import dataclasses

    from repro_torch.distributed.tensor_parallel import Split, use_split
    from repro_torch.launch.steps import tp_plan
    from repro_torch.models import transformer

    plan = tp_plan(cfg, mesh, ep_spec=ep_spec)
    dense = dataclasses.replace(cfg, family="dense", moe_experts=0,
                                n_layers=1)
    split = Split.over(mesh, tp_plan(dense, mesh))
    gen = torch.Generator(device=device).manual_seed(LM_MESH_SEED)
    layer = transformer.init_dense_layer(gen, dense, torch.float32)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=device)
    with use_split(split), torch.no_grad(), CollectiveLog() as wire:
        y = transformer.dense_block(x, layer, dense, None,
                                    torch.arange(s, device=device)[None])
    torch.cuda.synchronize()
    out = {"plan": plan, "dense_plan": dict(split.plan), "model": split.size,
           "dense_layer": {"d_model": dense.d_model, "heads": dense.n_heads,
                           "kv_heads": dense.n_kv_heads, "d_ff": dense.d_ff,
                           "b": b, "s": s},
           "dense_wire": wire.calls,
           "dense_wire_bytes": sum(c[2] for c in wire.calls),
           "dense_out_finite": bool(torch.isfinite(y).all())}
    want = [] if split.size == 1 else ["all_reduce"] * 2
    if [c[0] for c in wire.calls] != want or not out["dense_out_finite"] \
            or tuple(y.shape) != tuple(x.shape):
        raise AssertionError(f"one dense layer through the split: {out}")
    return out


def lm_mesh_elastic(torch, device, cfg, mesh, cell, counts):
    """(d): ``cfg`` at ``LM_MESH_ELASTIC_LAYERS`` layers trained one step
    on ``mesh``; its placed (params, state) saved with
    ``CheckpointManager.save(shardings=)`` and restored with
    ``restore_latest(like, shardings=)`` onto a second mesh from
    ``make_mesh_from_plan``: every leaf's bits against the live state's,
    and one more step from each, their loss bits."""
    import shutil

    from repro_torch.checkpoint import (CheckpointManager,
                                        make_mesh_from_plan, reshard,
                                        scale_plan)
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.steps import (build_step, ep_spec_for,
                                          tree_shardings)
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves

    cut = cfg.scaled(n_layers=LM_MESH_ELASTIC_LAYERS)
    params, state = lm_mesh_state(torch, device, cut)
    tree = lm.param_tree(params)
    other = make_mesh_from_plan(scale_plan(1, model_parallel=1),
                                device_type=MESH_DEVICE)
    sh, steps = [], []
    for m in (mesh, other):
        with use_mesh(m):
            sh.append((tree_shardings(tree, m),
                       tree_shardings(state, m, zero1=True)))
            steps.append(build_step(cut, "train",
                                    ep_spec=ep_spec_for(cut, cell, m)))
    params = lm.params_from_tree(reshard(tree, sh[0][0]))
    state = reshard(state, sh[0][1])
    del tree
    batches = [long_batch(torch, device, cut, LM_MESH_SEED, i, cell
                          .global_batch, cell.seq_len) for i in (1, 2)]
    params, state, _ = counted(counts, steps[0], params, state, batches[0])
    live = (lm.param_tree(params), state)
    path = os.path.join(OUT_DIR, "chip_smoke_lm_mesh_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    mgr = CheckpointManager(path, keep=1)
    t0 = time.perf_counter()
    mgr.save(1, live, extra={"arch": cut.name}, shardings=sh[0])
    out = {"layers": cut.n_layers, "save_s": time.perf_counter() - t0,
           "bytes": sum(os.path.getsize(os.path.join(path, "step_00000001",
                                                     f))
                        for f in os.listdir(os.path.join(
                            path, "step_00000001")))}
    t0 = time.perf_counter()
    restored, extra, saved_step = mgr.restore_latest(live, shardings=sh[1])
    out["restore_s"] = time.perf_counter() - t0
    pairs = list(zip(tree_leaves(restored), tree_leaves(live), strict=True))
    out["leaves"] = len(pairs)
    out["leaves_bit_equal"] = all(
        a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
        and bool(torch.equal(a, b)) for a, b in pairs)
    del pairs
    losses = []
    for p, s in (live, restored):
        _, _, m = counted(counts, steps[1], lm.params_from_tree(p), s,
                          batches[1])
        losses.append(m["loss"].detach().cpu())
    out["losses"] = [float(x) for x in losses]
    out["loss_bits_equal"] = bool(torch.equal(losses[0], losses[1]))
    out["extra"], out["step"] = extra, saved_step
    shutil.rmtree(path, ignore_errors=True)
    if not out["leaves_bit_equal"] or not out["loss_bits_equal"] \
            or saved_step != 1 or extra != {"arch": cut.name}:
        raise AssertionError(f"elastic restore: {out}")
    return out


def lm_mesh_phase(torch, device, rng):
    """Phase 19: the LM's train and prefill steps on a ``(data, model)``
    mesh of one rank (module docstring).  Returns (record, launches by
    path)."""
    import torch.distributed as dist

    from repro_torch.checkpoint import make_mesh_from_plan, reshard, \
        scale_plan
    from repro_torch.configs import Shape, get_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.steps import (build_step, ep_spec_for,
                                          tree_shardings)
    from repro_torch.models import lm, moe
    from repro_torch.optim import tree_leaves

    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH).scaled(n_layers=MOE_LAYERS)
    s, b = LONG_GATE_S, LONG_FAMILY_BATCH
    cell = Shape("lm mesh", "train", s, b)
    launches = {k: dict.fromkeys(KERNELS, 0) for k in (
        f"lm mesh unsharded train s={s}", f"lm mesh train s={s}",
        f"lm mesh unsharded prefill s={s}", f"lm mesh prefill s={s}",
        "lm mesh elastic restore")}
    batch = long_batch(torch, device, cfg, LM_MESH_SEED, 0, b, s)
    out = {"arch": MOE_ARCH, "layers": cfg.n_layers, "s": s, "batch": b}
    # (a) the unsharded step first; its new params wait on the host
    torch.cuda.empty_cache()
    params, state = lm_mesh_state(torch, device, cfg)
    params, state, plain, plain_routes = lm_mesh_step(
        torch, build_step(cfg, "train"), params, state, batch,
        launches[f"lm mesh unsharded train s={s}"])
    want = [t.detach().cpu() for t in tree_leaves(lm.param_tree(params))]
    del params, state
    torch.cuda.empty_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "chip_smoke_lm_mesh_store")
    if os.path.exists(path):
        os.remove(path)
    dist.init_process_group(MESH_BACKEND, store=dist.FileStore(path, 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh_from_plan(scale_plan(1, model_parallel=1),
                                   device_type=MESH_DEVICE)
        ep_spec = ep_spec_for(cfg, cell, mesh)
        out.update(mesh_shape=tuple(mesh.shape),
                   mesh_names=mesh.mesh_dim_names, ep_spec=ep_spec)
        params, state = lm_mesh_state(torch, device, cfg)
        tree = lm.param_tree(params)
        with use_mesh(mesh):
            sh = (tree_shardings(tree, mesh),
                  tree_shardings(state, mesh, zero1=True))
            step = build_step(cfg, "train", ep_spec=ep_spec)
            prefill = build_step(cfg, "prefill", ep_spec=ep_spec)
        placed = lm.params_from_tree(reshard(tree, sh[0]))
        opt = reshard(state, sh[1])
        out["placed_in_place"] = all(
            a.data_ptr() == p.data_ptr() for a, p in zip(
                tree_leaves(lm.param_tree(placed)), tree_leaves(tree)))
        del params, state, tree
        # (b) the same step through the mesh
        params, state, meshed, mesh_routes = lm_mesh_step(
            torch, step, placed, opt, batch, launches[f"lm mesh train s={s}"])
        del placed, opt
        flips = sum(int((np.sort(a, -1) != np.sort(c, -1)).any(-1).sum())
                    for a, c in zip(plain_routes, mesh_routes, strict=True))
        worst, same = lm_mesh_params_gate(torch, device, params, want)
        del want
        rel = abs(meshed["loss"] - plain["loss"]) / abs(plain["loss"])
        out["train"] = {
            "unsharded": {k: v for k, v in plain.items()
                          if k != "loss_tensor"},
            "mesh": {k: v for k, v in meshed.items() if k != "loss_tensor"},
            "route_calls": len(mesh_routes), "flipped_routes": flips,
            "loss_rel": rel, "loss_bits_equal": bool(torch.equal(
                plain["loss_tensor"], meshed["loss_tensor"])),
            "params_worst_share": worst, "params_bit_equal": same,
            "peak_ratio": meshed["peak_bytes"] / plain["peak_bytes"]}
        tr = out["train"]
        print(f"lm mesh train: bits equal loss={tr['loss_bits_equal']} "
              f"params={same}; peaks {plain['peak_bytes']} (unsharded) vs "
              f"{meshed['peak_bytes']} (mesh)", flush=True)
        if flips or len(mesh_routes) != len(plain_routes) \
                or rel > LM_MESH_LOSS_RTOL or worst > LM_MESH_PARAM_TOL \
                or plain["launches"] != meshed["launches"] \
                or not meshed["launches"].get("flash_mha") \
                or not meshed["launches"].get("flash_mha_bwd") \
                or abs(tr["peak_ratio"] - 1.0) > LM_MESH_PEAK_RTOL:
            raise AssertionError(f"lm mesh train vs unsharded: {tr}")
        # (c) the prefill, unsharded and through the mesh, same params
        tokens = {"tokens": batch["tokens"]}
        logits = {}
        for key, fn, where in (
                ("unsharded", build_step(cfg, "prefill"),
                 f"lm mesh unsharded prefill s={s}"),
                ("mesh", prefill, f"lm mesh prefill s={s}")):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits[key] = counted(launches[where], fn, params, tokens)
            torch.cuda.synchronize()
            out[f"prefill_{key}_ms"] = (time.perf_counter() - t1) * 1e3
        scale = float(logits["unsharded"].abs().max())
        out["prefill_err_share"] = max_err(logits["mesh"],
                                           logits["unsharded"]) / scale
        out["prefill_bit_equal"] = bool(torch.equal(logits["mesh"],
                                                    logits["unsharded"]))
        if out["prefill_err_share"] > LM_MESH_LOGIT_TOL \
                or not torch.isfinite(logits["mesh"]).all() \
                or launches[f"lm mesh prefill s={s}"]["flash_mha"] \
                != cfg.n_layers:
            raise AssertionError(f"lm mesh prefill: {out}")
        del logits, state
        # (d) the wire of one MoE layer's forward
        gen = torch.Generator(device=device).manual_seed(LM_MESH_SEED)
        x = torch.randn((b, s, cfg.d_model), generator=gen, device=device)
        with use_mesh(mesh), torch.no_grad(), CollectiveLog() as wire:
            moe.moe_ffn_ep(x, params.moe_layers[0], cfg, 1.25, ep_spec)
        torch.cuda.synchronize()
        names = [c[0] for c in wire.calls]
        out["wire"] = {"calls": wire.calls,
                       "bytes": sum(c[2] for c in wire.calls),
                       "activation_bytes": int(x.numel() * x.element_size())}
        if sorted(names) != ["all_gather_into_tensor",
                             "reduce_scatter_tensor"] \
                and names != ["all_reduce"]:
            raise AssertionError(f"one MoE layer's wire: {wire.calls}")
        del x, params
        torch.cuda.empty_cache()
        # (d') the split plan, and one dense layer's wire through it
        out["split"] = lm_mesh_split(torch, device, cfg, mesh, ep_spec, b, s)
        print(f"lm mesh split: plan {json.dumps(out['split']['plan'])}; one "
              f"dense layer's wire {out['split']['dense_wire']}", flush=True)
        torch.cuda.empty_cache()
        # (e) elastic restore
        t1 = time.perf_counter()
        out["elastic"] = lm_mesh_elastic(torch, device, cfg, mesh, cell,
                                         launches["lm mesh elastic restore"])
        out["elastic"]["phase_s"] = time.perf_counter() - t1
    finally:
        dist.destroy_process_group()
        if os.path.exists(path):
            os.remove(path)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    if out["phase_s"] > LM_MESH_PHASE_S:
        raise AssertionError(f"lm mesh phase took {out['phase_s']:.1f} s, "
                             f"over its {LM_MESH_PHASE_S:.0f} s limit")
    return out, launches


def print_lm_mesh(out, smi):
    tr, el, wire = out["train"], out["elastic"], out["wire"]
    print(f"lm mesh: {out['arch']} at full width, {out['layers']} layers, "
          f"f32, batch {out['batch']} x s={out['s']} on a "
          f"{out['mesh_shape']} {out['mesh_names']} mesh (ep_spec "
          f"{out['ep_spec']}): train step unsharded "
          f"{tr['unsharded']['ms']:.1f} ms, peak "
          f"{tr['unsharded']['peak_bytes']} B; mesh {tr['mesh']['ms']:.1f} "
          f"ms, peak {tr['mesh']['peak_bytes']} B (ratio "
          f"{tr['peak_ratio']:.4f}); loss {tr['mesh']['loss']:.7g} vs "
          f"{tr['unsharded']['loss']:.7g} (rel {tr['loss_rel']:.3g}, bits "
          f"equal {tr['loss_bits_equal']}), params worst "
          f"{tr['params_worst_share']:.3g} of max|p| (bits equal "
          f"{tr['params_bit_equal']}), {tr['flipped_routes']} flipped routes "
          f"over {tr['route_calls']} routings, launches "
          f"{json.dumps(tr['mesh']['launches'])} in both arms; prefill "
          f"{out['prefill_mesh_ms']:.1f} ms mesh vs "
          f"{out['prefill_unsharded_ms']:.1f} unsharded, logits within "
          f"{out['prefill_err_share']:.3g} of max (bits equal "
          f"{out['prefill_bit_equal']}); one MoE layer's wire "
          f"{[c[:2] for c in wire['calls']]} = {wire['bytes']} B (activation "
          f"{wire['activation_bytes']} B); split plan "
          f"{json.dumps(out['split']['plan'])} at model = "
          f"{out['split']['model']}, one dense layer's wire "
          f"{out['split']['dense_wire']} ({out['split']['dense_wire_bytes']} "
          f"B); elastic at {el['layers']} layer: "
          f"{el['leaves']} leaves bit-equal={el['leaves_bit_equal']}, "
          f"{el['bytes']} B saved in {el['save_s']:.1f} s, restored in "
          f"{el['restore_s']:.1f} s, next-step losses {el['losses']} bits "
          f"equal={el['loss_bits_equal']} ({smi}; lm mesh phase "
          f"{out['phase_s']:.1f}s)", flush=True)


def run(smi: str):
    """Phases 3–19 on the card (``smi``: the card's name and power limit,
    printed beside the new phases' times); returns (kernels line,
    record)."""
    import torch

    from repro_torch.engine import Engine, EngineConfig
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
    eng_blk = InferenceEngine(
        Engine(EngineConfig.from_spec("block+pipelined",
                                      block_tiles=BLOCK_TILES)),
        ds.graph, ds.features, ckpt_dir=ckpt, device="cuda")
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
    hub = detail["spmm_ell_hub_bucket"]
    gem = records["gemm"]
    print(f"kernels checked in {time.perf_counter() - t0:.1f}s: "
          f"spmm_ell worst |err| "
          f"{max(detail['spmm_ell_max_abs_err'].values()):.3g}, gemm worst "
          f"|err| {max(detail['gemm_max_abs_err'].values()):.3g}; layer-1 "
          f"walk {records['spmm_ell']['ms']:.4f} ms in 1 launch (kernel only "
          f"{records['spmm_ell']['kernel_only_ms']:.4f} of "
          f"{records['spmm_ell']['kernel_only_count']} launches, bound "
          f"{records['spmm_ell']['bound_ms']:.5f}, library "
          f"{records['spmm_ell']['library_ms']:.4f}, per bucket "
          f"{detail['spmm_ell_per_bucket_ms']:.4f}); hub bucket K={hub['K']} "
          f"nb={hub['nb']} {hub['ms']:.4f} ms (kernel only "
          f"{hub['kernel_only_ms_count']}); gemm {gem['shape']} "
          f"{gem['ms']:.4f} ms (kernel only {gem['kernel_only_ms']:.4f} of "
          f"{gem['kernel_only_count']} launches, library "
          f"{gem['library_ms']:.4f}); other gemm shapes "
          + json.dumps(detail["gemm_other_shapes"]), flush=True)

    t0 = time.perf_counter()
    rep, launches, batches = serving_phase(torch, eng_ell, eng_coo, eng_blk,
                                           rng)
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
          f"ell_vs_coo={rep['ell_vs_coo_max_abs_err']:.3g} "
          f"block_equals_coo={rep['block_vs_coo_equal']} "
          f"block_incremental={eng_blk.incremental_supported}", flush=True)
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
    item = first_train_batch(tds)
    t0 = time.perf_counter()
    records["spmm_ell_t"], tdetail = train_kernel_phase(torch, device, tds,
                                                        item, rng)
    detail.update(tdetail)
    records["spmm_ell"]["max_abs_err"] = max(
        records["spmm_ell"]["max_abs_err"],
        *tdetail["spmm_ell_training_max_abs_err"].values())
    walk = detail["spmm_ell_training_layer1_walk"]
    print(f"training kernels checked in {time.perf_counter() - t0:.1f}s: "
          f"spmm_ell_t worst |err| {records['spmm_ell_t']['max_abs_err']:.3g}"
          f", layer-1 t walk {records['spmm_ell_t']['ms']:.4f} ms (kernels "
          f"only {records['spmm_ell_t']['kernel_only_ms']:.4f} of "
          f"{records['spmm_ell_t']['kernel_only_count']} launches, bound "
          f"{records['spmm_ell_t']['bound_ms']:.5f}, library "
          f"{records['spmm_ell_t']['library_ms']:.4f}, per bucket "
          f"{detail['spmm_ell_t_per_bucket_ms']:.4f}); layer-1 forward "
          f"walk {walk['walk_ms']:.4f} ms (1 launch; kernel only "
          f"{walk['kernel_only_ms_count']}, bound {walk['bound_ms']:.5f}) vs "
          f"per bucket {walk['per_bucket_ms']:.4f} ms "
          f"({walk['launches_per_bucket']} launches) vs per-core 2-D "
          f"{walk['per_core_2d_ms']:.4f} ms "
          f"({walk['launches_per_core']} launches)", flush=True)

    t0 = time.perf_counter()
    crec, cdetail = coo_kernel_phase(torch, device, tds, item, eng_blk,
                                     eng_blk.weights[0], rng)
    records.update(crec)
    detail.update(cdetail)
    print(f"COO-walk kernels checked in {time.perf_counter() - t0:.1f}s "
          f"({len(cdetail['coo_walk_max_abs_err'])} checks, all bit-equal):"
          + "".join(f" {k} layer-1 {crec[k]['ms']:.4f} ms (kernel only "
                    f"{crec[k]['kernel_only_ms']:.4f} of "
                    f"{crec[k]['kernel_only_count']} launches, bound "
                    f"{crec[k]['bound_ms']:.5f}, plain "
                    f"{crec[k]['plain_ms']:.4f}, library "
                    f"{crec[k]['library_ms']:.4f});" for k in crec)
          + f" serving dst_tiles layer "
          f"{cdetail['serving_layer1']['ms']:.4f} ms", flush=True)

    t0 = time.perf_counter()
    train = train_phase(torch, tds, device, item, rng)
    for spec in TRAIN_SPECS:
        arm = train[spec]
        print(f"training {spec}: gcn-reddit {dims} P={TRAIN_CORES} "
              f"batch={TRAIN_BATCH} fanouts={TRAIN_FANOUTS}: "
              f"ms_per_step={arm['ms_per_step_median']:.3f} "
              f"steps_per_s={arm['steps_per_s']:.3f} "
              f"host_stall_ms_per_step={arm['host_stall_ms_per_step']:.3f} "
              f"host_batch_ms={json.dumps(arm['host_batch_ms'])} "
              f"device_fwd_ms={arm['device_fwd_ms']:.3f} "
              f"device_bwd_ms={arm['device_bwd_ms']:.3f} "
              f"device_busy_share={arm['device_busy_share']} (of "
              f"{arm['device_busy_records']} records) "
              f"resume_drift={arm['resume_drift']:.3g} "
              f"card_vs_cpu={arm['card_vs_cpu_max_abs']:.3g} "
              f"({arm['phase_s']:.1f}s)", flush=True)
        print(f"training {spec} losses: " + json.dumps(arm["losses"]),
              flush=True)
    coo = train["coo+serial"]
    print(f"training coo+serial: {COO_STEPS} steps, coo_vs_ell="
          f"{coo['coo_vs_ell_max_abs']:.3g} block_equals_coo="
          f"{coo['block_equals_coo']} deterministic="
          f"{json.dumps(coo['deterministic'])} ({coo['phase_s']:.1f}s); "
          f"training phase {time.perf_counter() - t0:.1f}s", flush=True)
    print("training launches per step: " + json.dumps(
        {spec: arm["launches_per_step"] for spec, arm in train.items()}),
        flush=True)

    t0 = time.perf_counter()
    paper, paper_launch = paper_model_phase(torch, device, tds, item, rng)
    print("paper model: first-batch LayerShapes "
          + json.dumps(paper["shapes"]) + f" -> orders {paper['orders']} "
          f"(ours and naive); naive vs ours "
          f"{paper['naive_vs_ours_max_abs']:.3g}", flush=True)
    for arm, rec in paper["arms"].items():
        print(f"paper {arm} ({'/'.join(PAPER_ARMS[arm])}): gcn-reddit "
              f"{dims} batch={TRAIN_BATCH} steps={PAPER_STEPS}: "
              f"ms_per_step={rec['ms_per_step_median']:.3f} "
              f"loop_ms_per_step={rec['loop_ms_per_step_median']:.3f} "
              f"device_fwd_ms={rec['device_fwd_ms']:.3f} "
              f"device_bwd_ms={rec['device_bwd_ms']:.3f} "
              f"device_kernel_ms={rec['device_kernel_ms']:.3f} "
              f"(busy {rec['device_busy_share']:.3f} of "
              f"{rec['device_kernel_records']} records) "
              f"peak_bytes={rec['peak_bytes']} "
              f"peak_above_start={rec['peak_above_start_bytes']} "
              f"kept_for_backward={rec['kept_for_backward_bytes']} "
              f"residual_bytes={rec['residual_bytes']} "
              f"launches_per_step={json.dumps(rec['launches_per_step'])} "
              f"card_vs_cpu={rec['card_vs_cpu_max_abs']:.3g} "
              f"({rec['phase_s']:.1f}s)", flush=True)
        print(f"paper {arm} losses: " + json.dumps(rec["losses"]),
              flush=True)
    for key, rec in paper["kernels"].items():
        print(f"paper kernel {key}: |err| {rec['max_abs_err']:.3g}, "
              f"{rec['ms']:.4f} ms (kernel only {rec['kernel_only_ms']:.4f},"
              f" bound {rec['bound_ms']:.5f} by {rec['bound_by']}, plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f} / "
              f"kernel only {rec['library_kernel_only_ms']:.4f})",
              flush=True)
    for hop, rec in paper["uma"].items():
        print(f"uma vs hypercube {hop} (P={TRAIN_CORES}, n_dst="
              f"{rec['n_dst']}, n_src={rec['n_src']}, d={rec['d']}): "
              f"|err| {rec['max_abs_err']:.3g}, hypercube "
              f"{rec['hypercube_ms']:.4f} ms, uma {rec['uma_ms']:.4f} ms; "
              f"bytes per core raw {rec['raw_bytes_per_core']} vs "
              f"pre-reduced {rec['prereduced_bytes_per_core']}", flush=True)
    print(f"paper model phase {time.perf_counter() - t0:.1f}s", flush=True)
    for name, key in (("gemm", "gemm_layer1"), ("gemm", "gemm_layer0"),
                      ("spmm", "spmm_t_layer0")):
        records[name]["max_abs_err"] = max(
            records[name]["max_abs_err"],
            paper["kernels"][key]["max_abs_err"])

    t0 = time.perf_counter()
    axes, axes_launches, prepass = axes_phase(torch, device, tds, item,
                                              train, rng)
    for key, rec in axes["aggregates"].items():
        print(f"axes aggregate {key}: " + json.dumps(rec), flush=True)
    for spec, arm in axes["arms"].items():
        print(f"axes training {spec}: ms_per_step="
              f"{arm['ms_per_step_median']:.3f} host_stall_ms_per_step="
              f"{arm['host_stall_ms_per_step']:.3f} vs_hypercube="
              f"{arm['vs_hypercube_max_abs']:.3g} card_vs_cpu="
              f"{arm['card_vs_cpu_max_abs']:.3g} launches_per_step="
              + json.dumps({k: v for k, v in arm["launches_per_step"].items()
                            if v}) + f" ({arm['phase_s']:.1f}s)", flush=True)
    red, mc = axes["redundancy"], axes["mincom"]
    print(f"axes redundancy: vs_dedup={red['vs_dedup_max_abs']:.3g} "
          f"ms_per_step (sync pipeline)={red['ms_per_step_median_sync']:.3f} "
          f"launches_per_step=" + json.dumps(
              {k: v for k, v in red["launches_per_step"].items() if v})
          + f" prepass_launches={json.dumps(red['prepass_launches'])} hops="
          + json.dumps({h: {k: v for k, v in r.items() if k != "merge_stats"}
                        for h, r in red["hops"].items()})
          + f" ({red['phase_s']:.1f}s)", flush=True)
    for name, rec in prepass.items():
        print(f"axes prepass {name} hop {rec['hop']}: |err| "
              f"{rec['max_abs_err']:.3g}, {rec['ms']:.4f} ms (kernel only "
              f"{rec['kernel_only_ms']:.4f} of {rec['kernel_only_count']} "
              f"launches, bound {rec['bound_ms']:.5f} by {rec['bound_by']}, "
              f"plain {rec['plain_ms']:.4f}, library {rec['library_ms']:.4f} "
              f"/ kernel only {rec['library_kernel_only_ms']:.4f}) shape "
              + json.dumps(rec["shape"]), flush=True)
    print(f"axes mincom: vs_naive={mc['vs_naive_max_abs']:.3g} wire_bytes "
          f"first batch {json.dumps(mc['wire_bytes_first_batch'])}, last "
          f"batch {mc['last_plan_report']['wire_bytes']:.0f}; host_batch_ms="
          f"{json.dumps(mc['host_batch_ms'])} ({mc['phase_s']:.1f}s); axes "
          f"phase {time.perf_counter() - t0:.1f}s", flush=True)

    plan, plan_launches = planner_phase(torch, device, tds, item, train, ds,
                                        ckpt)
    caps, topo, tier2, tier1 = (plan["caps"], plan["topology"],
                                plan["tier2"], plan["tier1"])
    print(f"planner caps sweep (n, deg, d = {PLANNER_CAPS_SHAPE}, "
          f"{caps['calls']} calls, 1 spmm_ell + 1 spmm_ell_t each): ms per "
          f"forward + backward {json.dumps(caps['ms_per_fwdbwd'])}, winner "
          f"{json.dumps(caps['winner'])} ({caps['phase_s']:.1f}s)",
          flush=True)
    print(f"planner topology record at {json.dumps(plan['graph_stats'])} "
          f"(one card: the exchange is a copy on the device, so the fit "
          f"prices rounds and copies, not a network): alpha="
          f"{topo['alpha']:.6g} s/step beta={topo['beta']:.6g} s/B const="
          f"{topo['const']:.6g} s; predicted vs measured ms per step "
          + json.dumps(topo["fit"]) + f" ({topo['phase_s']:.1f}s)",
          flush=True)
    print(f"planner tier 2 (no planner record): resolved "
          f"{tier2['resolved']}; ranking ms " + json.dumps(tier2["ranking"])
          + "; roofline ratio vs ell " + json.dumps(tier2["roofline_ratio"])
          + f" at dims {tier2['dims']}; count_work card == CPU "
          + json.dumps(tier2["count_work"]) + f" ({tier2['phase_s']:.1f}s)",
          flush=True)
    print(f"planner tier 1 ({len(tier1['entry']['candidates'])} specs, "
          f"{PLANNER_STEPS} steps x {PLANNER_TRIALS} trials, loss_match="
          f"{tier1['entry']['loss_match']}): winner {tier1['winner']}; ms "
          f"per step " + json.dumps({k: v * 1e3 for k, v in
                                     tier1["entry"]["s_per_step"].items()})
          + f"; second call launched "
          f"{sum(tier1['second_call_launches'].values())} "
          f"({tier1['phase_s']:.1f}s)", flush=True)
    ptr, srv_auto = plan["trainer"], plan["serving"]
    print(f"planner auto Trainer: spec {ptr['auto']['spec']} losses "
          f"bit-equal to Trainer({tier1['winner']}) "
          + json.dumps(ptr["auto"]["losses"]) + f"; ms_per_step="
          f"{ptr['auto']['ms_per_step_median']:.3f} (concrete "
          f"{ptr['concrete']['ms_per_step_median']:.3f}, phase 7 "
          f"{ptr['phase7_ms_per_step']}) host_stall_ms_per_step="
          f"{ptr['auto']['host_stall_ms_per_step']:.3f} (phase 7 "
          f"{ptr['phase7_host_stall_ms_per_step']}) ({ptr['phase_s']:.1f}s)"
          f"; auto serving resolved {srv_auto['spec']}, "
          f"{srv_auto['queries']} cold queries equal "
          f"({srv_auto['phase_s']:.1f}s); planner phase "
          f"{plan['phase_s']:.1f}s", flush=True)

    store, store_launches = feature_store_phase(torch, device, tds, train,
                                                ds, ckpt)
    print_feature_store(store)

    t0 = time.perf_counter()
    records["flash_mha"], lm, lm_launches = lm_phase(torch, device, rng)
    fl, pre, gate, srv = (records["flash_mha"], lm["prefill"], lm["gate"],
                          lm["serve"])
    print(f"lm kernels: flash_mha layer-0 prefill shape "
          f"{lm['flash_mha_layer0_shape']} causal {fl['ms']:.3f} ms (kernel "
          f"only {fl['kernel_only_ms']:.3f} of {fl['kernel_only_count']} "
          f"launches; "
          f"{lm['flash_mha_layer0_tflops']:.2f} TFLOP/s; bound "
          f"{fl['bound_ms']:.3f} by {fl['bound_by']}, plain "
          f"{fl['plain_ms']:.3f}, sdpa {fl['library_ms']:.3f}); worst |err| "
          f"f32 {fl['max_abs_err']:.3g}, bf16 {fl['max_abs_err_bf16']:.3g} "
          f"over {len(lm['flash_mha_max_abs_err'])} checks "
          f"({lm['flash_checks_s']:.1f}s); vs float64 "
          f"{lm['flash_mha_f64_max_abs_err']}; bf16 "
          f"{lm['flash_mha_bf16_ms']:.3f} ms (kernel only "
          f"{lm['flash_mha_bf16_kernel_only_ms']:.3f}; bound "
          f"{lm['flash_mha_bf16_bound_ms']:.3f}, sdpa flash "
          f"{lm['flash_mha_bf16_library_ms']:.3f} / kernel only "
          f"{lm['flash_mha_bf16_library_kernel_only_ms']:.3f}) |err| "
          f"{lm['flash_mha_bf16_max_abs_err']:.3g}", flush=True)
    print(f"lm prefill: {LM_ARCH} {lm['params']} params, b=1 s={pre['s']}: "
          f"ms_median={pre['ms_median']:.3f} tokens_per_s="
          f"{pre['tokens_per_s']:.1f} flash_share="
          f"{pre['flash_share_of_device_time']} (of "
          f"{pre['flash_records_profiled']} flash records) device_busy="
          f"{pre['device_busy_share']:.3f} peak_gb="
          f"{pre['peak_gb']:.2f}; card vs CPU ({gate['layers']} layers, "
          f"s={gate['s']}) {gate['card_vs_cpu_max_abs']:.3g} (CPU "
          f"{gate['cpu_s']:.1f}s)", flush=True)
    print(f"lm serve: {srv['completed']}/{srv['requests']} requests, "
          f"{srv['tokens']} tokens in {srv['steps']} steps, "
          f"tok_per_s={srv['tok_per_s']:.2f}, decode_calls="
          f"{srv['decode_calls']} wall_ms_per_call="
          f"{srv['wall_ms_per_decode_call']:.3f} call_ms="
          f"{srv['decode_call_ms_median']:.3f} device_ms="
          f"{srv['decode_call_device_ms']} (bound "
          f"{srv['decode_call_bound_ms']:.3f}); solo tokens equal; decode vs "
          f"forward {srv['decode_vs_forward_max_abs']:.3g}; lm phase "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    print("lm launches: " + json.dumps(lm_launches), flush=True)

    net, net_launches = network_phase(torch, device, tds, item)
    print_network(net, smi)
    lmt, lmt_launches = lm_train_phase(torch, device)
    print_lm_train(lmt, smi)
    torch.cuda.empty_cache()
    records["flash_mha_window"], fam, fam_launches = lm_families_phase(
        torch, device, rng)
    print_lm_families(records["flash_mha_window"], fam, smi)
    print("lm families launches: " + json.dumps(
        {k: {n: c for n, c in v.items() if c}
         for k, v in fam_launches.items()}), flush=True)
    torch.cuda.empty_cache()
    (records["flash_mha_bwd"], records["flash_mha_bwd_window"], long,
     long_launches) = lm_long_train_phase(torch, device, rng)
    print_lm_long_train(records["flash_mha_bwd"],
                        records["flash_mha_bwd_window"], long, smi)
    print("lm long launches: " + json.dumps(
        {k: {n: c for n, c in v.items() if c}
         for k, v in long_launches.items()}), flush=True)
    torch.cuda.empty_cache()
    (records["flash_mha_hd80"], records["flash_mha_bwd_hd80"], hd80,
     hd80_launches) = hd80_phase(torch, device, rng)
    print_hd80(records["flash_mha_hd80"], records["flash_mha_bwd_hd80"],
               hd80, smi)
    print("hd80 launches: " + json.dumps(
        {k: {n: c for n, c in v.items() if c}
         for k, v in hd80_launches.items()}), flush=True)
    torch.cuda.empty_cache()
    mesh, mesh_launches = mesh_phase(torch, device, tds, train)
    print_mesh(mesh, smi)
    print("mesh launches: " + json.dumps(
        {k: {n: c for n, c in v.items() if c}
         for k, v in mesh_launches.items()}), flush=True)
    torch.cuda.empty_cache()
    lm_mesh, lm_mesh_launches = lm_mesh_phase(torch, device, rng)
    print_lm_mesh(lm_mesh, smi)
    print("lm mesh launches: " + json.dumps(
        {k: {n: c for n, c in v.items() if c}
         for k, v in lm_mesh_launches.items()}), flush=True)
    by_path = {f"serving {spec}": t for spec, t in totals.items()}
    by_path.update({f"training {spec}": arm["launches"]
                    for spec, arm in train.items()})
    by_path.update({f"paper {arm}": got
                    for arm, got in paper_launch.items()})
    by_path.update(axes_launches)
    by_path.update(plan_launches)
    by_path.update(store_launches)
    by_path.update(lm_launches)
    by_path.update(net_launches)
    by_path.update(lmt_launches)
    by_path.update(fam_launches)
    by_path.update(long_launches)
    by_path.update(hd80_launches)
    by_path.update(mesh_launches)
    by_path.update(lm_mesh_launches)
    kernels = []
    for name, meta in KERNELS.items():
        rec = dict(name=name, **meta,
                   launches=sum(t.get(name, 0) for t in by_path.values()))
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "kernel_only_ms", "kernel_only_count",
                    "host_ms"):
            rec[key] = records[name][key]
        for key in ("max_abs_err_bf16", "library_kernel_only_ms"):
            if key in records[name]:
                rec[key] = records[name][key]
        rec["launches_by_path"] = {k: t.get(name, 0)
                                   for k, t in by_path.items()}
        rec["launches_per_batch"] = {k: v.get(name, 0)
                                     for k, v in per_batch.items()}
        rec["launches_per_training_step"] = {
            spec: arm["launches_per_step"].get(name, 0)
            for spec, arm in train.items()}
        rec["launches_per_paper_step"] = {
            arm: got["launches_per_step"].get(name, 0)
            for arm, got in paper["arms"].items()}
        if rec["launches"] <= 0:
            raise AssertionError(f"kernel {name} was never launched on its "
                                 "path")
        kernels.append(rec)
    for name, rec in prepass.items():
        meta = PREPASS[name]
        kernels.append({"name": name, "route": meta["route"],
                        "source": meta["source"],
                        "replaces": meta["replaces"],
                        **{k: rec[k] for k in (
                            "launches", "max_abs_err", "ms", "plain_ms",
                            "bound_ms", "bound_by", "library_ms",
                            "kernel_only_ms", "kernel_only_count", "host_ms",
                            "library_kernel_only_ms")}})
        if rec["launches"] <= 0:
            raise AssertionError(f"{name} was never launched on its path")
    record = {"kernels": records, "detail": detail, "serving": rep,
              "launches": launches, "micro_batches": batches,
              "launches_per_batch": per_batch,
              "cold_query_breakdown_ms": breakdown, "training": train,
              "paper_model": paper, "axes": axes, "prepass": prepass,
              "planner": plan, "feature_store": store,
              "lm": lm, "lm_launches": lm_launches, "network": net,
              "network_launches": net_launches, "lm_training": lmt,
              "lm_training_launches": lmt_launches, "lm_families": fam,
              "lm_families_launches": fam_launches,
              "lm_long_training": long,
              "lm_long_training_launches": long_launches, "hd80": hd80,
              "hd80_launches": hd80_launches, "mesh": mesh,
              "mesh_launches": mesh_launches, "lm_mesh": lm_mesh,
              "lm_mesh_launches": lm_mesh_launches}
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

    t_start = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} (torch {torch.__version__}, "
          f"cuda {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    print(f"build: {len(SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    ptxas = ptxas_usage(_build.build_log("flash_mha_bwd"))
    print("ptxas flash_mha_bwd: " + "; ".join(
        f"{k} {u['registers']} regs, spills {u['spill_stores']} / "
        f"{u['spill_loads']} B" for k, u in sorted(ptxas.items())),
        flush=True)

    kernels_line, record = run(smi)
    record["nvidia_smi"] = smi
    record["ptxas_flash_mha_bwd"] = ptxas
    record["total_s"] = time.perf_counter() - t_start
    print(f"chip_smoke: every phase passed in {record['total_s']:.1f}s",
          flush=True)
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
