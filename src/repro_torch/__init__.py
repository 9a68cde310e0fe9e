"""PyTorch + CUDA port of :mod:`repro` for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``graph/``, ``core/``,
``kernels/``, ``engine/``, ``serving/``, ``models/``, ``configs/``,
``launch/``) so every module has a findable
counterpart, and it imports only ``torch`` and numpy — never ``jax`` and
never ``repro`` (the host-side numpy modules it needs are its own copies).

Entry points run on the card unless the caller asks for the CPU: every
``device=`` argument defaults to ``"cuda"`` and raises when no GPU is
present (:func:`repro_torch.device.resolve_device`).  The Pallas kernels of
the reference become hand-written CUDA C++ kernels under
``kernels/csrc/``, built with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`); a wrapper given a CPU tensor runs the
kernel's plain PyTorch version instead (:mod:`repro_torch.kernels.ref`).

Ported so far:

1. GCN serving — ``InferenceEngine("ell+pipelined" | "coo+serial")`` with
   the ``spmm_ell`` and ``gemm`` kernels;
2. GCN training on P stacked cores — ``Trainer`` / ``Engine.build`` on
   ``ell+pipelined`` (hypercube fold) with the ``spmm_ell_t`` backward;
3. the Block-Message format ``block+pipelined`` for serving and training,
   with the ``spmm_block`` and flat ``spmm`` kernels (also the ``coo``
   stacked walk);
4. LM serving and training for all five families (dense, MoE, SSM,
   hybrid, encoder-decoder) — ``models.lm`` (``prefill_fn``,
   ``decode_fn``, ``train_step_fn``), ``launch.lm_serve.Server`` for the
   decoder-only archs and ``launch.train.train_lm``, with the
   ``flash_mha`` kernel (and its sliding window, gemma3's local layers)
   for prompts longer than 8192 tokens;
5. the paper's model and its Table-1 arms — ``launch.train.train_gcn``
   (GCN / GraphSAGE, the §4.4 order estimator, the transpose-free ``coo``
   layer or the naive baseline, momentum SGD) on one device through the
   ``gemm`` and flat ``spmm`` kernels, and the UMA baseline;
6. the Engine's other axes (ring / allpairs / torus2d, ``mincom``,
   ``merge="redundancy"``) and ``Engine("auto")``'s planner;
7. out-of-core feature stores — ``featurestore`` (host / mmap,
   ``HotVertexCache``), ``make_dataset(features=)``, the staged input
   chain, ``Trainer(feature_store=, cache_capacity=)``,
   ``InferenceEngine(feature_cache_capacity=)`` and the ``launch.serve``
   CLI.
"""
