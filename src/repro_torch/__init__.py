"""PyTorch + CUDA port of :mod:`repro` for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``graph/``, ``core/``,
``kernels/``, ``engine/``, ``serving/``) so every module has a findable
counterpart, and it imports only ``torch`` and numpy — never ``jax`` and
never ``repro`` (the host-side numpy modules it needs are its own copies).

Entry points run on the card unless the caller asks for the CPU: every
``device=`` argument defaults to ``"cuda"`` and raises when no GPU is
present (:func:`repro_torch.device.resolve_device`).  The Pallas kernels of
the reference become hand-written CUDA C++ kernels under
``kernels/csrc/``, built with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`); a wrapper given a CPU tensor runs the
kernel's plain PyTorch version instead (:mod:`repro_torch.kernels.ref`).

Ported so far: the single-device GCN serving path —
``InferenceEngine("ell+pipelined" | "coo+serial")`` with the ``spmm_ell``
and ``gemm`` kernels.
"""
