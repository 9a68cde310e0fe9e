# The port's kernels, one hand-written CUDA C++ kernel per TPU kernel on the
# ported paths (sources in csrc/, built by _build at first launch):
#   spmm.py     — spmm_ell / spmm_ell_t: pre-reduced ELL gather-accumulate
#                 (aggregation forward / transpose walk of the backward)
#   gemm.py     — gemm: fp32 relu(x @ w + bias) (serving combination)
#   ref.py      — their plain PyTorch versions (CPU path, tests, chip_smoke)
#   ops.py      — ell_apply (the bucket walk + inv_perm placement) and the
#                 ell_aggregate autograd Function
#   edgeplan.py — host-side ELLPACK plan builder + identity-keyed LRU
#   tune.py     — the default bucket scheme
from .gemm import gemm
from .ops import ell_aggregate, ell_apply
from .ref import gemm_ref, spmm_ell_ref
from .spmm import spmm_ell, spmm_ell_t

__all__ = ["gemm", "ell_aggregate", "ell_apply", "gemm_ref", "spmm_ell",
           "spmm_ell_ref", "spmm_ell_t"]
