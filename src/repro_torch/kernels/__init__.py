# The port's kernels, one hand-written CUDA C++ kernel per TPU kernel on the
# ported paths (sources in csrc/, built by _build at first launch):
#   spmm.py     — spmm_ell / spmm_ell_t: pre-reduced ELL gather-accumulate
#                 (aggregation forward / transpose walk of the backward,
#                 csrc/spmm_ell.cu); spmm / spmm_block: the row-grouped COO
#                 walk over a flat edge list / Block-Message tiles
#                 (csrc/spmm_coo.cu; the block format's forward, its
#                 backward and the coo stacked walk)
#   gemm.py     — gemm: fp32 relu(x @ w + bias) (serving combination)
#   ref.py      — their plain PyTorch versions (CPU path, tests, chip_smoke)
#                 and row_grouping, the COO walks' host-side grouping
#   ops.py      — ell_apply (the bucket walk + inv_perm placement), the
#                 ell_aggregate autograd Function, and the reference's
#                 padding wrappers spmm / spmm_block
#   edgeplan.py — host-side ELLPACK plan builder + identity-keyed LRU
#   tune.py     — the default bucket scheme
from .gemm import gemm
from .ops import ell_aggregate, ell_apply
from .ref import (gemm_ref, row_grouping, spmm_block_ref, spmm_ell_ref,
                  spmm_ref)
from .spmm import spmm, spmm_block, spmm_ell, spmm_ell_t

__all__ = ["gemm", "ell_aggregate", "ell_apply", "gemm_ref", "row_grouping",
           "spmm", "spmm_block", "spmm_block_ref", "spmm_ell",
           "spmm_ell_ref", "spmm_ell_t", "spmm_ref"]
