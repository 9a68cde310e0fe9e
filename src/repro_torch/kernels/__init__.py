# The port's kernels, one hand-written CUDA C++ kernel per TPU kernel on the
# ported paths (sources in csrc/, built by _build at first launch):
#   spmm.py     — spmm_ell / spmm_ell_t: pre-reduced ELL gather-accumulate
#                 (aggregation forward / transpose walk of the backward,
#                 csrc/spmm_ell.cu); spmm / spmm_block: the row-grouped COO
#                 walk over a flat edge list / Block-Message tiles
#                 (csrc/spmm_coo.cu; the block format's forward, its
#                 backward and the coo stacked walk)
#   gemm.py     — gemm: fp32 relu(x @ w + bias) (serving combination)
#   flash.py    — flash_mha: online-softmax attention over [bh, s, hd]
#                 with an optional sliding window (every LM family's
#                 long-prompt prefill, csrc/flash_mha.cu), differentiable
#                 through flash_mha_bwd (dQ, dK, dV; csrc/flash_mha_bwd.cu)
#   ref.py      — their plain PyTorch versions (CPU path, tests, chip_smoke;
#                 mha_ref / mha_bwd_ref for flash_mha / flash_mha_bwd,
#                 spmm_t_ref the Aᵀe oracle)
#                 and row_grouping, the COO walks' host-side grouping
#   ops.py      — ell_apply (the bucket walk + inv_perm placement), the
#                 ell_aggregate autograd Function, and the reference's
#                 padding wrappers spmm / spmm_block
#   edgeplan.py — host-side ELLPACK plan builder + identity-keyed LRU
#   tune.py     — the ELL bucket scheme (get_config), the caps autotuner
#                 and its Hopper caps sweep
from .flash import flash_mha, flash_mha_bwd
from .gemm import gemm
from .ops import ell_aggregate, ell_apply
from .ref import (gemm_ref, mha_bwd_ref, mha_ref, row_grouping,
                  spmm_block_ref, spmm_ell_ref, spmm_ref, spmm_t_ref)
from .spmm import spmm, spmm_block, spmm_ell, spmm_ell_t

__all__ = ["flash_mha", "flash_mha_bwd", "gemm", "ell_aggregate",
           "ell_apply", "gemm_ref",
           "mha_bwd_ref", "mha_ref", "row_grouping",
           "spmm", "spmm_block", "spmm_block_ref", "spmm_ell",
           "spmm_ell_ref", "spmm_ell_t", "spmm_ref", "spmm_t_ref"]
