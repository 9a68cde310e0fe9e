"""``chip_smoke.ptxas_usage``: the backward kernel's registers and spills
read from a build's ``ptxas -v`` output, as ``nvcc`` prints it."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

LOG = """\
ptxas info    : 12 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS3_PS1_Pfiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS3_PS1_Pfiiiiif
    96 bytes stack frame, 196 bytes spill stores, 144 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 96 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110dkv_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PKfS4_S6_PS2_S7_iiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110dkv_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PKfS4_S6_PS2_S7_iiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 236 registers, used 16 barriers
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Used 8 registers
"""


def test_ptxas_usage_reads_each_instantiation():
    assert chip_smoke.ptxas_usage(LOG) == {
        "dq_kernel<float, 64>": {"registers": 168, "stack": 96,
                                 "spill_stores": 196, "spill_loads": 144},
        "dkv_kernel<bf16, 128>": {"registers": 236, "stack": 0,
                                  "spill_stores": 0, "spill_loads": 0}}


def test_ptxas_usage_of_no_output_is_empty():
    assert chip_smoke.ptxas_usage("") == {}


# the head-dim-80 instantiations (stablelm-3b) as an H100 build prints them,
# beside a forward kernel's entry, which the reading skips
LOG_HD80 = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c184416_12_flash_mha_cu_905f6d6116flash_mha_kernelIfLi80EEEvPKT_S3_S3_PS1_Pfiiiiif' for 'sm_90a'
    256 bytes stack frame, 600 bytes spill stores, 436 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 256 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__bba3cb02_16_flash_mha_bwd_cu_bfbce6e310dkv_kernelIfLi80EEEvPKT_S3_S3_PKfS3_S5_PS1_S6_iiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 245 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__bba3cb02_16_flash_mha_bwd_cu_bfbce6e39dq_kernelIfLi80EEEvPKT_S3_S3_S3_PKfS3_PS1_Pfiiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 215 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__bba3cb02_16_flash_mha_bwd_cu_bfbce6e310dkv_kernelI13__nv_bfloat16Li80EEEvPKT_S4_S4_PKfS4_S6_PS2_S7_iiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 208 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__bba3cb02_16_flash_mha_bwd_cu_bfbce6e39dq_kernelI13__nv_bfloat16Li80EEEvPKT_S4_S4_S4_PKfS4_PS2_Pfiiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 16 barriers
"""


def test_ptxas_usage_reads_the_head_dim_80_instantiations():
    """One consumer warpgroup past hd 64: up to 255 registers a thread, and
    none of the four spills."""
    usage = chip_smoke.ptxas_usage(LOG_HD80)
    assert {k: u["registers"] for k, u in usage.items()} == {
        "dkv_kernel<float, 80>": 245, "dq_kernel<float, 80>": 215,
        "dkv_kernel<bf16, 80>": 208, "dq_kernel<bf16, 80>": 126}
    assert all(u["spill_stores"] == u["spill_loads"] == u["stack"] == 0
               for u in usage.values())
