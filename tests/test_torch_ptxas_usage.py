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
