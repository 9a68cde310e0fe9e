"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips with a reason here.  On a machine with one NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

(``chip_smoke.py`` holds every kernel at the shapes of its paths; these
are the edge cases, quick to rerun after a kernel edit.)  No JAX here: the
machine with the card has none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

# f32: the reference's 3e-4 tightened to 1e-5 (kernel and plain version
# differ only in summation order); bf16: the reference's 5e-2
F32_TOL, BF16_TOL = 1e-5, 5e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _qkv(seed, bh, sq, sk, hd, dtype, dev):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((bh, sk, hd)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(a).to(dev, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,sk,hd,qb,kb", [
    (4, 1024, 1024, 64, 128, 256),     # the reference's sweep
    (2, 512, 512, 128, 256, 128),
    (1, 256, 256, 32, 128, 128),
    (2, 256, 256, 16, 128, 128),       # the smoke config's head dim
    (2, 512, 512, 64, 512, 512),       # one tile
    (2, 256, 512, 64, 128, 256),       # sq < sk
    (2, 512, 256, 64, 256, 128),       # sq > sk
    (3, 100, 70, 32, 4, 2),            # ragged for the kernel's 64-tile
])
def test_flash_mha_kernel_matches_plain(causal, bh, sq, sk, hd, qb, kb):
    from repro_torch.kernels import flash_mha, mha_ref

    dev = _card()
    q, k, v = _qkv(sq + sk + hd, bh, sq, sk, hd, torch.float32, dev)
    n0 = flash_mha.launches
    got = flash_mha(q, k, v, causal=causal, q_block=qb, k_block=kb)
    torch.cuda.synchronize()
    assert flash_mha.launches == n0 + 1
    want = mha_ref(q, k, v, causal=causal, q_block=qb)
    assert got.dtype == torch.float32 and got.shape == (bh, sq, hd)
    assert float((got - want).abs().max()) <= F32_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_flash_mha_kernel_bf16(causal):
    from repro_torch.kernels import flash_mha, mha_ref

    dev = _card()
    q, k, v = _qkv(7, 2, 512, 512, 64, torch.bfloat16, dev)
    got = flash_mha(q, k, v, causal=causal, q_block=128, k_block=128)
    want = mha_ref(q, k, v, causal=causal, q_block=128)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL
