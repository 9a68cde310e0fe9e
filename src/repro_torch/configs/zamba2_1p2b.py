"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
(arXiv:2411.15242).  38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000,
ssm_state=64; the single shared transformer block is applied every 6th layer
(6 applications over 38 layers)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    attn_every=6,
)

SMOKE = CONFIG.scaled(n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab=512, head_dim=16, ssm_head_dim=16)
