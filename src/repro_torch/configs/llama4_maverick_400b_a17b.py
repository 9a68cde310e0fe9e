"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192(expert) vocab=202048, MoE 128 experts top-1, dense:moe layers
interleaved 1:1, early fusion (hf:meta-llama/Llama-4 family)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128,
    moe_experts=128, moe_topk=1, moe_interleave=2, rope_theta=500_000.0,
    modality_stub="vision",
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab=512, head_dim=16, moe_experts=8)
