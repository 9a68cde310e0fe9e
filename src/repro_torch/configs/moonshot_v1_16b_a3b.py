"""moonshot-v1-16b-a3b [moe] — kimi/moonlight-style fine-grained MoE:
48L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=163840, 64 experts
top-6, all layers MoE (hf:moonshotai/Moonlight-16B-A3B)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, head_dim=128,
    moe_experts=64, moe_topk=6, moe_interleave=1, rope_theta=50_000.0,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=32, vocab=512, head_dim=16, moe_experts=8,
                      moe_topk=2)
