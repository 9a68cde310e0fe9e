"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 (hf:stabilityai/stablelm family)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab=50304, head_dim=80, rope_theta=10_000.0,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab=512, head_dim=16)
