"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5 local (sliding-window 1024) : 1 global attention pattern,
128k context (hf:google/gemma-3 family)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab=262144, head_dim=128,
    sliding_window=1024, global_every=6, rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab=512, head_dim=16)
