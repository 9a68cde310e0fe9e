"""chameleon-34b [vlm] — early-fusion token backbone (arXiv:2405.09818):
48L d_model=8192 64H (GQA kv=8) d_ff=22016, fused text+VQ-image vocab
65536.  The VQ image tokenizer is a STUB: image regions arrive as
precomputed token ids inside the fused vocab."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65536, head_dim=128, rope_theta=10_000.0,
    modality_stub="vision",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab=512, head_dim=16)
