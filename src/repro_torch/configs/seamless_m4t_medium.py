"""seamless-m4t-medium [audio] — encoder-decoder multimodal backbone
(arXiv:2308.11596): 12L enc + 12L dec, d_model=1024 16H (kv=16) d_ff=4096
vocab=256206.  The speech frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings; the decoder trains
teacher-forced with dec_len = seq_len // 4 text tokens."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64, rope_theta=10_000.0,
    modality_stub="audio",
)

SMOKE = CONFIG.scaled(n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=4, d_ff=128, vocab=512, head_dim=16)
