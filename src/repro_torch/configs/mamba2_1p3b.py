"""mamba2-1.3b [ssm] — SSD, attention-free (arXiv:2405.21060):
48L d_model=2048, d_inner=4096 (expand 2), ssm_state=128, head_dim=64
(64 SSM heads), vocab=50280."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
)

SMOKE = CONFIG.scaled(n_layers=3, d_model=64, vocab=512, ssm_head_dim=16)
