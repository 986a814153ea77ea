"""Yi-9B — llama-architecture dense GQA.  [arXiv:2403.04652]
48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family=DENSE,
    num_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    rope_theta=10_000.0,
)

LONG_CONFIG = CONFIG.with_(sliding_window=8192)
