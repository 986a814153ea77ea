"""Yi-34B — llama-architecture dense GQA.  [arXiv:2403.04652]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family=DENSE,
    num_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5_000_000.0,
)

LONG_CONFIG = CONFIG.with_(sliding_window=8192)
