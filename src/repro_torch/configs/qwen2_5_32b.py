"""Qwen2.5-32B — dense GQA with QKV bias.  [hf:Qwen/Qwen2.5 family]
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family=DENSE,
    num_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

LONG_CONFIG = CONFIG.with_(sliding_window=8192)
