"""Qwen3-MoE-30B-A3B — 48L MoE, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]
d_model=2048 32H (GQA kv=4) expert d_ff=768 vocab=151936.
"""
from repro_torch.models.config import MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family=MOE,
    num_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=151936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    expert_d_ff=768,
    rope_theta=1_000_000.0,
)

LONG_CONFIG = CONFIG.with_(sliding_window=8192)
