"""Qwen3-MoE-235B-A22B — 94L MoE, 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B family]  d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936.
"""
from repro_torch.models.config import MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family=MOE,
    num_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=151936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    expert_d_ff=1536,
    rope_theta=1_000_000.0,
)

# long_500k: full attention is quadratic -> sliding-window variant (8192),
# per DESIGN.md shape-coverage table.
LONG_CONFIG = CONFIG.with_(sliding_window=8192)
