"""Zamba2-1.2B — Mamba2 backbone + weight-tied shared attention block.
[arXiv:2411.15242]  38L d_model=2048, shared attn 32H, d_ff=8192 (shared
block MLP), ssm_state=64, vocab=32000.
"""
from repro_torch.models.config import MAMBA_HYBRID, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family=MAMBA_HYBRID,
    num_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=128,           # attention at concat width 2*d_model = 32*128
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=128,
    shared_attn_every=6,    # 6 shared-attention sites over 38 layers
)

# long_500k: Mamba2 state is O(1); the shared attention sites switch to a
# 4096 sliding window so the hybrid stays sub-quadratic end to end.
LONG_CONFIG = CONFIG.with_(sliding_window=4096)
