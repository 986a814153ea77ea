"""Qwen2-VL-2B — VLM decoder backbone with M-RoPE; vision frontend stubbed.
[arXiv:2409.12191]  28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
``input_specs`` supplies precomputed patch embeddings (1024 patches).
"""
from repro_torch.models.config import VLM, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family=VLM,
    num_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    num_patches=1024,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
)

LONG_CONFIG = CONFIG.with_(sliding_window=8192)
