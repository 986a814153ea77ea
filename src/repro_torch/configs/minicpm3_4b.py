"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention.
[hf:openbmb/MiniCPM3-4B]  62L d_model=2560 40H (MHA) d_ff=6400 vocab=73448.
MLA geometry per the model card: q_lora_rank=768, kv_lora_rank=256,
qk_rope_head_dim=32, v/qk_nope head dim 64.
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family=DENSE,
    num_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=64,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    rope_head_dim=32,
    v_head_dim=64,
    rope_theta=10_000.0,
)

# long_500k: MLA latent cache is ~288 B/token — the 524k cache fits easily
# (see DESIGN.md); runs with the seq-sharded flash-decode path unchanged.
LONG_CONFIG = CONFIG
