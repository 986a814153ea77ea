"""GPT-2-Base (Hermes paper workload, Table I: 355M, 24 decoder layers).
d=1024, 16H, d_ff=4096, vocab 50257, FP32, ~51 MB/layer.
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="gpt2-base",
    family=DENSE,
    num_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=50257,
    head_dim=64,
    gated_mlp=False,
    dtype="float32",
)
LONG_CONFIG = None
