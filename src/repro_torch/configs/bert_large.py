"""BERT-Large (Hermes paper workload, Table I).
24 encoder layers, d=1024, 16H, d_ff=4096, vocab 30522, FP32, non-causal,
classic (non-gated) MLP so per-layer bytes match the paper's ~55 MB/layer.
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="bert-large",
    family=DENSE,
    num_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30522,
    head_dim=64,
    causal=False,
    gated_mlp=False,
    dtype="float32",
)
LONG_CONFIG = None
