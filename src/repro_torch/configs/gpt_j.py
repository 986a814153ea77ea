"""GPT-J-6B (Hermes paper workload, Table I: 28 decoder layers).
d=4096, 16H, d_ff=16384, vocab 50400.  NOTE: Table I labels GPT-J "FP32"
but its byte counts (12354 MB total, 412 MB/layer) imply 2 bytes/param;
we match the paper's BYTES (float16) — see EXPERIMENTS.md §Paper-validation.
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="gpt-j",
    family=DENSE,
    num_layers=28,
    d_model=4096,
    n_heads=16,
    n_kv_heads=16,
    d_ff=16384,
    vocab_size=50400,
    head_dim=256,
    gated_mlp=False,
    dtype="float16",
)
LONG_CONFIG = None
