"""ViT-Large (Hermes paper workload, Table I: 304M, 24 encoder layers).
d=1024, 16H, d_ff=4096, FP16 (~25 MB/layer per the paper).  The patch
embedder is out of scope for the loading pipeline (embedding layers are
"other layers" in the paper); inputs arrive as patch embeddings.
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="vit-large",
    family=DENSE,
    num_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=1000,          # classifier head
    vocab_pad_to=8,
    head_dim=64,
    causal=False,
    gated_mlp=False,
    dtype="float16",
)
LONG_CONFIG = None
