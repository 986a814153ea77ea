"""SeamlessM4T-medium backbone — encoder-decoder, audio frontend stubbed.
[arXiv:2308.11596]  12L enc + 12L dec, d_model=1024 16H d_ff=4096
vocab=256206.  ``input_specs`` supplies precomputed frame embeddings.
"""
from repro_torch.models.config import ENCDEC, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family=ENCDEC,
    num_layers=12,
    enc_layers=12,
    enc_seq_len=1024,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
)

# long_500k SKIPPED: enc-dec full self+cross attention, no sub-quadratic
# variant in the source model (DESIGN.md shape-coverage table).
LONG_CONFIG = None
