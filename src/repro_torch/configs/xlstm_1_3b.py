"""xLSTM-1.3B — sLSTM + mLSTM stack (7:1).  [arXiv:2405.04517]
48L d_model=2048 4H vocab=50304; no FFN (d_ff=0): the mLSTM up-projection
carries the channel mixing.
"""
from repro_torch.models.config import XLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family=XLSTM,
    num_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    slstm_every=8,          # 7 mLSTM : 1 sLSTM
    ssm_chunk=128,
)

LONG_CONFIG = CONFIG  # O(1) recurrent state: long_500k runs natively
