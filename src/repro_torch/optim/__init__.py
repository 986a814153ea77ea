"""Optimiser: AdamW with the reference's cosine schedule."""
from repro_torch.optim.adamw import (adamw_init, adamw_update,  # noqa: F401
                                     cosine_lr)
