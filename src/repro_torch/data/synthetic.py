"""Seeded synthetic training data, PyTorch port of
``repro/data/synthetic.py``.

Structurally valid batches for every model family (tokens, labels, patch
embeddings, audio frame embeddings).  Tokens mix a Zipf-like unigram draw
with short repeated motifs, so a language model can reduce its loss.  The
draws are numpy's, in the reference's order, so the same seed gives the
same batch element for element; the batch comes back as CPU tensors
(tokens and labels int32, embeddings fp32) and the trainer moves it to
its device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ENCDEC, VLM, ModelConfig


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    flat = rng.choice(vocab, size=int(np.prod(shape)), p=probs)
    toks = flat.reshape(shape).astype(np.int32)
    # repeated motifs: copy a short window forward so context is predictive
    if shape[-1] >= 16:
        toks[..., 8:16] = toks[..., 0:8]
    return toks


def _embeds(rng: np.random.Generator, shape) -> torch.Tensor:
    return torch.from_numpy(
        (rng.standard_normal(shape) * 0.02).astype(np.float32))


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               seed: int = 0) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == VLM:
        n_patch = cfg.num_patches
        assert seq > n_patch, (
            f"VLM seq {seq} must exceed num_patches {n_patch}")
        toks = _zipf_tokens(rng, (batch, seq - n_patch + 1), cfg.vocab_size)
        out["patches"] = _embeds(rng, (batch, n_patch, cfg.d_model))
    elif cfg.family == ENCDEC:
        out["frames"] = _embeds(rng, (batch, cfg.enc_seq_len, cfg.d_model))
        toks = _zipf_tokens(rng, (batch, seq + 1), cfg.vocab_size)
    else:
        toks = _zipf_tokens(rng, (batch, seq + 1), cfg.vocab_size)
    out["tokens"] = torch.from_numpy(np.ascontiguousarray(toks[:, :-1]))
    out["labels"] = torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))
    return out


def batch_iterator(cfg: ModelConfig, batch: int, seq: int,
                   seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    step = 0
    while True:
        yield make_batch(cfg, batch, seq, seed=seed + step)
        step += 1
