"""Unified model configuration for every architecture family in the zoo.

One ``ModelConfig`` describes any of: dense GQA/MLA transformers, MoE
transformers, xLSTM stacks, Mamba2 hybrids, encoder-decoder models and
VLM/audio decoder backbones.  ``reduced()`` produces the CPU-smoke variant
mandated by the assignment (<=2 layers, d_model<=512, <=4 experts).

PyTorch port of ``repro/models/config.py``: the fields and ``reduced()``
are unchanged; ``torch_dtype`` takes the place of ``jnp_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Architecture families.
DENSE = "dense"          # pre-norm GQA decoder (llama-style)
MOE = "moe"              # dense attention + MoE FFN (qwen3-moe style)
XLSTM = "xlstm"          # mLSTM/sLSTM stack (arXiv:2405.04517)
MAMBA_HYBRID = "hybrid"  # Mamba2 backbone + shared attention (zamba2)
ENCDEC = "encdec"        # encoder-decoder (seamless-m4t backbone)
VLM = "vlm"              # decoder backbone w/ M-RoPE consuming patch embeds

FAMILIES = (DENSE, MOE, XLSTM, MAMBA_HYBRID, ENCDEC, VLM)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 128
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0

    # Attention flavour -----------------------------------------------------
    attention: str = "gqa"            # "gqa" | "mla"
    causal: bool = True               # False for encoder-only (BERT / ViT)
    gated_mlp: bool = True            # False = classic 2-matrix MLP
    sliding_window: Optional[int] = None  # window size; None = full attention
    # MLA (MiniCPM3 / DeepSeek-style latent attention)
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    rope_head_dim: int = 32
    v_head_dim: int = 64

    # MoE --------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0

    # SSM / xLSTM ------------------------------------------------------------
    ssm_state: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128              # chunk size for SSD / chunkwise mLSTM
    slstm_every: int = 8              # 7:1 mLSTM:sLSTM ratio -> every 8th
    shared_attn_every: int = 6        # zamba2: shared attn block period

    # Encoder-decoder ----------------------------------------------------------
    enc_layers: int = 0               # encoder depth (ENCDEC only)
    enc_seq_len: int = 1024           # encoder (audio-frame) length stub

    # VLM ---------------------------------------------------------------------
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w rope split
    num_patches: int = 1024           # vision patch embeds length stub

    # Numerics / misc ----------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    vocab_pad_to: int = 2048          # pad vocab so the model axis divides it
    remat: bool = True                # activation checkpointing on layer scan

    # ---------------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_heads_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def kv_cache_dim(self) -> int:
        """Per-token per-layer cache width (features)."""
        if self.attention == "mla":
            return self.kv_lora_rank + self.rope_head_dim
        return 2 * self.n_kv_heads * self.head_dim

    def cache_bytes(self, batch: int, seq: int) -> int:
        """Per-LAYER KV-cache bytes for a (batch, seq) decode workload.

        The engine charges this to the memory ledger per layer and the
        Pipeline Planner adds ``num_layers * cache_bytes`` to its peak
        model, so weights + cache share one budget."""
        return int(batch * seq * self.kv_cache_dim * self.torch_dtype.itemsize)

    def validate(self) -> None:
        assert self.family in FAMILIES, self.family
        if self.n_kv_heads:
            assert self.n_heads % self.n_kv_heads == 0, (
                f"{self.name}: n_heads={self.n_heads} not divisible by "
                f"n_kv_heads={self.n_kv_heads}")
        if self.family == MOE:
            assert self.n_experts > 0 and self.top_k > 0
        if self.family == ENCDEC:
            assert self.enc_layers > 0

    # ---------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant of the same family (assignment carve-down)."""
        d_model = min(self.d_model, 256)
        head_dim = 32
        n_kv = min(self.n_kv_heads, 2) or 1
        n_heads = n_kv * min(self.q_heads_per_kv, 2)
        changes = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            vocab_pad_to=128,
            dtype="float32",
            ssm_state=16,
            ssm_chunk=16,
            enc_seq_len=32,
            num_patches=16,
            q_lora_rank=64,
            kv_lora_rank=32,
            rope_head_dim=16,
            v_head_dim=32,
            slstm_every=2,
            shared_attn_every=2,
            mrope_sections=(4, 6, 6),  # sums to reduced head_dim // 2
            remat=False,
        )
        if self.family == MOE:
            changes.update(n_experts=4, top_k=2, expert_d_ff=64)
        if self.family == ENCDEC:
            changes.update(enc_layers=2)
        if self.sliding_window is not None:
            changes.update(sliding_window=16)
        return dataclasses.replace(self, **changes)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
