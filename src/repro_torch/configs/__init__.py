"""Config registry: 10 assigned architectures + the 4 Hermes paper models.

``get(name)`` validates and returns the full-size ModelConfig (clear
ValueError listing the choices for typos); ``names()`` enumerates the
registry — ``--arch <id>`` in the launchers uses it for argparse
``choices``.  ``get_config(name)`` is the unchecked deep-import
resolver.  Long-context (500k) decode
uses ``long_variant(cfg)``: sub-quadratic archs pass through unchanged,
full-attention dense archs switch to their sliding-window variant (see
DESIGN.md §Shape coverage).
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

from repro_torch.models.config import ModelConfig

_ASSIGNED = [
    "minicpm3_4b",
    "qwen3_moe_235b_a22b",
    "xlstm_1_3b",
    "qwen2_5_32b",
    "yi_34b",
    "zamba2_1_2b",
    "seamless_m4t_medium",
    "qwen2_vl_2b",
    "yi_9b",
    "qwen3_moe_30b_a3b",
]
_PAPER = ["bert_large", "gpt2_base", "vit_large", "gpt_j"]


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def names() -> List[str]:
    """Every registered architecture id (assigned + paper models) — the
    valid ``--arch`` choices."""
    return list(_ASSIGNED) + list(_PAPER)


def get(name: str) -> ModelConfig:
    """Resolve an architecture id (dashes/dots tolerated) to its
    ModelConfig, with a readable error for typos instead of an opaque
    deep-import failure."""
    key = _norm(name)
    if key not in names():
        raise ValueError(
            f"unknown architecture '{name}'; choices: {', '.join(names())}")
    return get_config(key)


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(_ASSIGNED)


def list_paper_models() -> List[str]:
    return list(_PAPER)


def long_variant(cfg: ModelConfig) -> Optional[ModelConfig]:
    """Config used for the long_500k decode shape, or None if skipped."""
    mod = importlib.import_module(f"repro_torch.configs.{_norm(cfg.name)}")
    return getattr(mod, "LONG_CONFIG", cfg)
