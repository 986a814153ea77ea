"""Layer-based model partitioning (Hermes paper §III-A step ①), PyTorch port.

Reads and writes the reference package's on-disk format unchanged:

    <dir>/manifest.json
    <dir>/embed.npz          # embedding ("other layers" in the paper)
    <dir>/layer_000.npz ...  # decoder layers (the 70-95% bulk)
    <dir>/head.npz           # final norm + lm head

Each shard is an ``.npz`` of arrays under flat dotted keys (``attn.w_q``,
``mlp.w_up``, ...); the manifest records byte sizes and kinds so the
Pipeline Planner can reason about the schedule without opening shards.
Weights keep the reference's ``(in, out)`` layout, so every manifest
``bytes`` figure is identical to the reference's for the same model.

The writer is numpy-only: it needs no model framework at all, which is
what lets a checkpoint be written on a machine that has only the port.
Full-precision shards only; a quantized manifest raises.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from repro_torch.models.config import DENSE, ModelConfig

# Families this partitioner (and the port's engine) understand.
PARTITION_FAMILIES = (DENSE,)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported in repro_torch")


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _save_shard(path: Path, name: str, flat: Dict[str, np.ndarray],
                kind: str, index: int, dtype: str) -> dict:
    np.savez(path / f"{name}.npz", **flat)
    nbytes = int(sum(a.nbytes for a in flat.values()))
    return {"name": name, "kind": kind, "index": index, "bytes": nbytes,
            "dtype": dtype}


def partition_and_save(params: dict, cfg: ModelConfig, path) -> dict:
    """Split a dense param tree (stacked ``layers``, leading dim L) into
    shards.  Leaves may be numpy arrays or torch tensors."""
    if cfg.family not in PARTITION_FAMILIES:
        raise _not_ported(f"partitioning model family '{cfg.family}' "
                          f"({cfg.name})")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    shards: List[dict] = []

    def save(name: str, tree: dict, kind: str, index: int = -1):
        shards.append(_save_shard(path, name, _flatten(tree), kind, index,
                                  cfg.dtype))

    save("embed", {"embed": params["embed"]}, "embed")
    stacked = params["layers"]
    for i in range(cfg.num_layers):
        save(f"layer_{i:03d}", tree_map(lambda a: a[i], stacked), "layer", i)
    head_tree = {"final_norm": params["final_norm"]}
    if "lm_head" in params:
        head_tree["lm_head"] = params["lm_head"]
    save("head", head_tree, "head")

    manifest = {
        "model": cfg.name,
        "num_layers": cfg.num_layers,
        "dtype": cfg.dtype,
        "quant": None,
        "shards": shards,
        "total_bytes": int(sum(s["bytes"] for s in shards)),
        "layer_bytes": int(sum(s["bytes"] for s in shards
                               if s["kind"] == "layer")),
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return manifest


def load_manifest(path) -> dict:
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    if manifest.get("quant"):
        raise _not_ported(f"quantized checkpoints ({manifest['quant']})")
    if manifest.get("expert_split"):
        raise _not_ported("expert-split MoE checkpoints")
    return manifest


def shard_names(manifest: dict) -> List[str]:
    return [s["name"] for s in manifest["shards"]]


def load_shard(path, name: str) -> dict:
    """Real disk read -> nested dict of numpy arrays."""
    with np.load(Path(path) / f"{name}.npz") as z:
        flat = {k: z[k] for k in z.files}   # forces the read
    return _unflatten(flat)


def from_jax_params(tree, device="cuda") -> dict:
    """The JAX package's parameter tree (leaves as numpy arrays, e.g. via
    ``jax.tree.map(np.asarray, params)``) -> the port's parameters: the
    same nested dict and layout, as torch tensors on ``device`` (CUDA
    unless the caller asks for the CPU; CUDA without a card raises)."""
    from repro_torch.core.engine import resolve_device
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def to_numpy(tree) -> dict:
    """The port's parameters -> the same tree of numpy arrays."""
    return tree_map(_to_numpy, tree)

