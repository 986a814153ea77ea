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

``quant="int8" | "int4"`` writes per-channel-scaled integer shards
(``checkpoint/quant.py``): 2-D matmul weights are stored as integer
payload + f32 scales, 1-D params keep the checkpoint dtype, and every
manifest ``bytes`` figure is the *quantized* size, so the planner, the
engine's ledger and the KV decode floor shrink without opening a shard.
``requantize``/``ensure_quantized`` transcode a full-precision
checkpoint shard by shard.  ``load_shard`` restores quantized arrays as
``QuantizedTensor`` leaves.  Expert-split (MoE) manifests raise: that
slice is not ported.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import quant as qz
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
                kind: str, index: int, quant: Optional[str],
                base_dtype: str) -> dict:
    """Write one (possibly quantized) shard and return its manifest row;
    ``bytes`` counts every stored array, ``__meta__``/``__dtype__``
    entries included, as the reference does."""
    fp_bytes = int(sum(a.nbytes for a in flat.values()))
    stored = qz.quantize_flat(flat, quant)
    np.savez(path / f"{name}.npz", **stored)
    nbytes = int(sum(np.asarray(a).nbytes for a in stored.values()))
    row = {"name": name, "kind": kind, "index": index, "bytes": nbytes,
           "dtype": quant or base_dtype}
    if quant:
        row["fp_bytes"] = fp_bytes
        row["scale_bytes"] = int(sum(
            np.asarray(a).nbytes for k, a in stored.items()
            if k.endswith(".__scale__")))
        row["n_quantized"] = sum(1 for k in stored if k.endswith(".__q__"))
    return row


def partition_and_save(params: dict, cfg: ModelConfig, path, *,
                       quant: Optional[str] = None) -> dict:
    """Split a dense param tree (stacked ``layers``, leading dim L) into
    shards.  Leaves may be numpy arrays or torch tensors.  ``quant`` in
    {None, "int8", "int4"} selects the shard precision."""
    if quant is not None and quant not in qz.QUANT_SCHEMES:
        raise ValueError(f"unknown quant {quant!r}; choose from "
                         f"{sorted(qz.QUANT_SCHEMES)}")
    if cfg.family not in PARTITION_FAMILIES:
        raise _not_ported(f"partitioning model family '{cfg.family}' "
                          f"({cfg.name})")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    shards: List[dict] = []

    def save(name: str, tree: dict, kind: str, index: int = -1):
        shards.append(_save_shard(path, name, _flatten(tree), kind, index,
                                  quant, cfg.dtype))

    save("embed", {"embed": params["embed"]}, "embed")
    stacked = params["layers"]
    for i in range(cfg.num_layers):
        save(f"layer_{i:03d}", tree_map(lambda a: a[i], stacked), "layer", i)
    head_tree = {"final_norm": params["final_norm"]}
    if "lm_head" in params:
        head_tree["lm_head"] = params["lm_head"]
    save("head", head_tree, "head")

    manifest = _build_manifest(cfg.name, cfg.num_layers, cfg.dtype, shards,
                               quant)
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return manifest


def _build_manifest(model: str, num_layers: int, dtype: str,
                    shards: List[dict], quant: Optional[str]) -> dict:
    manifest = {
        "model": model,
        "num_layers": num_layers,
        "dtype": dtype,
        "quant": quant,
        "shards": shards,
        "total_bytes": int(sum(s["bytes"] for s in shards)),
        "layer_bytes": int(sum(s["bytes"] for s in shards
                               if s["kind"] == "layer")),
    }
    if quant:
        manifest["quant_scheme"] = qz.SCHEME
        manifest["quant_bits"] = qz.QUANT_SCHEMES[quant][0]
    return manifest


def requantize(src, dst, quant: str) -> dict:
    """Re-write a full-precision partitioned checkpoint as quantized
    shards, one shard at a time (peak host memory = one shard).  The
    manifest records the source's byte total so ``ensure_quantized`` can
    detect a stale transcode."""
    if quant not in qz.QUANT_SCHEMES:
        raise ValueError(f"unknown quant {quant!r}; choose from "
                         f"{sorted(qz.QUANT_SCHEMES)}")
    src, dst = Path(src), Path(dst)
    src_man = load_manifest(src)
    if src_man.get("quant"):
        raise ValueError(
            f"requantize needs a full-precision source checkpoint; "
            f"{src} is already {src_man['quant']}")
    dst.mkdir(parents=True, exist_ok=True)
    shards = []
    for s in src_man["shards"]:
        with np.load(src / f"{s['name']}.npz") as z:
            flat = {k: z[k] for k in z.files}
        shards.append(_save_shard(dst, s["name"], flat, s["kind"],
                                  s["index"], quant, src_man["dtype"]))
    manifest = _build_manifest(src_man["model"], src_man["num_layers"],
                               src_man["dtype"], shards, quant)
    manifest["source_total_bytes"] = src_man["total_bytes"]
    (dst / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return manifest


def ensure_quantized(src, dst, quant: str) -> Path:
    """Transcode ``src`` into quantized shards at ``dst`` unless a CURRENT
    transcode already sits there: the existing manifest carries the right
    ``quant`` tag and the source's byte total.  Without the check, a
    source re-partitioned in place would leave derived shards serving
    the old weights."""
    src, dst = Path(src), Path(dst)
    if (dst / "manifest.json").exists():
        dst_man = load_manifest(dst)
        if (dst_man.get("quant") == quant
                and dst_man.get("source_total_bytes")
                == load_manifest(src)["total_bytes"]):
            return dst
    requantize(src, dst, quant)
    return dst


def load_manifest(path) -> dict:
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    if manifest.get("expert_split"):
        raise _not_ported("expert-split MoE checkpoints")
    return manifest


def shard_names(manifest: dict) -> List[str]:
    return [s["name"] for s in manifest["shards"]]


def load_shard(path, name: str) -> dict:
    """Real disk read -> nested dict of numpy arrays (quantized entries
    come back as QuantizedTensor leaves on the CPU)."""
    with np.load(Path(path) / f"{name}.npz") as z:
        flat = {k: z[k] for k in z.files}   # forces the read
    return qz.restore_tree(_unflatten(flat))


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

