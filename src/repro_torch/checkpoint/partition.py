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
``QuantizedTensor`` leaves.

MoE-family checkpoints default to the **expert split**
(``expert_split=True``): each layer becomes an attention+router shard
(kind ``"layer"``, the pipeline stage the Loading Agents stream) plus one
shard per expert (kind ``"expert"``, named ``layer_<i>_expert_<e>``, with
its layer's ``index`` and its ``expert`` id); the router stays fp32.  The
manifest adds ``expert_split``, ``experts_per_layer`` and
``expert_total_bytes``.  ``expert_split=False`` keeps whole-layer shards.
``requantize`` transcodes expert shards like any other (the ``expert``
rows kept), so int8 / int4 expert streaming reads the same layout.

bfloat16 leaves are stored as the JAX package stores them (a 2-byte void
array, ``checkpoint/quant.py``), header and bytes alike, and
``load_shard`` returns them as ``torch.bfloat16`` tensors.
"""
from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import quant as qz
from repro_torch.models.config import DENSE, MOE, VLM, ModelConfig

# Families this partitioner (and the port's engine) understand.
PARTITION_FAMILIES = (DENSE, MOE, VLM)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported in repro_torch")


def _to_numpy(a) -> np.ndarray:
    """A leaf as numpy; bfloat16 (torch or ``ml_dtypes``) becomes the
    2-byte void view of the same bytes."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return qz.bf16_to_numpy(a)
        return a.detach().cpu().numpy()
    a = np.asarray(a)
    return a.view(qz.BF16) if qz.is_bf16(a) else a


def _savez(path: Path, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez``, except that a bfloat16 leaf's header says ``'<V2'``,
    as ``ml_dtypes.bfloat16`` writes it, so the port's shards are the JAX
    package's member for member (numpy's own void header says
    ``'|V2'``)."""
    fmt = np.lib.format
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            val = np.asanyarray(val)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if qz.is_bf16(val):
                    val = np.ascontiguousarray(val)
                    header = fmt.header_data_from_array_1_0(val)
                    header["descr"] = "<V2"
                    fmt.write_array_header_1_0(fid, header)
                    fid.write(val.tobytes())
                else:
                    fmt.write_array(fid, val)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


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
                base_dtype: str, extra: Optional[dict] = None) -> dict:
    """Write one (possibly quantized) shard and return its manifest row;
    ``bytes`` counts every stored array, ``__meta__``/``__dtype__``
    entries included, as the reference does."""
    fp_bytes = int(sum(a.nbytes for a in flat.values()))
    stored = qz.quantize_flat(flat, quant)
    _savez(path / f"{name}.npz", stored)
    nbytes = int(sum(np.asarray(a).nbytes for a in stored.values()))
    row = {"name": name, "kind": kind, "index": index, "bytes": nbytes,
           "dtype": quant or base_dtype}
    if extra:
        row.update(extra)
    if quant:
        row["fp_bytes"] = fp_bytes
        row["scale_bytes"] = int(sum(
            np.asarray(a).nbytes for k, a in stored.items()
            if k.endswith(".__scale__")))
        row["n_quantized"] = sum(1 for k in stored if k.endswith(".__q__"))
    return row


def partition_and_save(params: dict, cfg: ModelConfig, path, *,
                       quant: Optional[str] = None,
                       expert_split: Optional[bool] = None) -> dict:
    """Split a dense, MoE or VLM param tree (stacked ``layers``, leading
    dim L) into shards (a VLM's ``patch_proj`` rides in the embed shard).
    Leaves may be numpy arrays or torch tensors.  ``quant`` in {None,
    "int8", "int4"} selects the shard precision;
    ``expert_split`` (MoE only, the default there) writes one shard per
    expert beside each layer's attention+router shard."""
    if quant is not None and quant not in qz.QUANT_SCHEMES:
        raise ValueError(f"unknown quant {quant!r}; choose from "
                         f"{sorted(qz.QUANT_SCHEMES)}")
    if cfg.family not in PARTITION_FAMILIES:
        raise _not_ported(f"partitioning model family '{cfg.family}' "
                          f"({cfg.name})")
    if expert_split is None:
        expert_split = cfg.family == MOE
    if expert_split and cfg.family != MOE:
        raise ValueError(
            f"expert_split needs an MoE-family config; '{cfg.name}' is "
            f"family '{cfg.family}'")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    shards: List[dict] = []

    def save(name: str, tree: dict, kind: str, index: int = -1,
             extra: Optional[dict] = None):
        shards.append(_save_shard(path, name, _flatten(tree), kind, index,
                                  quant, cfg.dtype, extra))

    embed_tree = {"embed": params["embed"]}
    if "patch_proj" in params:
        embed_tree["patch_proj"] = params["patch_proj"]
    save("embed", embed_tree, "embed")
    stacked = params["layers"]
    for i in range(cfg.num_layers):
        layer = tree_map(lambda a: a[i], stacked)
        if expert_split:
            moe_p = layer.pop("moe")
            layer["moe"] = {"router": moe_p["router"]}
            save(f"layer_{i:03d}", layer, "layer", i)
            for e in range(cfg.n_experts):
                save(f"layer_{i:03d}_expert_{e:03d}",
                     {k: moe_p[k][e] for k in ("w_gate", "w_up", "w_down")},
                     "expert", i, extra={"expert": e})
        else:
            save(f"layer_{i:03d}", layer, "layer", i)
    head_tree = {"final_norm": params["final_norm"]}
    if "lm_head" in params:
        head_tree["lm_head"] = params["lm_head"]
    save("head", head_tree, "head")

    manifest = _build_manifest(cfg.name, cfg.num_layers, cfg.dtype, shards,
                               quant, expert_split=expert_split)
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return manifest


def _build_manifest(model: str, num_layers: int, dtype: str,
                    shards: List[dict], quant: Optional[str], *,
                    expert_split: bool = False) -> dict:
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
    if expert_split:
        expert_rows = [s for s in shards if s["kind"] == "expert"]
        manifest["expert_split"] = True
        manifest["expert_total_bytes"] = int(sum(s["bytes"]
                                                 for s in expert_rows))
        manifest["experts_per_layer"] = (len(expert_rows) // num_layers
                                         if num_layers else 0)
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
        # a bfloat16 leaf comes back as 2-byte void and is quantized
        # from its values widened to fp32
        extra = {"expert": s["expert"]} if "expert" in s else None
        shards.append(_save_shard(dst, s["name"], flat, s["kind"],
                                  s["index"], quant, src_man["dtype"],
                                  extra))
    manifest = _build_manifest(src_man["model"], src_man["num_layers"],
                               src_man["dtype"], shards, quant,
                               expert_split=bool(
                                   src_man.get("expert_split")))
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
    return json.loads((Path(path) / "manifest.json").read_text())


def shard_names(manifest: dict) -> List[str]:
    return [s["name"] for s in manifest["shards"]]


def load_shard(path, name: str) -> dict:
    """Real disk read -> nested dict of numpy arrays (quantized entries
    come back as QuantizedTensor leaves on the CPU, bfloat16 ones as
    ``torch.bfloat16`` tensors over the bytes read)."""
    with np.load(Path(path) / f"{name}.npz") as z:
        flat = {k: z[k] for k in z.files}   # forces the read
    flat = {k: qz.bf16_to_torch(a) if qz.is_bf16(a) else a
            for k, a in flat.items()}
    return qz.restore_tree(_unflatten(flat))


def from_jax_params(tree, device="cuda") -> dict:
    """The JAX package's parameter tree (leaves as numpy arrays, e.g. via
    ``jax.tree.map(np.asarray, params)``) -> the port's parameters: the
    same nested dict and layout, as torch tensors on ``device`` (CUDA
    unless the caller asks for the CPU; CUDA without a card raises)."""
    from repro_torch.core.engine import resolve_device
    dev = resolve_device(device)

    def leaf(a):
        a = _to_numpy(np.array(a, copy=True))
        t = qz.bf16_to_torch(a) if qz.is_bf16(a) else torch.from_numpy(a)
        return t.to(dev)
    return tree_map(leaf, tree)


def to_numpy(tree) -> dict:
    """The port's parameters -> the same tree of numpy arrays."""
    return tree_map(_to_numpy, tree)

