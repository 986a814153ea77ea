"""Layer Profiler (Hermes §IV-1), PyTorch port.

Measures, per shard of a partitioned checkpoint: load time (real disk ->
host -> device, on the same prefetch runtime and the same loader the
Loading Agents use), compute time, one-token decode time against a KV
cache (feeds the generation-aware planner) and byte size.  Every timed
region ends in a compute-stream synchronise, so ``t_comp``/``t_decode``
measure the device work and not the kernel launches.  The profile feeds
the Pipeline Planner.  On an int8/int4 checkpoint the shards are the
quantized ones and the layers run the quantized matmul, so the timings
are that variant's own; the profile's ``quant`` and per-shard ``dtype``
tag it for the planner's dtype search.

Expert-split MoE checkpoints also get per-expert rows: every kind-
``expert`` shard with its manifest bytes, ``t_load`` measured on the first
``expert_sample`` experts of each layer (identically shaped files) and
their median for the rest; a layer's ``t_comp`` / ``t_decode`` run the
expert-streamed step (router, fetch, combine) after a warm-up call has
fetched its experts, so compute and demand loads stay apart for the
planner.  The aggregates ``expert_bytes``, ``expert_t_load``,
``n_experts`` and ``top_k`` feed the planner's expert model.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch.core import telemetry as _tele
from repro_torch.core.engine import PipeloadEngine
from repro_torch.models.config import ModelConfig


def profile_model(ckpt_dir, cfg: ModelConfig, *, batch: int = 1,
                  seq: int = 128, repeats: int = 3, expert_sample: int = 4,
                  device="cuda") -> Dict:
    ckpt_dir = Path(ckpt_dir)
    # the engine supplies the module fns and the device loader; its own
    # runtime (two demand workers) times the loads
    eng = PipeloadEngine(ckpt_dir, cfg, mode="pipeload", num_agents=2,
                         device=device)
    rng = np.random.default_rng(0)
    tokens = eng.tokens(rng.integers(0, cfg.vocab_size, (batch, seq)))
    try:
        with _tele.get_tracer().span("profile_model", model=cfg.name):
            return _profile_model(eng, tokens, repeats=repeats, batch=batch,
                                  seq=seq, expert_sample=expert_sample)
    finally:
        eng.close()


def _timed_device_load(eng: PipeloadEngine, name: str):
    """One disk -> host -> device shard load, timed on a prefetch-runtime
    worker (the path serving takes)."""
    def _load():
        with _tele.get_tracer().span("profile_load", shard=name):
            return eng._load(name)
    return eng.runtime.timed_load(_load)


def _timed(eng: PipeloadEngine, fn, repeats: int):
    """(median seconds over ``repeats`` synchronised calls after one
    warm-up call, fn's output)."""
    out = fn()
    eng._sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        eng._sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def _profile_model(eng: PipeloadEngine, tokens: torch.Tensor, *,
                   repeats: int, batch: int, seq: int,
                   expert_sample: int) -> Dict:
    cfg, fns, manifest, es = eng.cfg, eng.fns, eng.manifest, eng.expert
    profile = {"model": cfg.name, "batch": batch, "seq": seq,
               "quant": manifest.get("quant"),
               "ckpt_dtype": manifest.get("dtype", cfg.dtype),
               "expert_split": es is not None, "device": str(eng.device),
               "shards": []}
    x = None
    expert_rows, expert_t_loads = [], []
    for shard in manifest["shards"]:
        name, kind = shard["name"], shard["kind"]
        if kind == "expert":
            # bytes for every expert, t_load on a sample per layer
            row = {"name": name, "kind": kind, "bytes": shard["bytes"],
                   "index": shard["index"], "expert": shard["expert"],
                   "dtype": shard.get("dtype")}
            if shard["expert"] < expert_sample:
                row["t_load"] = float(np.median(
                    [_timed_device_load(eng, name)[1]
                     for _ in range(repeats)]))
                expert_t_loads.append(row["t_load"])
            expert_rows.append(row)
            profile["shards"].append(row)
            continue
        # ---- load time (disk -> device), re-read every repeat
        t_loads = []
        for _ in range(repeats):
            w, dt = _timed_device_load(eng, name)
            t_loads.append(dt)
        if kind == "embed":
            fn = lambda w_=w: fns["embed"](w_, tokens)      # noqa: E731
        elif kind == "layer" and es is not None:
            # the warm-up call fetches the layer's experts, so the timed
            # calls hit the cache and measure compute
            fn = lambda w_=w, x_=x, nm=name: es.layer(nm, w_, x_)  # noqa
        elif kind == "layer":
            fn = lambda w_=w, x_=x: fns["layer"](w_, x_)    # noqa: E731
        else:
            fn = lambda w_=w, x_=x: fns["head"](w_, x_)     # noqa: E731
        t_comp, out = _timed(eng, fn, repeats)
        row = {"name": name, "kind": kind, "bytes": shard["bytes"],
               "dtype": shard.get("dtype", manifest.get("dtype", cfg.dtype)),
               "t_load": float(np.median(t_loads)), "t_comp": t_comp}
        if kind == "layer":
            # one-token decode against a seq-length KV cache
            k = eng.layer_names.index(name)
            _, cache = eng._layer_cache(k, w, x, seq + 1)
            row["t_decode"], _ = _timed(
                eng, lambda w_=w, c=cache: eng._layer_decode(
                    k, w_, x[:, -1:], c, seq), repeats)
            if es is not None:
                # residency stays one layer's union: the uncapped cache
                # would otherwise gather the model's whole expert pool
                es.clear()
        if kind in ("embed", "layer"):
            x = out
        profile["shards"].append(row)

    layers = [s for s in profile["shards"] if s["kind"] == "layer"]
    profile["layer_t_load"] = float(np.median([s["t_load"] for s in layers]))
    profile["layer_t_comp"] = float(np.median([s["t_comp"] for s in layers]))
    profile["layer_t_decode"] = float(np.median([s["t_decode"]
                                                 for s in layers]))
    profile["layer_bytes"] = int(np.median([s["bytes"] for s in layers]))
    profile["other_bytes"] = int(sum(s["bytes"] for s in profile["shards"]
                                     if s["kind"] not in ("layer",
                                                          "expert")))
    profile["num_layers"] = len(layers)
    if es is not None:
        med_load = (float(np.median(expert_t_loads)) if expert_t_loads
                    else 0.0)
        for row in expert_rows:
            row.setdefault("t_load", med_load)
        profile["expert_bytes"] = int(np.median([r["bytes"]
                                                 for r in expert_rows]))
        profile["expert_t_load"] = med_load
        profile["n_experts"] = cfg.n_experts
        profile["top_k"] = cfg.top_k
    return profile


def save_profile(profile: Dict, path):
    Path(path).write_text(json.dumps(profile, indent=1))


def load_profile(path) -> Dict:
    return json.loads(Path(path).read_text())
