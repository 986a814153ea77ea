"""Per-device kernel autotune cache (tile / route selection), the port of
``repro/kernels/autotune.py``.

The kernels expose tuning knobs: ``matmul`` (``streamed_matmul``) and
``quant_matmul`` take ``(block_m, block_n, block_k)`` tiles, and paged
decode can read the pools through the block tables (``"paged"``, the
``paged_flash_decode`` kernel) or gather each row's pages to a dense
cache first (``"gather"``, the ``flash_decode`` kernel).  This module
times a small feasible candidate space on the live device and caches the
winner to disk keyed by ``(kernel, arch, dtype, page_size)``, so repeat
runs skip the sweep.  The profile's ``layer_t_comp`` / ``layer_t_load``
ride along as ``seed`` metadata on the matmul entry, so a stale cache can
be spotted and re-tuned with ``force=True``.

Cache file: the reference's JSON format and ``version``, kept apart from
the reference's own file (whose ``matmul|cpu|...`` keys would collide):
``~/.cache/repro_torch/autotune.json``, or ``$REPRO_TORCH_AUTOTUNE_CACHE``::

    {"version": 1,
     "entries": {
       "matmul|sm90|float32|page=-":      {"block_m": 64, "block_n": 128,
                                           "block_k": 512, "t_us": 61.2,
                                           "shape": [256, 1024, 4096]},
       "quant_matmul8|sm90|int8|page=-":  {...},
       "paged_decode|sm90|float32|page=16": {"impl": "paged", ...}}}

On the card each candidate is timed with CUDA events (TF32 off, as the
kernels never use it); on the CPU with the host clock, where every
candidate runs the same plain version, so the entry records the shape
and the sweep but no kernel's speed.  Selections are applied through
``kernels.ops.set_tuned``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
VERSION = 1

# candidate tile edges (fitted to each shape's divisors before timing)
_BM_CANDIDATES = (64, 128, 256)
_BN_CANDIDATES = (64, 128, 256)
_BK_CANDIDATES = (128, 256, 512)

# shard dtype labels that name a floating type: the sweep runs in it
_FLOAT_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16}


def default_cache_path() -> Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "autotune.json"


def _device(device=None) -> torch.device:
    """The device an entry point tunes on: the card unless the caller asks
    for the CPU (``engine.resolve_device``, which raises without a card)."""
    return resolve_device("cuda" if device is None else device)


def device_arch(device=None) -> str:
    """Stable per-device key: ``sm<major><minor>`` on a CUDA card (``sm90``
    on an H100), ``cpu`` on the CPU."""
    dev = _device(device)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        return f"sm{major}{minor}"
    return "cpu"


class AutotuneCache:
    """Disk-backed map of ``(kernel, arch, dtype, page_size)`` -> choice."""

    def __init__(self, path=None):
        self.path = Path(path) if path is not None else default_cache_path()
        self.entries: Dict[str, dict] = {}
        if self.path.exists():
            try:
                blob = json.loads(self.path.read_text())
                if blob.get("version") == VERSION:
                    self.entries = dict(blob.get("entries", {}))
            except (OSError, ValueError):
                self.entries = {}

    @staticmethod
    def key(kernel: str, *, arch: str, dtype: str,
            page_size: Optional[int] = None) -> str:
        page = "-" if not page_size else str(int(page_size))
        return f"{kernel}|{arch}|{dtype}|page={page}"

    def get(self, kernel: str, *, arch: str, dtype: str,
            page_size: Optional[int] = None) -> Optional[dict]:
        return self.entries.get(self.key(kernel, arch=arch, dtype=dtype,
                                         page_size=page_size))

    def put(self, kernel: str, entry: dict, *, arch: str, dtype: str,
            page_size: Optional[int] = None):
        self.entries[self.key(kernel, arch=arch, dtype=dtype,
                              page_size=page_size)] = entry

    def save(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps({"version": VERSION,
                                   "entries": self.entries}, indent=1))
        tmp.replace(self.path)


def _fit(block: int, dim: int) -> int:
    """Largest tile <= ``block`` that divides ``dim`` (the kernels
    require divisible tiling after clamping)."""
    b = min(block, dim)
    while dim % b:
        b -= 1
    return b


def _median_time(fn, reps: int = 3) -> float:
    """Median seconds of ``reps`` calls of ``fn`` after one warm-up call.
    ``fn`` returns a tensor; on a CUDA tensor each call is timed with CUDA
    events (synchronised), on the CPU with the host clock."""
    out = fn()                                # warm-up (and kernel build)
    if not (torch.is_tensor(out) and out.is_cuda):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))
    torch.cuda.synchronize(out.device)
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / 1e3)
    return float(np.median(ts))


def _tile_candidates(m: int, k: int, n: int,
                     bits: Optional[int]) -> List[Tuple[int, int, int]]:
    cands = []
    for bm in _BM_CANDIDATES:
        for bn in _BN_CANDIDATES:
            for bk in _BK_CANDIDATES:
                t = (_fit(bm, m), _fit(bn, n), _fit(bk, k))
                if bits == 4 and t[2] % 2:
                    continue              # int4 packs two rows per byte
                if t not in cands:
                    cands.append(t)
    return cands


@contextlib.contextmanager
def _no_tf32():
    """fp32 products in full fp32 while timing: the kernels never use
    TF32, and nothing timed beside them may."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def tune_matmul(m: int, k: int, n: int, *, dtype: str = "float32",
                bits: Optional[int] = None,
                cache: Optional[AutotuneCache] = None,
                arch: Optional[str] = None, reps: int = 3,
                force: bool = False, device=None) -> dict:
    """Search ``(block_m, block_n, block_k)`` for ``matmul`` (the
    streamed matmul kernel, ``bits=None``) or ``quant_matmul`` at the
    given shape; the winner is cached per ``(arch, dtype)`` so repeat runs
    skip the timing sweep.  x (and a dense w) are made in ``dtype`` when
    it names a floating type, else in fp32."""
    dev = _device(device)
    cache = cache if cache is not None else AutotuneCache()
    arch = arch or device_arch(dev)
    kernel = "matmul" if bits is None else f"quant_matmul{bits}"
    hit = cache.get(kernel, arch=arch, dtype=dtype)
    if hit is not None and not force:
        return hit
    rng = np.random.default_rng(0)
    fdt = _FLOAT_DTYPES.get(dtype, torch.float32)
    x = torch.from_numpy(rng.standard_normal((m, k))).to(dev, fdt)
    if bits is None:
        w = torch.from_numpy(rng.standard_normal((k, n))).to(dev, fdt)
        run = lambda t: ops.matmul(x, w, block_m=t[0], block_n=t[1],  # noqa: E731,E501
                                   block_k=t[2])
    else:
        if bits == 8:
            w_q = torch.from_numpy(rng.integers(-127, 127, (k, n))).to(
                dev, torch.int8)
        else:
            w_q = torch.from_numpy(rng.integers(0, 256, ((k + 1) // 2,
                                                         n))).to(
                dev, torch.uint8)
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, (n,))).to(
            dev, torch.float32)
        run = lambda t: ops.quant_matmul(x, w_q, scale, bits,  # noqa: E731
                                         block_m=t[0], block_n=t[1],
                                         block_k=t[2])
    best, best_t = None, float("inf")
    with _no_tf32():
        for tile in _tile_candidates(m, k, n, bits):
            dt = _median_time(lambda: run(tile), reps=reps)
            if dt < best_t:
                best, best_t = tile, dt
    entry = {"block_m": best[0], "block_n": best[1], "block_k": best[2],
             "t_us": best_t * 1e6, "shape": [m, k, n]}
    cache.put(kernel, entry, arch=arch, dtype=dtype)
    cache.save()
    return entry


def tune_paged_decode(page_size: int, *, dtype: str = "float32",
                      kv_heads: int = 2, groups: int = 2,
                      head_dim: int = 64, pages_per_row: int = 4,
                      cache: Optional[AutotuneCache] = None,
                      arch: Optional[str] = None, reps: int = 3,
                      force: bool = False, device=None) -> dict:
    """Pick the paged-decode route for this device and page size:
    ``"paged"`` (the block-table kernel) or ``"gather"`` (the pages
    gathered to a dense cache, then the flash-decoding kernel).  Both are
    kernels on the card; on the CPU both run plain versions."""
    dev = _device(device)
    cache = cache if cache is not None else AutotuneCache()
    arch = arch or device_arch(dev)
    hit = cache.get("paged_decode", arch=arch, dtype=dtype,
                    page_size=page_size)
    if hit is not None and not force:
        return hit
    rng = np.random.default_rng(0)
    fdt = _FLOAT_DTYPES.get(dtype, torch.float32)
    b = 2
    pool = pages_per_row * b
    as_t = lambda a, dt=fdt: torch.from_numpy(a).to(dev, dt)  # noqa: E731
    q = as_t(rng.standard_normal((b, kv_heads, groups, head_dim)))
    kp = as_t(rng.standard_normal((pool, page_size, kv_heads, head_dim)))
    vp = as_t(rng.standard_normal(tuple(kp.shape)))
    tables = as_t(rng.permutation(pool).reshape(b, pages_per_row),
                  torch.int32)
    lengths = as_t(np.full((b,), pages_per_row * page_size - 1),
                   torch.int32)
    timings = {impl: _median_time(
        lambda impl=impl: ops.paged_decode(q, kp, vp, tables, lengths,
                                           impl=impl), reps=reps)
        for impl in ops.PAGED_IMPLS}
    impl = min(timings, key=timings.get)
    entry = {"impl": impl, "t_us": timings[impl] * 1e6,
             "t_us_other": max(timings.values()) * 1e6}
    cache.put("paged_decode", entry, arch=arch, dtype=dtype,
              page_size=page_size)
    cache.save()
    return entry


def tune_for_model(cfg, profile: Optional[dict] = None, *,
                   page_size: Optional[int] = None,
                   quant: Optional[str] = None,
                   cache_path=None, tokens: int = 256,
                   reps: int = 3, force: bool = False,
                   apply: bool = True, device=None) -> dict:
    """Model-shaped autotune pass, seeded by the Layer Profiler.

    The matmul sweep runs at the model's FFN shape (``tokens x d_model @
    d_model x d_ff``, the streaming hot spot); the profile supplies the
    shard dtype and its measured ``layer_t_comp`` / ``layer_t_load``,
    stored as ``seed`` metadata on the entry.  Returns the selections and
    (``apply=True``) installs them via ``kernels.ops.set_tuned``.
    """
    dev = _device(device)
    cache = AutotuneCache(cache_path)
    dtype = (profile or {}).get("ckpt_dtype") or getattr(cfg, "dtype",
                                                        "float32")
    quant = quant or (profile or {}).get("quant")
    bits = {"int8": 8, "int4": 4}.get(quant or "")
    m = max(8, int(tokens))
    k = int(cfg.d_model)
    n = int(getattr(cfg, "d_ff", 4 * cfg.d_model))
    seed = None
    if profile:
        seed = {"layer_t_comp": profile.get("layer_t_comp"),
                "layer_t_load": profile.get("layer_t_load")}
    out = {"arch": device_arch(dev), "dtype": dtype}
    mat = tune_matmul(m, k, n, dtype=dtype, cache=cache, reps=reps,
                      force=force, device=dev)
    if seed and "seed" not in mat:
        mat["seed"] = seed
        cache.save()
    out["matmul"] = mat
    if bits is not None:
        out["quant_matmul"] = tune_matmul(m, k, n, dtype=quant, bits=bits,
                                          cache=cache, reps=reps,
                                          force=force, device=dev)
    if page_size:
        head_dim = int(getattr(cfg, "head_dim", 64))
        kv = int(getattr(cfg, "n_kv_heads", None)
                 or getattr(cfg, "n_heads", 2))
        g = max(1, int(getattr(cfg, "n_heads", kv)) // max(kv, 1))
        out["paged_decode"] = tune_paged_decode(
            int(page_size), dtype=dtype, kv_heads=kv, groups=g,
            head_dim=head_dim, cache=cache, reps=reps, force=force,
            device=dev)
    if apply:
        apply_tuning(out)
    return out


def apply_tuning(selection: dict):
    """Install a ``tune_for_model`` selection as process-wide defaults
    for the kernel wrappers (and the auto attn-impl choice)."""
    ops.set_tuned(matmul=selection.get("matmul"),
                  quant_matmul=selection.get("quant_matmul"),
                  paged_impl=(selection.get("paged_decode") or {})
                  .get("impl"))
