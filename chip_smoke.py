#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # one CUDA card, a few minutes

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit, kernel build time (every CUDA
   kernel is built from ``src/repro_torch/kernels/csrc`` by ``nvcc`` into
   ``build/repro_torch_kernels``).  TF32 is turned off.
2. Every kernel against its plain PyTorch version on the card (fp32,
   tolerance 1e-4 max abs error), with its time beside the plain
   version's, one PyTorch library call's (SDPA) and its bound.
3. The main path at full width: a full-size gpt2_base checkpoint (24
   layers, d=1024, fp32, random weights from a numpy seed) served through
   ``repro_torch.launch.serve.run`` — 8 requests, 128-token prompts, 32 new
   tokens, up to 4 in flight, under a budget below the model's size so
   layers stream and are destroyed.  The profile is measured anew.  Both
   kernels must have launched, and the serving loop alone exactly once
   per layer per decode round (flash_decode) and per admitted request's
   prefill (flash_attention).
4. The same requests through the plain versions (``attn_impl=None``): the
   greedy tokens must equal phase 3's, unless the first differing step is
   a tie (top-2 logit gap below 1e-4).
5. One JSON line per kernel set: launches (over the whole ``serve.run``
   call, and inside the serving loop as ``serve_launches``), error, times
   and bounds at the main path's shapes.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repo's ``src/repro_torch`` beside it, it exits 2 and prints
no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpts"

TOL = 1e-4               # fp32, TF32 off: max abs error kernel vs plain
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BUDGET_MB = 900                  # below gpt2_base's ~1.55 GiB of shards
TIE_GAP = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back
    calls, by CUDA events (inputs stay in L2 between calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and fp32 operations over the CUDA-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def decode_case(torch, fd, ref, gen, name, b, s, kv, g, dh, lengths=None):
    dev = "cuda"
    q = torch.randn((b, kv, g, dh), generator=gen, device=dev)
    k = torch.randn((b, s, kv, dh), generator=gen, device=dev)
    v = torch.randn((b, s, kv, dh), generator=gen, device=dev)
    lengths = lengths or [s] * b
    lens = torch.tensor(lengths, device=dev)
    valid = torch.arange(s, device=dev)[None, :] < lens[:, None]
    got = fd.flash_decode_gqa(q, k, v, valid)
    want = ref.decode_gqa_ref(q, k, v, valid)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ms = time_ms(torch, lambda: fd.flash_decode_gqa(q, k, v, valid))
    plain_ms = time_ms(torch, lambda: ref.decode_gqa_ref(q, k, v, valid))
    # library yardstick: SDPA over the same grouped cache and mask
    qs = q.reshape(b, kv * g, 1, dh)
    ks = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vs = v.transpose(1, 2).repeat_interleave(g, dim=1)
    mask = valid[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(qs, ks, vs, attn_mask=mask))
    n_valid = int(sum(lengths))
    nbytes = 4 * (q.numel() + 2 * n_valid * kv * dh + q.numel()) + b * s
    flops = 4 * n_valid * kv * g * dh
    b_ms, b_by = bound(nbytes, flops)
    return dict(kernel="flash_decode", case=name, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def partial_case(torch, fd, ref, gen):
    """(o, m, l) partials over two halves of S, combined, against the
    whole: the contract the sharded decode combine relies on."""
    bh, s, dh = 64, 512, 64
    q = torch.randn((bh, dh), generator=gen, device="cuda")
    k = torch.randn((bh, s, dh), generator=gen, device="cuda")
    v = torch.randn((bh, s, dh), generator=gen, device="cuda")
    valid = torch.arange(s, device="cuda")[None, :] < 400
    valid = valid.expand(bh, s).contiguous()
    parts = [fd.flash_decode_partial(q, k[:, sl].contiguous(),
                                     v[:, sl].contiguous(),
                                     valid[:, sl].contiguous())
             for sl in (slice(0, s // 2), slice(s // 2, s))]
    o = torch.stack([p[0] for p in parts])
    m = torch.stack([p[1][:, 0] for p in parts])
    l = torch.stack([p[2][:, 0] for p in parts])
    got = ref.combine_partials(o, m, l)
    want = ref.decode_ref(q, k, v, valid)
    o1, m1, l1 = fd.flash_decode_partial(q, k, v, valid)
    ro, rm, rl = ref.decode_partial_ref(q, k, v, valid)
    torch.cuda.synchronize()
    err = max((got - want).abs().max().item(),
              (o1 / l1 - ro / rl).abs().max().item(),
              (m1 - rm).abs().max().item())
    return dict(kernel="flash_decode", case="partials over two halves "
                "of S=512, combined", max_abs_err=err)


def attention_case(torch, fa, ref, gen, name, b, s, kv, g, dh, window=None):
    dev = "cuda"
    q = torch.randn((b, s, kv, g, dh), generator=gen, device=dev)
    k = torch.randn((b, s, kv, dh), generator=gen, device=dev)
    v = torch.randn((b, s, kv, dh), generator=gen, device=dev)
    run = lambda: fa.flash_attention_gqa(q, k, v, causal=True,  # noqa: E731
                                         window=window)
    got = run()
    want = ref.attention_gqa_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ms = time_ms(torch, run)
    plain_ms = time_ms(torch, lambda: ref.attention_gqa_ref(
        q, k, v, causal=True, window=window))
    qs = q.reshape(b, s, kv * g, dh).transpose(1, 2)
    ks = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vs = v.transpose(1, 2).repeat_interleave(g, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ids = torch.arange(s, device=dev)
    ok = ids[None, :] <= ids[:, None]
    if window is not None:
        ok &= ids[None, :] > ids[:, None] - window
    if window is None:
        lib = lambda: sdpa(qs, ks, vs, is_causal=True)  # noqa: E731
    else:
        lib = lambda: sdpa(qs, ks, vs, attn_mask=ok)  # noqa: E731
    lib_ms = time_ms(torch, lib)
    pairs = int(ok.sum().item())
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * pairs * b * kv * g * dh
    b_ms, b_by = bound(nbytes, flops)
    return dict(kernel="flash_attention", case=name, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_kernels(torch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [
        decode_case(torch, fd, ref, gen, "main path B=4 S=160 KV=16 G=1 "
                    "dh=64", 4, 160, 16, 1, 64),
        decode_case(torch, fd, ref, gen, "GQA B=4 S=1024 KV=4 G=8 dh=128",
                    4, 1024, 4, 8, 128),
        decode_case(torch, fd, ref, gen, "ragged S=1000 B=4 KV=16 G=1 "
                    "dh=64", 4, 1000, 16, 1, 64,
                    lengths=[1, 333, 640, 1000]),
        partial_case(torch, fd, ref, gen),
        # the scheduler prefills each admitted request on its own
        attention_case(torch, fa, ref, gen, "main path B=1 S=128 H=16 "
                       "dh=64 causal", 1, 128, 16, 1, 64),
        attention_case(torch, fa, ref, gen, "B=4 S=128 H=16 dh=64 causal",
                       4, 128, 16, 1, 64),
        attention_case(torch, fa, ref, gen, "Sq=77 B=2 KV=4 G=2 dh=64 "
                       "causal", 2, 77, 4, 2, 64),
        attention_case(torch, fa, ref, gen, "Sq=77 B=2 KV=4 G=2 dh=64 "
                       "window=32", 2, 77, 4, 2, 64, window=32),
    ]
    for c in cases:
        line = (f"  {c['kernel']:<16} {c['case']:<44} max_abs_err "
                f"{c['max_abs_err']:.3e} (tol {TOL:g})")
        if "ms" in c:
            line += (f"  kernel_ms {c['ms']:.5f} plain_ms "
                     f"{c['plain_ms']:.5f} library_ms {c['library_ms']:.5f}"
                     f" bound_ms {c['bound_ms']:.5f} ({c['bound_by']})")
        print(line, flush=True)
    bad = [c for c in cases if not c["max_abs_err"] <= TOL]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    return cases


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------
MAIN = dict(requests=8, prompt_len=128, new_tokens=32, max_inflight=4)


def serve(torch, attn_impl):
    from repro_torch.launch import serve as serve_mod
    return serve_mod.run("gpt2_base", budget_mb=BUDGET_MB, reduced=False,
                         device="cuda", ckpt_root=CKPT_ROOT,
                         attn_impl=attn_impl, **MAIN)


def check_outputs(outs, vocab: int) -> None:
    import numpy as np
    if len(outs) != MAIN["requests"]:
        fail(f"{len(outs)} requests finished, expected {MAIN['requests']}")
    for rid, toks in outs.items():
        toks = np.asarray(toks)
        if toks.shape != (MAIN["prompt_len"] + MAIN["new_tokens"],):
            fail(f"req{rid}: token shape {toks.shape}")
        if toks.min() < 0 or toks.max() >= vocab:
            fail(f"req{rid}: token ids outside [0, {vocab})")


def tie_gap(torch, cfg, prefix) -> float:
    """Top-2 logit gap of the plain path's next-token logits after
    ``prefix`` (a full re-prefill of the prefix)."""
    from repro_torch.core import PipeloadEngine
    ckpt = CKPT_ROOT / cfg.name
    with PipeloadEngine(ckpt, cfg, mode="pipeload", num_agents=4,
                        attn_impl=None) as eng:
        logits, _ = eng.run_single([list(map(int, prefix))])
    top2 = torch.topk(logits[0], 2).values
    return float(top2[0] - top2[1])


def expected_serve_launches(stats, n_layers: int) -> dict:
    """Launches the serving loop must make: one flash_decode per layer per
    round with a decoder in flight, one flash_attention per layer per
    admitted request's prefill (a request admitted at round a and retired
    at round f decodes in rounds a+1..f)."""
    admit = {rid: r for kind, rid, r, _ in stats.policy if kind == "admit"}
    retire = {rid: r for kind, rid, r, _ in stats.policy if kind == "retire"}
    decode_rounds = set()
    for rid, a in admit.items():
        decode_rounds.update(range(a + 1, retire[rid] + 1))
    return {"flash_decode": n_layers * len(decode_rounds),
            "flash_attention": n_layers * len(admit)}


def time_split(stats, cfg) -> str:
    """Where the main path's wall time went, from the run's own event
    log (loads are summed over the Loading Agents, which overlap) and the
    Layer Profiler's per-layer medians."""
    spans = {}
    for t, kind, key in stats.events:
        spans.setdefault((kind, key), []).append(t)
    load = sum(e - s for (k, key), st in spans.items() if k == "load_start"
               for s, e in zip(st, spans[("load_end", key)]))
    comp = sum(e - s for (k, key), st in spans.items() if k == "comp_start"
               for s, e in zip(st, spans[("comp_end", key)]))
    prof = json.loads((CKPT_ROOT / cfg.name /
                       "profile_torch_cuda.json").read_text())
    return (f"time split: wall {stats.latency_s:.3f}s over {stats.rounds} "
            f"rounds; shard loads {load:.3f}s summed over agents; layer "
            f"compute {comp:.3f}s; profile per layer t_load "
            f"{prof['layer_t_load'] * 1e3:.3f}ms t_comp "
            f"{prof['layer_t_comp'] * 1e3:.3f}ms t_decode "
            f"{prof['layer_t_decode'] * 1e3:.3f}ms")


def phase_main(torch, ops):
    from repro_torch.configs import get
    cfg = get("gpt2_base")
    t0 = time.perf_counter()
    from repro_torch.launch.serve import ensure_checkpoint
    ensure_checkpoint(cfg, root=CKPT_ROOT)
    print(f"checkpoint: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"written in {time.perf_counter() - t0:.1f}s", flush=True)
    # profile anew on every run, so the schedule and the launch counts do
    # not depend on an earlier run; the plain run below reuses it
    (CKPT_ROOT / cfg.name / "profile_torch_cuda.json").unlink(missing_ok=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    outs, stats = serve(torch, "auto")
    launches = dict(ops.LAUNCHES)
    alloc_peak = torch.cuda.max_memory_allocated()
    want = expected_serve_launches(stats, cfg.num_layers)
    print(f"kernel launches: serve.run {json.dumps(launches)} (profiling "
          f"and warm-up included); serving loop "
          f"{json.dumps(stats.kernel_launches)}, expected {json.dumps(want)}",
          flush=True)
    if stats.kernel_launches != want:
        fail(f"serving-loop launches {stats.kernel_launches} != {want}")
    print(f"main path: rounds {stats.rounds}, {stats.tokens_per_s:.3f} "
          f"tok/s aggregate, ledger peak {stats.peak_bytes} bytes "
          f"(budget {BUDGET_MB * 2**20}), breakdown "
          f"{json.dumps(stats.peak_breakdown)}, "
          f"torch.cuda.max_memory_allocated {alloc_peak}, shard loads "
          f"{stats.loads}, streamed {stats.streamed_bytes / 2**20:.1f} MB",
          flush=True)
    print(time_split(stats, cfg), flush=True)
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if stats.peak_bytes > BUDGET_MB * 2**20:
        fail(f"ledger peak {stats.peak_bytes} above the budget")
    check_outputs(outs, cfg.padded_vocab)

    ops.reset_launches()
    outs_plain, _ = serve(torch, None)
    if any(ops.LAUNCHES.values()):
        fail(f"attn_impl=None launched kernels: {ops.LAUNCHES}")
    check_outputs(outs_plain, cfg.padded_vocab)
    for rid, toks in outs.items():
        other = outs_plain[rid]
        diff = [i for i in range(len(toks)) if toks[i] != other[i]]
        if diff:
            gap = tie_gap(torch, cfg, toks[:diff[0]])
            print(f"req{rid}: tokens differ first at {diff[0]}; plain "
                  f"top-2 logit gap there {gap:.3e}", flush=True)
            if gap >= TIE_GAP:
                fail(f"req{rid}: kernel and plain greedy tokens differ at "
                     f"step {diff[0]} (gap {gap:.3e})")
    print("kernel vs plain greedy tokens: identical"
          if all((outs[r] == outs_plain[r]).all() for r in outs)
          else "kernel vs plain greedy tokens: differ only at ties",
          flush=True)
    return launches, stats


# ---------------------------------------------------------------------------
def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the repo's src/repro_torch is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build, ops

    # ---- phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} ({smi}), torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    for k in build.KERNELS:
        build.library(k)
    print(f"kernels built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(build.BUILD_SECONDS)})", flush=True)

    # ---- phase 2: kernels against their plain versions
    cases = phase_kernels(torch)

    # ---- phases 3 and 4: the main path, kernels then plain
    launches, stats = phase_main(torch, ops)

    # ---- phase 5: the kernels line
    meta = {
        "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:57"),
        "flash_attention": ("src/repro_torch/kernels/csrc/"
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:62"),
    }
    kernels = []
    for kname, (source, replaces) in meta.items():
        mine = [c for c in cases if c["kernel"] == kname]
        main_case = next(c for c in mine if c["case"].startswith("main"))
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "serve_launches": stats.kernel_launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
