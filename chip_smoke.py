#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # one CUDA card, about ten minutes

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit, kernel build time (every CUDA
   kernel is built from ``src/repro_torch/kernels/csrc`` by ``nvcc`` into
   ``build/repro_torch_kernels``, one ``nvcc`` per source, in parallel),
   each library's ``-Xptxas -v`` registers and spills, and the two matmul
   libraries' tensor-core instructions (``HMMA`` / ``HGMMA`` in
   ``cuobjdump -sass``): it fails if either holds none.  TF32 is turned
   off for PyTorch's own matmuls.
2. Every kernel against its plain PyTorch version on the card (fp32,
   tolerance 1e-4 max abs error; for quantized_matmul and streamed_matmul
   1e-4 of the output's largest magnitude; fp16 / bf16 inputs 2e-3 /
   1.6e-2 of it), with its time beside the plain version's,
   one PyTorch library call's (SDPA; for the paged kernels on K/V already
   gathered to dense, the gather not timed; for quantized_matmul
   ``torch.matmul`` on the weight dequantized to fp32 beforehand, not
   timed) and its bound.  quantized_matmul runs at every shape the quant
   phases give it (decode M=4, prefill M=128, the prefill's head M=1),
   int8 and int4.  fp16 and bf16 cases, and head_dim 256, at the fp16
   phases' shapes (gpt_j decode and prefill, vit_large's non-causal
   prefill, the paged kernels, quantized_matmul at gpt_j's MLP width).
   streamed_matmul at gpt2_base's autotune shape (256 x 1024 @ 1024 x
   4096, fp32, TF32 off) at every tile the autotune sweep times, and at
   the reference's sweep shapes in fp32 and bf16; library
   ``torch.matmul``.  For the two matmul kernels also ``device_ms``: the
   kernels' own time per call from ``torch.profiler`` (no host time
   between calls), beside ``ms`` (CUDA events over 50 back-to-back calls,
   which read host time when the host is the slower side), and the
   kernels per call.  Every kernel's fp32 operations are bound at TF32's
   495 TFLOP/s, the fastest rate at which the card multiplies fp32
   inputs.
3. The dense path at full width: a full-size gpt2_base checkpoint (24
   layers, d=1024, fp32, random weights from a numpy seed) served through
   ``repro_torch.launch.serve.run`` — 8 requests, 128-token prompts, 32 new
   tokens, up to 4 in flight, under a budget below the model's size so
   layers stream and are destroyed.  The profile is measured anew.  The
   serving loop must launch flash_decode exactly once per layer per
   decode round and flash_attention once per layer per admitted request's
   prefill.
4. Phase 3's first 4 requests through the plain versions
   (``attn_impl=None``): the greedy tokens must equal phase 3's, unless
   the first differing step is a tie (top-2 logit gap below 1e-4).
5. The paged path: the same requests with their first 96 prompt tokens
   shared, ``page_size=16``.  The planner must pick page size 16, the
   prefix tree must hit, and the serving loop must launch
   paged_flash_decode exactly once per layer per decode round.
6. Phase 5's first 4 requests through the plain versions; tokens as in
   phase 4.
7. The chunked-prefill path: the first 4 of phase 5's requests, 16 new
   tokens, ``chunk_prefill=64``.  Chunk jobs must run, flash_attention
   must not launch, paged_flash_verify must launch exactly once per layer
   per round with a chunker, and the tokens must equal phase 5's first
   ones (or first differ at a tie).
8-9. The quant paths, int8 then int4: phase 3's checkpoint transcoded by
   the port's ``ensure_quantized`` and served as phase 3 is (``--quant
   int8`` / ``int4``) under a budget below the quantized checkpoint plus
   its KV (300 / 250 MiB), so layers still stream and are destroyed.
   quantized_matmul must launch exactly 145 times (24 layers x 6 linears
   + the head) per decode round and per prefill, the attention kernels as
   in phase 3; ``streamed_bytes`` must equal the quantized manifest bytes
   of the shards loaded; the first 4 requests through the plain versions
   must give the same tokens (tie rule); and one prompt's last-token
   logits on int8 shards must be within 5% of the fp32 checkpoint's
   (max |delta| over max |fp32 logit|, docs/quantization.md; the int4
   figure is printed without a limit).

10. Kernel autotune: phase 5's first 4 requests served with
   ``autotune=True`` (``serve --autotune``) and a fresh cache file
   (``build/chip_smoke_autotune.json``), so the sweep runs: streamed_matmul
   must launch exactly (candidate tiles) x 4 times (a warm-up and 3 timed
   calls each), the serving loop's launches must follow the tuned
   paged-decode route, a second ``Hermes.autotune`` must hit the cache
   with no launch, and the tokens must be phase 5's (tie rule).
11. gpt_j at full width (d 4096, 16 heads x 256, d_ff 16384, fp16), depth
   cut to 4 of 28 layers, 2 requests of 64 + 8 tokens under 1600 MiB
   (below its ~2.45 GB of shards), kernels then plain versions: launches
   exact, tokens equal (tie rule: top-2 gap within 2e-3 of the largest
   logit).
12. vit_large at full size (24 fp16 layers, non-causal) through
   ``PipeloadEngine.run_single`` on 2 x 197 tokens under 300 MiB, kernels
   then plain: flash_attention once per layer, logits within 2e-3 of the
   plain run's largest and the same argmax.

Every serve's ledger peak must stay within its budget, and its device
allocator peak (``torch.cuda.max_memory_allocated``) within the budget
plus, in paged mode, the page pool's bytes (freed pages keep their rows
outside the ledger).  On quantized shards the kernels must widen no
weight to fp32 on the card (every call that could is counted), and their
allocator peak must stay within the ledger peak plus 48 MiB: the planner
fills the budget with ledger bytes, and beside them sit one prefill's
activations (~6 MB) and the caching allocator's rounding (a reused block
is not split when under 1 MiB would remain: up to 1 MiB for each
resident weight tensor above 1 MiB, ~30 on the int4 path).  The plain
versions widen one weight at a time, so their limit is the budget plus
three times the largest weight's fp32 bytes.

Then one JSON line with every kernel: launches (over the whole
``serve.run`` call of the path that runs it, and inside its serving loop
as ``serve_launches``; for quantized_matmul both quant paths; for
streamed_matmul the autotune phase's sweep), fp32 error,
times and bounds at the main path's shapes (where it runs the kernel at
several, the chunk rounds' two or quantized_matmul's 16, the mean per
launch weighted by the serving loop's launches at each; streamed_matmul
at the autotune shape and the tile the sweep chose).

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
# fp16 / bf16 inputs: max abs error over the output's largest magnitude
# (kernel and plain version round one fp32 result to the storage type)
HALF_RTOL = {"float16": 2e-3, "bfloat16": 1.6e-2}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
# H100 SXM dense tensor-core peak operations per second by input type:
# fp32 at TF32's rate, the fastest at which the card multiplies fp32
# inputs (a split product on the tensor cores beats the CUDA cores' 67)
PEAK_FLOPS = {"float32": 495e12, "float16": 989e12, "bfloat16": 989e12}
BUDGET_MB = 900                  # below gpt2_base's ~1.55 GiB of shards
# below the quantized checkpoint (int8 ~391 MiB, int4 ~197 MiB) plus the
# KV of 4 in flight (120 MiB), above its decode floor (~232 / ~176 MiB)
QUANT_BUDGET_MB = {"int8": 300, "int4": 250}
QUANT_ALLOC_SLACK = 48 * 2**20   # activations + allocator rounding (above)
INT8_LOGIT_RTOL = 0.05           # docs/quantization.md
TIE_GAP = 1e-4
# fp16 checkpoints: a tie is a top-2 gap within two units in fp16's last
# place of the largest logit (kernel and plain paths round the same fp32
# sums to fp16 after summing in another order)
TIE_RTOL_HALF = 2e-3
AUTOTUNE_CACHE = ROOT / "build" / "chip_smoke_autotune.json"
# the paged phase's first 4 requests at its own shape, so the planner
# sees what it saw there and serves page size 16
AUTOTUNE = dict(requests=4, page_size=16, shared_prefix=96)
# gpt_j at full width (d 4096, 16 heads x 256, d_ff 16384, vocab 50400 ->
# 51200, fp16), depth cut to 4 of 28 layers: ~403 MB per layer, ~2.45 GB
# of shards; the budget holds the embed and head (~839 MB) and two layers
GPTJ_LAYERS = 4
GPTJ = dict(requests=2, prompt_len=64, new_tokens=8, max_inflight=2)
GPTJ_BUDGET_MB = 1600
# vit_large at full size: 24 fp16 layers of ~25 MB, non-causal, batch 2 x
# 197 tokens (196 patches + class token) through run_single, streamed
# under a budget below its ~605 MB
VIT = dict(batch=2, seq=197, budget_mb=300, agents=2)
OVER_BUDGET = []                 # runs whose device allocator passed it
WIDENED = {"cuda": 0}            # fp32 copies of quantized weights built


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


def bound(nbytes: float, flops: float, dtype: str = "float32"):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the card's peak for the inputs' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, fn, iters: int = 20):
    """(device ms per call, kernels per call, kernel names) from
    ``torch.profiler`` over ``iters`` calls: the mean duration of the CUDA
    kernel events it records, times the kernels per call (the profiler
    may drop an event; then the mean still holds); (None, None, []) when
    it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):          # a second window if the first records none
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if evs:
            break
    else:
        return None, None, []
    per_call = len(evs) / iters
    mean_ms = sum(e.time_range.elapsed_us() for e in evs) / len(evs) / 1e3
    return (mean_ms * max(1, round(per_call)), per_call,
            sorted({e.name for e in evs}))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def error(got, want):
    """(max abs error, its limit): TOL in fp32, else ``HALF_RTOL`` of the
    output's largest magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    name = dtype_name(want)
    if name == "float32":
        return err, TOL
    return err, HALF_RTOL[name] * want.float().abs().max().item()


def decode_case(torch, fd, ref, gen, name, b, s, kv, g, dh, lengths=None,
                dtype=None):
    dev = "cuda"
    dtype = dtype or torch.float32
    q = torch.randn((b, kv, g, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kv, dh), generator=gen, device=dev).to(dtype)
    lengths = lengths or [s] * b
    lens = torch.tensor(lengths, device=dev)
    valid = torch.arange(s, device=dev)[None, :] < lens[:, None]
    got = fd.flash_decode_gqa(q, k, v, valid)
    want = ref.decode_gqa_ref(q, k, v, valid)
    torch.cuda.synchronize()
    err, limit = error(got, want)
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
    nbytes = (q.element_size() * (q.numel() + 2 * n_valid * kv * dh
                                  + q.numel()) + b * s)
    flops = 4 * n_valid * kv * g * dh
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    return dict(kernel="flash_decode", case=name, max_abs_err=err,
                limit=limit, dtype=dtype_name(q), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


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
    combined = dict(kernel="flash_decode_partial", dtype="float32",
                    case="partials over two halves of S=512, combined",
                    max_abs_err=err)
    # the unnormalised partials at the dense path's decode shape, timed
    b, s, kv, g, dh = 4, 160, 16, 1, 64
    q = torch.randn((b, kv, g, dh), generator=gen, device="cuda")
    k = torch.randn((b, s, kv, dh), generator=gen, device="cuda")
    v = torch.randn((b, s, kv, dh), generator=gen, device="cuda")
    valid = torch.ones((b, s), dtype=torch.bool, device="cuda")
    run = lambda: fd.flash_decode_gqa(q, k, v, valid,  # noqa: E731
                                      normalize=False)
    plain = lambda: ref.decode_gqa_partial_ref(q, k, v, valid)  # noqa: E731
    (o1, m1, l1), (ro, rm, rl) = run(), plain()
    torch.cuda.synchronize()
    err = max((o1 / l1[..., None] - ro / rl[..., None]).abs().max().item(),
              (m1 - rm).abs().max().item())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (q.reshape(b, kv * g, 1, dh), k.transpose(1, 2),
                  v.transpose(1, 2))
    nbytes = 4 * (q.numel() + 2 * b * s * kv * dh + q.numel()
                  + 2 * b * kv * g) + b * s
    b_ms, b_by = bound(nbytes, 4 * b * s * kv * g * dh)
    timed = dict(kernel="flash_decode_partial", dtype="float32",
                 case=f"main path B={b} S={s} KV={kv} G={g} dh={dh} "
                 "unnormalised", max_abs_err=err, ms=time_ms(torch, run),
                 plain_ms=time_ms(torch, plain),
                 library_ms=time_ms(torch, lambda: sdpa(qs, ks, vs)),
                 bound_ms=b_ms, bound_by=b_by)
    return [combined, timed]


def attention_case(torch, fa, ref, gen, name, b, s, kv, g, dh, window=None,
                   sk=None, dtype=None, causal=True):
    dev = "cuda"
    sk = sk or s
    dtype = dtype or torch.float32
    q = torch.randn((b, s, kv, g, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, kv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, kv, dh), generator=gen, device=dev).to(dtype)
    run = lambda: fa.flash_attention_gqa(q, k, v, causal=causal,  # noqa: E731
                                         window=window)
    got = run()
    want = ref.attention_gqa_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err, limit = error(got, want)
    ms = time_ms(torch, run)
    plain_ms = time_ms(torch, lambda: ref.attention_gqa_ref(
        q, k, v, causal=causal, window=window))
    qs = q.reshape(b, s, kv * g, dh).transpose(1, 2)
    ks = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vs = v.transpose(1, 2).repeat_interleave(g, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q_ids = torch.arange(s, device=dev)[:, None]
    k_ids = torch.arange(sk, device=dev)[None, :]
    ok = (k_ids <= q_ids) if causal else torch.ones_like(k_ids <= q_ids)
    if window is not None:
        ok &= k_ids > q_ids - window
    if not causal and window is None:
        lib = lambda: sdpa(qs, ks, vs)  # noqa: E731
    elif window is None and sk == s:
        lib = lambda: sdpa(qs, ks, vs, is_causal=True)  # noqa: E731
    else:
        lib = lambda: sdpa(qs, ks, vs, attn_mask=ok)  # noqa: E731
    lib_ms = time_ms(torch, lib)
    pairs = int(ok.sum().item())
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * pairs * b * kv * g * dh
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    return dict(kernel="flash_attention", case=name, max_abs_err=err,
                limit=limit, dtype=dtype_name(q), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


def paged_inputs(torch, gen, b, w, kv, g, dh, page, nb, lengths, shared=0,
                 rows=None, mapped=None, dtype=None):
    """A paged pool and block tables as the scheduler builds them: each
    row maps ``mapped`` pages (by default those its length covers), the
    first ``shared`` of them one prefix mapped by every row, the others
    its own; its padded table entries are page 0 (another row's live
    page).  The pool holds ``rows`` pages, by default exactly the live
    ones (the scheduler's pool is its mapped high-water mark)."""
    dev = "cuda"
    used = [mapped or -(-n // page) for n in lengths]
    live = shared + sum(u - shared for u in used)
    rows = rows or live
    dtype = dtype or torch.float32
    kp = torch.randn((rows, page, kv, dh), generator=gen, device=dev).to(
        dtype)
    vp = torch.randn((rows, page, kv, dh), generator=gen, device=dev).to(
        dtype)
    shape = (b, kv, g, dh) if w is None else (b, w, kv, g, dh)
    q = torch.randn(shape, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(rows, generator=gen, device=dev).tolist()
    prefix, own = perm[:shared], iter(perm[shared:])
    tables = torch.zeros((b, nb), dtype=torch.int32)
    for i, u in enumerate(used):
        tables[i, :u] = torch.tensor(prefix + [next(own)
                                               for _ in range(u - shared)])
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, tables.to(dev), lens


def paged_case(torch, ref, gen, name, b, w, kv, g, dh, page, nb, lengths,
               shared=0, rows=None, mapped=None, dtype=None):
    """Paged decode (``w`` None) or verify (W = ``w``) against its plain
    version.  Library: one SDPA call on K/V already gathered to dense and
    broadcast to the q heads (the gather is not timed).  Bound: bytes of
    q, out, tables, lengths and the K/V of every distinct pool slot some
    row reads (a shared prefix page counts once), or fp32 flops of the
    unmasked (query, slot) pairs."""
    from repro_torch.kernels import paged_decode as pd
    q, kp, vp, tables, lens = paged_inputs(torch, gen, b, w, kv, g, dh,
                                           page, nb, lengths, shared, rows,
                                           mapped, dtype)
    kern = pd.paged_flash_decode if w is None else pd.paged_flash_verify
    plain = ref.paged_decode_ref if w is None else ref.paged_verify_ref
    got = kern(q, kp, vp, tables, lens)
    want = plain(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    err, limit = error(got, want)
    if w == 1:    # one stacked query is paged decode
        dec = pd.paged_flash_decode(q[:, 0].contiguous(), kp, vp, tables,
                                    lens)
        err = max(err, error(got[:, 0], dec)[0])
    ms = time_ms(torch, lambda: kern(q, kp, vp, tables, lens))
    plain_ms = time_ms(torch, lambda: plain(q, kp, vp, tables, lens))
    s_tot = nb * page
    gather = lambda p: p[tables.long()].reshape(  # noqa: E731
        b, s_tot, kv, dh).transpose(1, 2).repeat_interleave(g, dim=1)
    ks, vs = gather(kp), gather(vp)
    ww = 1 if w is None else w
    qs = q.reshape(b, ww, kv * g, dh).transpose(1, 2)
    qpos = lens[:, None] - ww + torch.arange(ww, device="cuda")[None, :]
    mask = (torch.arange(s_tot, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]                 # (B, 1, W, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(qs, ks, vs, attn_mask=mask))
    pairs = sum(n - ww + i + 1 for n in lengths for i in range(ww))
    tab = tables.tolist()
    slots = {(tab[i][s // page], s % page)
             for i, n in enumerate(lengths) for s in range(n)}
    nbytes = (q.element_size() * (2 * q.numel() + 2 * len(slots) * kv * dh)
              + 4 * (tables.numel() + b))
    b_ms, b_by = bound(nbytes, 4 * pairs * kv * g * dh, dtype_name(q))
    return dict(kernel="paged_flash_decode" if w is None
                else "paged_flash_verify", case=name, max_abs_err=err,
                limit=limit, dtype=dtype_name(q), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


def paged_cases(torch, ref, gen):
    main = dict(kv=16, g=1, dh=64, page=16, shared=6)
    return [
        # the paged phase's decode batch: 4 rows at 129..160 slots, the
        # first 6 pages (96 prompt tokens) shared, in its 22-page pool
        paged_case(torch, ref, gen, "main path B=4 KV=16 G=1 dh=64 page=16 "
                   "NB=10, 6 shared pages", 4, None, nb=10,
                   lengths=[129, 140, 150, 160], rows=22, **main),
        paged_case(torch, ref, gen, "GQA B=4 KV=4 G=8 dh=128 page=16 NB=64",
                   4, None, 4, 8, 128, 16, 64, [1024, 700, 333, 1000]),
        paged_case(torch, ref, gen, "page=1 B=3 KV=16 G=1 dh=64 NB=160",
                   3, None, 16, 1, 64, 1, 160, [1, 77, 160]),
        paged_case(torch, ref, gen, "page=5 B=3 KV=16 G=1 dh=64 NB=32",
                   3, None, 16, 1, 64, 5, 32, [3, 101, 160]),
        # the chunked phase's two chunk rounds: all 4 requests feed a
        # 64-token window at once (lengths 64, then 128) through tables of
        # 9 entries, their 8 prompt pages mapped at admission, 6 shared,
        # in its 14-page pool
        paged_case(torch, ref, gen, "main path round 1 B=4 W=64 KV=16 G=1 "
                   "dh=64 page=16 NB=9, 6 shared pages", 4, 64, nb=9,
                   lengths=[64] * 4, rows=14, mapped=8, **main),
        paged_case(torch, ref, gen, "main path round 2 B=4 W=64 KV=16 G=1 "
                   "dh=64 page=16 NB=9, 6 shared pages", 4, 64, nb=9,
                   lengths=[128] * 4, rows=14, mapped=8, **main),
        paged_case(torch, ref, gen, "B=1 W=64 KV=16 G=1 dh=64 page=16 NB=10",
                   1, 64, 16, 1, 64, 16, 10, [128]),
        paged_case(torch, ref, gen, "W=1 B=4 KV=16 G=1 dh=64 page=16 NB=10",
                   4, 1, 16, 1, 64, 16, 10, [129, 140, 150, 160]),
        paged_case(torch, ref, gen, "W=3 B=3 KV=4 G=2 dh=64 page=5 NB=32",
                   3, 3, 4, 2, 64, 5, 32, [3, 101, 160]),
    ]


def quant_shapes(cfg):
    """Every (kind, M, K, N) the quant paths give quantized_matmul, with
    its launches per decode round (kind "decode": M = the 4 in flight) or
    per prefill (kind "prefill": M = the 128-token prompt, and M = 1 for
    the head, which reads the last position only)."""
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    layer = [(d, hd), (d, kvd), (d, kvd), (hd, d), (d, cfg.d_ff),
             (cfg.d_ff, d)] + ([(d, cfg.d_ff)] if cfg.gated_mlp else [])
    per_layer = {}
    for kn in layer:
        per_layer[kn] = per_layer.get(kn, 0) + cfg.num_layers
    head = (d, cfg.padded_vocab)
    out = []
    for kind, m in (("decode", MAIN["max_inflight"]),
                    ("prefill", MAIN["prompt_len"])):
        out += [(kind, m, k, n, c) for (k, n), c in per_layer.items()]
        out.append((kind, m if kind == "decode" else 1) + head + (1,))
    return out


def linears_per_pass(cfg) -> int:
    """quantized_matmul launches per pass of the model: every linear of
    every layer, and the head's."""
    return sum(c for kind, *_, c in quant_shapes(cfg) if kind == "decode")


def quant_case(torch, ref, gen, kind, m, k, n, count, bits, dtype=None):
    """quantized_matmul at one shape against its plain version.  Library:
    ``torch.matmul`` on the weight dequantized to fp32 beforehand (not
    timed).  Bound: bytes of x, the quantized weight, the scales and the
    output, or 2 M K N fp32 flops."""
    from repro_torch.kernels import quant_matmul as qm
    dev = "cuda"
    dtype = dtype or torch.float32
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    rows = k if bits == 8 else (k + 1) // 2
    if bits == 8:
        w_q = torch.randint(-127, 128, (rows, n), generator=gen, device=dev,
                            dtype=torch.int8)
    else:
        w_q = torch.randint(0, 256, (rows, n), generator=gen, device=dev,
                            dtype=torch.uint8)
    scale = torch.rand((n,), generator=gen, device=dev) / 64
    run = lambda: qm.quant_matmul(x, w_q, scale, bits)  # noqa: E731
    plain = lambda: ref.quant_matmul_ref(x, w_q, scale,  # noqa: E731
                                         bits=bits)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err, limit = error(got, want)
    if dtype == torch.float32:      # 1e-4 of the output's scale
        limit = TOL * want.abs().max().item()
    ms = time_ms(torch, run)
    plain_ms = time_ms(torch, plain)
    dev_ms, per_call, names = device_ms(torch, run)
    w_deq = ref.dequant_ref(w_q, scale, bits=bits)[:k].to(dtype).contiguous()
    lib_ms = time_ms(torch, lambda: torch.matmul(x, w_deq))
    del w_deq
    nbytes = x.element_size() * (x.numel() + m * n) + 4 * n + w_q.numel()
    b_ms, b_by = bound(nbytes, 2 * m * k * n, dtype_name(x))
    main = "main path " if dtype == torch.float32 else ""
    return dict(kernel="quantized_matmul", bits=bits, kind=kind,
                count=count, dtype=dtype_name(x), case=f"{main}{kind} M={m} K={k} N={n} "
                f"int{bits} {dtype_name(x)}", max_abs_err=err, limit=limit,
                ms=ms, device_ms=dev_ms, kernels_per_call=per_call,
                kernel_names=names, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


def half_cases(torch, fd, fa, ref, gen):
    """fp16 / bf16 and head_dim 256, at the fp16 phases' shapes: gpt_j's
    decode (2 rows of up to 72 slots) and per-request prefill (64 tokens,
    dh 256), vit_large's non-causal prefill (2 x 197 tokens, dh 64), the
    paged kernels at dh 256 and quantized_matmul at gpt_j's MLP width."""
    cases = [
        decode_case(torch, fd, ref, gen, "dh=256 B=2 S=72 KV=16 G=1 "
                    "float32", 2, 72, 16, 1, 256, lengths=[72, 69]),
        attention_case(torch, fa, ref, gen, "dh=256 B=1 S=64 H=16 causal "
                       "float32", 1, 64, 16, 1, 256)]
    for name in HALF_RTOL:
        dt = getattr(torch, name)
        cases += [
            decode_case(torch, fd, ref, gen, f"gpt_j decode B=2 S=72 KV=16 "
                        f"G=1 dh=256 {name}", 2, 72, 16, 1, 256,
                        lengths=[72, 69], dtype=dt),
            attention_case(torch, fa, ref, gen, f"gpt_j prefill B=1 S=64 "
                           f"H=16 dh=256 causal {name}", 1, 64, 16, 1, 256,
                           dtype=dt),
            attention_case(torch, fa, ref, gen, f"vit_large B=2 S=197 H=16 "
                           f"dh=64 non-causal {name}", 2, 197, 16, 1, 64,
                           dtype=dt, causal=False),
            paged_case(torch, ref, gen, f"B=2 KV=16 G=1 dh=256 page=16 NB=5 "
                       f"{name}", 2, None, 16, 1, 256, 16, 5, [65, 72],
                       dtype=dt),
            paged_case(torch, ref, gen, f"B=2 W=64 KV=16 G=1 dh=256 page=16 "
                       f"NB=5 {name}", 2, 64, 16, 1, 256, 16, 5, [64, 72],
                       dtype=dt)]
        cases += [quant_case(torch, ref, gen, kind, m, 4096, 16384, 0, bits,
                             dt)
                  for bits in (8, 4)
                  for kind, m in (("decode", 2), ("prefill", 64))]
    return cases


def autotune_shape(cfg):
    """The shape ``tune_for_model`` times the streamed matmul at: 256
    tokens x d_model @ d_model x d_ff."""
    return 256, cfg.d_model, cfg.d_ff


def matmul_cases(torch, ref, gen, cfg):
    """streamed_matmul against matmul_ref: at gpt2_base's autotune shape
    (fp32, TF32 off) at every tile the sweep times, with its time at
    each; in bf16 at one tile of that shape; and at the reference's sweep
    shapes in fp32 and bf16.  Library:
    ``torch.matmul`` (fp32, TF32 off).  Bound: operations (2 M K N) or the
    bytes of x, w and the output."""
    from repro_torch.kernels import streamed_matmul as sm
    from repro_torch.kernels.autotune import _tile_candidates
    m, k, n = autotune_shape(cfg)
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda")
    want = ref.matmul_ref(x, w)
    plain_ms = time_ms(torch, lambda: ref.matmul_ref(x, w))
    lib_ms = time_ms(torch, lambda: torch.matmul(x, w))
    nbytes = 4 * (m * k + k * n + m * n)
    b_ms, b_by = bound(nbytes, 2 * m * k * n)
    cases = []
    for tile in _tile_candidates(m, k, n, None):
        run = lambda t=tile: sm.streamed_matmul(  # noqa: E731
            x, w, block_m=t[0], block_n=t[1], block_k=t[2])
        got = run()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        dev_ms, per_call, names = device_ms(torch, run)
        cases.append(dict(
            kernel="streamed_matmul", tile=list(tile), dtype="float32",
            case=f"autotune M={m} K={k} N={n} float32 tile "
            f"{tile[0]}x{tile[1]}x{tile[2]}", max_abs_err=err,
            limit=TOL * want.abs().max().item(), ms=time_ms(torch, run),
            device_ms=dev_ms, kernels_per_call=per_call,
            kernel_names=names, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by))
    # one bf16 pass of the same body at the autotune shape, timed
    xh, wh = x.to(torch.bfloat16), w.to(torch.bfloat16)
    run = lambda: sm.streamed_matmul(xh, wh, block_m=64,  # noqa: E731
                                     block_n=64, block_k=512)
    got, want_h = run(), ref.matmul_ref(xh, wh)
    torch.cuda.synchronize()
    dev_ms, per_call, names = device_ms(torch, run)
    b_h = bound(2 * (m * k + k * n + m * n), 2 * m * k * n, "bfloat16")
    cases.append(dict(
        kernel="streamed_matmul", dtype="bfloat16",
        case=f"M={m} K={k} N={n} bfloat16 tile 64x64x512",
        max_abs_err=(got.float() - want_h.float()).abs().max().item(),
        limit=HALF_RTOL["bfloat16"] * want_h.float().abs().max().item(),
        ms=time_ms(torch, run), device_ms=dev_ms, kernels_per_call=per_call,
        kernel_names=names, plain_ms=time_ms(torch, lambda: ref.matmul_ref(
            xh, wh)), library_ms=time_ms(torch, lambda: torch.matmul(xh, wh)),
        bound_ms=b_h[0], bound_by=b_h[1]))
    for name in ("float32", "bfloat16"):
        for m, k, n, bm, bn, bk in ((128, 128, 128, 128, 128, 128),
                                    (256, 512, 128, 128, 128, 128),
                                    (384, 256, 512, 128, 256, 256)):
            dt = getattr(torch, name)
            x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            w = torch.randn((k, n), generator=gen, device="cuda").to(dt)
            got = sm.streamed_matmul(x, w, block_m=bm, block_n=bn,
                                     block_k=bk)
            want = ref.matmul_ref(x, w)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            cases.append(dict(
                kernel="streamed_matmul", dtype=name, max_abs_err=err,
                limit=(TOL if name == "float32" else HALF_RTOL[name]) * scale,
                case=f"sweep M={m} K={k} N={n} tile {bm}x{bn}x{bk} {name}"))
    return cases


def phase_kernels(torch):
    from repro_torch.configs import get
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
        *partial_case(torch, fd, ref, gen),
        # the scheduler prefills each admitted request on its own
        attention_case(torch, fa, ref, gen, "main path B=1 S=128 H=16 "
                       "dh=64 causal", 1, 128, 16, 1, 64),
        attention_case(torch, fa, ref, gen, "B=4 S=128 H=16 dh=64 causal",
                       4, 128, 16, 1, 64),
        attention_case(torch, fa, ref, gen, "Sq=77 B=2 KV=4 G=2 dh=64 "
                       "causal", 2, 77, 4, 2, 64),
        attention_case(torch, fa, ref, gen, "Sq=77 B=2 KV=4 G=2 dh=64 "
                       "window=32", 2, 77, 4, 2, 64, window=32),
        # rows 81..99 see no key: they get the mean of V, as in the
        # reference
        attention_case(torch, fa, ref, gen, "Sq=100 Sk=50 H=16 dh=64 "
                       "window=32 (fully masked rows)", 1, 100, 16, 1, 64,
                       window=32, sk=50),
    ] + paged_cases(torch, ref, gen)
    cases += [quant_case(torch, ref, gen, *shape, bits)
              for bits in (8, 4) for shape in quant_shapes(get("gpt2_base"))]
    cases += half_cases(torch, fd, fa, ref, gen)
    cases += matmul_cases(torch, ref, gen, get("gpt2_base"))
    for c in cases:
        line = (f"  {c['kernel']:<18} {c['case']:<44} max_abs_err "
                f"{c['max_abs_err']:.3e} (tol {c.get('limit', TOL):.3g})")
        if "ms" in c:
            line += (f"  kernel_ms {c['ms']:.5f} plain_ms "
                     f"{c['plain_ms']:.5f} library_ms {c['library_ms']:.5f}"
                     f" bound_ms {c['bound_ms']:.5f} ({c['bound_by']})")
        if "device_ms" in c:
            dev = ("not measured" if c["device_ms"] is None
                   else f"{c['device_ms']:.5f}")
            line += (f" device_ms {dev} kernels/call "
                     f"{c['kernels_per_call']} {c['kernel_names']}")
        print(line, flush=True)
    bad = [c for c in cases if not c["max_abs_err"] <= c.get("limit", TOL)]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    return cases


# ---------------------------------------------------------------------------
# phases 3-7: the main paths
# ---------------------------------------------------------------------------
MAIN = dict(requests=8, prompt_len=128, new_tokens=32, max_inflight=4)
# the paged phases: 96 of the 128 prompt tokens shared (6 pages of 16)
PAGED = dict(page_size=16, shared_prefix=96)
CHUNKED = dict(PAGED, requests=4, new_tokens=16, chunk_prefill=64)


def serve(attn_impl, budget_mb, arch="gpt2_base", **kw):
    from repro_torch.launch import serve as serve_mod
    args = dict(MAIN, **kw)
    return serve_mod.run(arch, budget_mb=budget_mb, reduced=False,
                         device="cuda", ckpt_root=CKPT_ROOT,
                         attn_impl=attn_impl, **args)


def check_outputs(outs, vocab: int, requests: int, total: int) -> None:
    import numpy as np
    if len(outs) != requests:
        fail(f"{len(outs)} requests finished, expected {requests}")
    for rid, toks in outs.items():
        toks = np.asarray(toks)
        if toks.shape != (total,):
            fail(f"req{rid}: token shape {toks.shape}")
        if toks.min() < 0 or toks.max() >= vocab:
            fail(f"req{rid}: token ids outside [0, {vocab})")


def ckpt_dir(cfg, quant: str = "fp32") -> Path:
    """The checkpoint a path serves: phase 3's, or its ``quant`` sibling
    (``Hermes.quantized``)."""
    return CKPT_ROOT / (cfg.name if quant == "fp32"
                        else f"{cfg.name}-{quant}")


def tie_gap(torch, cfg, prefix, quant: str = "fp32"):
    """(top-2 logit gap, the gap below which it is a tie) of the plain
    path's next-token logits after ``prefix`` (a full re-prefill of the
    prefix): TIE_GAP, or on an fp16 checkpoint TIE_RTOL_HALF of the
    largest |logit|."""
    from repro_torch.core import PipeloadEngine
    with PipeloadEngine(ckpt_dir(cfg, quant), cfg, mode="pipeload",
                        num_agents=4,
                        attn_impl=None) as eng:
        logits, _ = eng.run_single([list(map(int, prefix))])
    top2 = torch.topk(logits[0].float(), 2).values
    limit = (TIE_GAP if cfg.dtype == "float32"
             else TIE_RTOL_HALF * logits[0].float().abs().max().item())
    return float(top2[0] - top2[1]), limit


def same_tokens(torch, cfg, outs, other, what: str, n: int = 0,
                quant: str = "fp32") -> str:
    """Fail unless every request that both runs served has the same tokens
    (the first ``n``, or all), or tokens that first differ at a tie (top-2
    gap below TIE_GAP on the ``quant`` checkpoint)."""
    ties = 0
    for rid in sorted(set(outs) & set(other)):
        toks = list(outs[rid][:n or len(outs[rid])])
        ref_toks = list(other[rid][:len(toks)])
        diff = [i for i in range(len(toks)) if toks[i] != ref_toks[i]]
        if diff:
            gap, limit = tie_gap(torch, cfg, toks[:diff[0]], quant)
            print(f"{what}: req{rid} tokens differ first at {diff[0]}; "
                  f"plain top-2 logit gap there {gap:.3e} (tie below "
                  f"{limit:.3e})", flush=True)
            if gap >= limit:
                fail(f"{what}: req{rid} greedy tokens differ at step "
                     f"{diff[0]} (gap {gap:.3e})")
            ties += 1
    verdict = "differ only at ties" if ties else "identical"
    print(f"{what}: {verdict}", flush=True)
    return verdict


def serve_rounds(stats, n_chunks: int = 0):
    """(decode rounds, chunk rounds, monolithic prefills) of a serving
    loop, from its policy log: a request admitted at round a chunks in
    rounds a..a+n_chunks-1, then decodes; a monolithic one decodes from
    a+1; a preempted one stops decoding at its preemption round and a
    retired one after its retirement round."""
    decode_rounds, chunk_rounds, prefills, start = set(), set(), 0, {}
    for kind, rid, r, _ in stats.policy:
        if kind == "admit":
            if n_chunks:
                chunk_rounds.update(range(r, r + n_chunks))
                start[rid] = r + n_chunks
            else:
                prefills += 1
                start[rid] = r + 1
        elif kind == "preempt":
            if n_chunks:
                fail("the chunked phase preempted a request; its launch "
                     "count is not derived for re-admitted chunkers")
            decode_rounds.update(range(start.pop(rid), r))
        elif kind == "retire":
            decode_rounds.update(range(start.pop(rid), r + 1))
    return decode_rounds, chunk_rounds, prefills


def expected_serve_launches(stats, cfg, n_chunks: int = 0,
                            quant: str = "fp32") -> dict:
    """Launches the serving loop must make: one decode launch
    (flash_decode, or paged_flash_decode in paged mode unless autotune
    chose the "gather" route) per layer per
    round with a decoder in flight; one flash_attention per layer per
    monolithic prefill; with chunked prefill, one paged_flash_verify per
    layer per round with a chunker; on quantized shards, one
    quantized_matmul per linear per pass (decode round, chunk round or
    prefill), the head's included."""
    from repro_torch.kernels import ops
    decode_rounds, chunk_rounds, prefills = serve_rounds(stats, n_chunks)
    n_layers = cfg.num_layers
    want = dict.fromkeys(stats.kernel_launches, 0)
    # autotune's "gather" route decodes paged KV through flash_decode
    paged = stats.page_size and ops.tuned_paged_impl() != "gather"
    want["paged_flash_decode" if paged else "flash_decode"] = (
        n_layers * len(decode_rounds))
    want["flash_attention"] = n_layers * prefills
    want["paged_flash_verify"] = n_layers * len(chunk_rounds)
    if quant != "fp32":
        want["quantized_matmul"] = linears_per_pass(cfg) * (
            len(decode_rounds) + len(chunk_rounds) + prefills)
    return want


def time_split(stats, cfg, quant: str = "fp32") -> str:
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
    prof = json.loads((ckpt_dir(cfg, quant) /
                       "profile_torch_cuda.json").read_text())
    return (f"time split: wall {stats.latency_s:.3f}s over {stats.rounds} "
            f"rounds; shard loads {load:.3f}s summed over agents; layer "
            f"compute {comp:.3f}s; profile per layer t_load "
            f"{prof['layer_t_load'] * 1e3:.3f}ms t_comp "
            f"{prof['layer_t_comp'] * 1e3:.3f}ms t_decode "
            f"{prof['layer_t_decode'] * 1e3:.3f}ms")


def watch_widening() -> None:
    """Count every call that widens a quantized weight to fp32 on the card
    (the plain versions' ``ref.dequant_ref`` and
    ``QuantizedTensor.dequantize``) in ``WIDENED``: the kernels' path
    must make none."""
    from repro_torch.checkpoint.quant import QuantizedTensor
    from repro_torch.kernels import ref
    dequant_ref, dequantize = ref.dequant_ref, QuantizedTensor.dequantize

    def counted_dequant_ref(w_q, scale, **kw):
        WIDENED["cuda"] += w_q.is_cuda
        return dequant_ref(w_q, scale, **kw)

    def counted_dequantize(self):
        WIDENED["cuda"] += self.q.is_cuda
        return dequantize(self)

    ref.dequant_ref = counted_dequant_ref
    QuantizedTensor.dequantize = counted_dequantize


def largest_weight_fp32_bytes(cfg) -> int:
    return 4 * max(k * n for *_, k, n, _c in quant_shapes(cfg))


def run_path(torch, ops, cfg, label: str, attn_impl, n_chunks=0,
             quant: str = "fp32", budget_mb: float = BUDGET_MB, **kw):
    """Serve one main path with every launch count set to 0 just before
    and read just after; check the serving loop's launches exactly and
    the outputs' shape.  Returns (outs, stats, serve.run launches)."""
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    widened0 = WIDENED["cuda"]
    t0 = time.perf_counter()
    outs, stats = serve(attn_impl, budget_mb, quant=quant, **kw)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    widened = WIDENED["cuda"] - widened0
    if quant != "fp32":
        print(f"{label}: quantized weights widened to fp32 on the card: "
              f"{widened} times", flush=True)
        if (widened > 0) != (attn_impl is None):
            fail(f"{label}: {widened} fp32 widenings of quantized weights "
                 f"(the kernels must make none, the plain versions some)")
    alloc_peak = torch.cuda.max_memory_allocated()
    args = dict(MAIN, **kw)
    check_outputs(outs, cfg.padded_vocab, args["requests"],
                  args["prompt_len"] + args["new_tokens"])
    budget = int(budget_mb * 2**20)
    if stats.peak_bytes > budget:
        fail(f"{label}: ledger peak {stats.peak_bytes} above the budget")
    # the paged pools hold the mapped high-water mark of rows while the
    # ledger charges mapped pages only: rows on the free list (a retired
    # wave's) are device memory outside it, at most the pool's own bytes
    limit = budget + (stats.cache_bytes_peak if stats.page_size else 0)
    what = "the budget" + (" plus the paged pool's bytes"
                           if stats.page_size else "")
    if quant != "fp32" and attn_impl is None:
        limit += 3 * largest_weight_fp32_bytes(cfg)
        what += " plus 3x the largest weight's fp32 bytes (plain versions)"
    elif quant != "fp32":
        # the planner fills the budget with ledger bytes; beside them sit
        # a prefill's activations and the caching allocator's rounding
        limit = stats.peak_bytes + QUANT_ALLOC_SLACK
        what = "the ledger peak plus 48 MiB"
    if alloc_peak > limit:
        # checked at the end, so the later paths still report
        how = "plain" if attn_impl is None else "kernels"
        OVER_BUDGET.append(f"{label} ({how}): torch.cuda.max_memory_"
                           f"allocated {alloc_peak} above {limit} "
                           f"({what})")
    if attn_impl is None:
        if any(launches.values()):
            fail(f"{label}: attn_impl=None launched kernels: {launches}")
        print(f"{label}: plain versions, rounds {stats.rounds}, "
              f"{stats.tokens_per_s:.3f} tok/s, ledger peak "
              f"{stats.peak_bytes}, torch.cuda.max_memory_allocated "
              f"{alloc_peak} (limit {limit}), serve.run {wall:.1f}s",
              flush=True)
        return outs, stats, launches
    want = expected_serve_launches(stats, cfg, n_chunks, quant)
    print(f"{label}: kernel launches: serve.run {json.dumps(launches)} "
          f"(profiling and warm-up included); serving loop "
          f"{json.dumps(stats.kernel_launches)}, expected "
          f"{json.dumps(want)}", flush=True)
    if stats.kernel_launches != want:
        fail(f"{label}: serving-loop launches {stats.kernel_launches} != "
             f"{want}")
    print(f"{label}: rounds {stats.rounds}, {stats.tokens_per_s:.3f} tok/s "
          f"aggregate, ledger peak {stats.peak_bytes} bytes (budget "
          f"{budget}), breakdown {json.dumps(stats.peak_breakdown)}, "
          f"torch.cuda.max_memory_allocated {alloc_peak} (limit {limit}: "
          f"{what}), shard loads {stats.loads}, streamed "
          f"{stats.streamed_bytes} B, serve.run {wall:.1f}s", flush=True)
    print(f"{label}: {time_split(stats, cfg, quant)}", flush=True)
    return outs, stats, launches


def phase_main(torch, ops):
    """Phases 3-4: the dense path, kernels then plain versions."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import ensure_checkpoint
    cfg = get("gpt2_base")
    t0 = time.perf_counter()
    ensure_checkpoint(cfg, root=CKPT_ROOT)
    print(f"checkpoint: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"written in {time.perf_counter() - t0:.1f}s", flush=True)
    # profile anew on every run, so the schedule and the launch counts do
    # not depend on an earlier run; the later phases reuse it
    (CKPT_ROOT / cfg.name / "profile_torch_cuda.json").unlink(missing_ok=True)
    outs, stats, launches = run_path(torch, ops, cfg, "dense", "auto")
    if not (launches["flash_decode"] and launches["flash_attention"]):
        fail(f"a kernel of the dense path never launched: {launches}")
    if launches["quantized_matmul"]:
        fail(f"fp32 shards launched quantized_matmul: {launches}")
    # the first wave only: the script's time limit is shared by every path
    outs_plain, _, _ = run_path(torch, ops, cfg, "dense", None,
                                requests=MAIN["max_inflight"])
    same_tokens(torch, cfg, outs, outs_plain, "dense kernel vs plain "
                "greedy tokens")
    return cfg, launches, stats


def phase_paged(torch, ops, cfg, dense_stats):
    """Phases 5-6: paged KV with prefix sharing, kernels then plain."""
    outs, stats, launches = run_path(torch, ops, cfg, "paged", "auto",
                                     **PAGED)
    if stats.page_size != PAGED["page_size"]:
        fail(f"paged: the planner served page size {stats.page_size} at "
             f"{BUDGET_MB} MiB, not {PAGED['page_size']}")
    if stats.prefix_hit_pages <= 0:
        fail("paged: no prefix hit on a shared prompt")
    if not launches["paged_flash_decode"]:
        fail(f"paged: paged_flash_decode never launched: {launches}")
    print(f"paged: page size {stats.page_size}, pages allocated "
          f"{stats.pages_allocated} ({stats.page_reuses} reused), prefix "
          f"hit pages {stats.prefix_hit_pages}, cow copies "
          f"{stats.cow_copies}, preemptions {stats.preemptions}, pool peak "
          f"{stats.pool_pages_peak} pages; kv_pages at the ledger peak "
          f"{stats.peak_breakdown.get('kv_pages', 0)} B (dense phase "
          f"{dense_stats.peak_breakdown.get('kv_pages', 0)} B)", flush=True)
    # the first wave only, as in the dense phase
    outs_plain, _, _ = run_path(torch, ops, cfg, "paged", None,
                                **dict(PAGED, requests=MAIN["max_inflight"]))
    same_tokens(torch, cfg, outs, outs_plain, "paged kernel vs plain "
                "greedy tokens")
    return outs, launches, stats


def phase_chunked(torch, ops, cfg, paged_outs):
    """Phase 7: chunked prefill through the paged verify kernel, against
    the paged phase's first tokens for the same prompts."""
    n_chunks = -(-MAIN["prompt_len"] // CHUNKED["chunk_prefill"])
    outs, stats, launches = run_path(torch, ops, cfg, "chunked", "auto",
                                     n_chunks=n_chunks, **CHUNKED)
    if stats.chunk_jobs <= 0 or stats.page_size != CHUNKED["page_size"]:
        fail(f"chunked: no chunk job ran (chunk_jobs {stats.chunk_jobs}, "
             f"page size {stats.page_size})")
    if not launches["paged_flash_verify"]:
        fail(f"chunked: paged_flash_verify never launched: {launches}")
    print(f"chunked: {stats.chunk_jobs} chunk jobs of "
          f"{stats.chunk_size} tokens", flush=True)
    n = MAIN["prompt_len"]
    for rid, toks in outs.items():
        if list(toks[:n]) != list(paged_outs[rid][:n]):
            fail(f"chunked: req{rid}'s prompt is not the paged phase's")
    same_tokens(torch, cfg, outs, paged_outs, "chunked vs paged greedy "
                "tokens", n=n + CHUNKED["new_tokens"])
    return launches, stats


def last_logits(torch, cfg, quant: str, prompt):
    """One prompt's last-token logits through the kernels."""
    from repro_torch.core import PipeloadEngine
    with PipeloadEngine(ckpt_dir(cfg, quant), cfg, mode="pipeload",
                        num_agents=4) as eng:
        logits, _ = eng.run_single([prompt])
    return logits[0]


def phase_quant(torch, ops, cfg, quant: str, fp32_logits, prompt):
    """Phases 8-9: the dense path on ``quant`` shards, kernels then plain,
    and the logit error against the fp32 checkpoint."""
    from repro_torch.checkpoint import load_manifest
    budget_mb = QUANT_BUDGET_MB[quant]
    budget = int(budget_mb * 2**20)
    outs, stats, launches = run_path(torch, ops, cfg, quant, "auto",
                                     quant=quant, budget_mb=budget_mb)
    man = load_manifest(ckpt_dir(cfg, quant))
    sizes = {s["name"]: s["bytes"] for s in man["shards"]}
    kv = MAIN["max_inflight"] * cfg.num_layers * cfg.cache_bytes(
        1, MAIN["prompt_len"] + MAIN["new_tokens"])
    print(f"{quant}: manifest total {man['total_bytes']} B (layers "
          f"{man['layer_bytes']}, per layer "
          f"{man['layer_bytes'] // cfg.num_layers}), fp32 "
          f"{sum(s['fp_bytes'] for s in man['shards'])} B; KV for "
          f"{MAIN['max_inflight']} in flight {kv} B; budget {budget} B",
          flush=True)
    if man["quant"] != quant or budget >= man["total_bytes"] + kv:
        fail(f"{quant}: the budget must sit below the {quant} checkpoint "
             f"plus its KV, so layers stream")
    if stats.loads <= len(sizes):
        fail(f"{quant}: {stats.loads} shard loads: layers did not stream")
    loaded = sum(sizes[key] for _, kind, key in stats.events
                 if kind == "load_end")
    if stats.streamed_bytes != loaded:
        fail(f"{quant}: streamed_bytes {stats.streamed_bytes} != the "
             f"{quant} manifest bytes of the loads {loaded}")
    if not launches["quantized_matmul"]:
        fail(f"{quant}: quantized_matmul never launched: {launches}")
    outs_plain, _, _ = run_path(torch, ops, cfg, quant, None, quant=quant,
                                budget_mb=budget_mb,
                                requests=MAIN["max_inflight"])
    same_tokens(torch, cfg, outs, outs_plain, f"{quant} kernel vs plain "
                "greedy tokens", quant=quant)
    logits = last_logits(torch, cfg, quant, prompt)
    rel = ((logits - fp32_logits).abs().max()
           / fp32_logits.abs().max()).item()
    if quant == "int8":
        print(f"{quant}: last-token logits vs fp32: max |delta| / max "
              f"|fp32| = {rel:.5f} (limit {INT8_LOGIT_RTOL})", flush=True)
        if not rel <= INT8_LOGIT_RTOL:
            fail(f"{quant}: logit error {rel} above {INT8_LOGIT_RTOL}")
    else:
        print(f"{quant}: last-token logits vs fp32: max |delta| / max "
              f"|fp32| = {rel:.5f} (no limit)", flush=True)
    return launches, stats


def quant_row(cases, quant_runs):
    """quantized_matmul's numbers for the kernels line: the mean per
    launch over the quant paths' serving loops, each shape weighted by
    its launches there (per decode round or per prefill, times their
    count in that path)."""
    weights = {}
    for bits, stats in quant_runs.items():
        decode_rounds, _, prefills = serve_rounds(stats)
        weights[bits] = {"decode": len(decode_rounds), "prefill": prefills}
    mains = [c for c in cases if c["kernel"] == "quantized_matmul"
             and c["case"].startswith("main")]
    w = [c["count"] * weights[c["bits"]][c["kind"]] for c in mains]
    mean = lambda key: (sum(wi * c[key] for wi, c in zip(w, mains))  # noqa
                        / sum(w))
    row = {k: mean(k) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    row["device_ms"] = (None if any(c["device_ms"] is None for c in mains)
                        else mean("device_ms"))
    row["bound_by"] = max(zip(w, mains),
                          key=lambda p: p[0] * p[1]["bound_ms"])[1][
                              "bound_by"]
    row["max_abs_err"] = max(c["max_abs_err"] for c in mains)
    return row


def phase_autotune(torch, ops, cfg, paged_outs):
    """Phase 10: ``serve --autotune`` at page size 16 on phase 3's
    checkpoint, with a fresh cache file so the sweep runs: the streamed
    matmul launches exactly once per candidate tile per timed call
    (``_median_time``'s warm-up and its 3 repeats); a second
    ``Hermes.autotune`` hits the cache and launches nothing; the tokens
    are the paged phase's for the same requests (tie rule)."""
    import os
    from repro_torch.core import Hermes
    from repro_torch.kernels import autotune
    AUTOTUNE_CACHE.unlink(missing_ok=True)
    os.environ[autotune.CACHE_ENV] = str(AUTOTUNE_CACHE)
    outs, stats, launches = run_path(torch, ops, cfg, "autotune", "auto",
                                     autotune=True, **AUTOTUNE)
    if stats.page_size != AUTOTUNE["page_size"]:
        fail(f"autotune: the planner served page size {stats.page_size}")
    from repro_torch.kernels.streamed_matmul import cta_tile
    impl = ops.tuned_paged_impl()
    m, k, n = autotune_shape(cfg)
    cands = autotune._tile_candidates(m, k, n, None)
    if len({cta_tile(*t) for t in cands}) != len(cands):
        fail("autotune: two candidate tiles select one launch")
    sweep = len(cands) * (3 + 1)
    entries = json.loads(AUTOTUNE_CACHE.read_text())["entries"]
    arch = autotune.device_arch("cuda")
    mat = entries[f"matmul|{arch}|float32|page=-"]
    paged = entries.get(f"paged_decode|{arch}|float32|page="
                        f"{AUTOTUNE['page_size']}")
    if mat["shape"] != [m, k, n] or paged is None:
        fail(f"autotune: the cache lacks the expected entries: {entries}")
    launch = cta_tile(mat["block_m"], mat["block_n"], mat["block_k"])
    print(f"autotune: {AUTOTUNE_CACHE.name} -> matmul tiles "
          f"{mat['block_m']}x{mat['block_n']}x{mat['block_k']} (blocks of "
          f"{launch[0]}x{launch[1]} outputs in {launch[2]}x{launch[3]} "
          f"tiles, {2 * launch[4]}-row K stages; {len(cands)} distinct "
          f"launches timed; {mat['t_us']:.1f} us at {mat['shape']}), paged "
          f"route "
          f"{paged['impl']} ({paged['t_us']:.1f} us, the other "
          f"{paged['t_us_other']:.1f} us); streamed_matmul launches in the "
          f"sweep {launches['streamed_matmul']} (expected {sweep})",
          flush=True)
    if launches["streamed_matmul"] != sweep:
        fail(f"autotune: {launches['streamed_matmul']} streamed_matmul "
             f"launches, expected {sweep}")
    if impl != paged["impl"]:
        fail(f"autotune: the tuned route {impl} is not the cache's")
    ops.reset_launches()
    again = Hermes(ckpt_dir(cfg), cfg, device="cuda").autotune(
        page_size=AUTOTUNE["page_size"])
    if ops.LAUNCHES["streamed_matmul"] or again["matmul"] != mat:
        fail(f"autotune: the second call did not hit the cache "
             f"({ops.LAUNCHES['streamed_matmul']} streamed_matmul "
             f"launches)")
    print("autotune: second Hermes.autotune hit the cache, 0 "
          "streamed_matmul launches", flush=True)
    same_tokens(torch, cfg, outs, paged_outs, "autotune vs paged greedy "
                "tokens")
    ops.set_tuned()
    return launches, stats, mat


def phase_gptj(torch, ops):
    """Phase 11: gpt_j at full width, fp16, head_dim 256, depth cut to
    GPTJ_LAYERS, served under a budget below its shards (kernels, then
    the plain versions; tokens by the tie rule)."""
    from repro_torch.checkpoint import load_manifest
    from repro_torch.configs import get
    from repro_torch.launch.serve import ensure_checkpoint
    cfg = get("gpt_j").with_(num_layers=GPTJ_LAYERS,
                             name=f"gpt-j-{GPTJ_LAYERS}layers")
    t0 = time.perf_counter()
    path = ensure_checkpoint(cfg, root=CKPT_ROOT)
    man = load_manifest(path)
    print(f"gpt_j: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.head_dim} heads, d_ff {cfg.d_ff}, "
          f"{cfg.dtype}; {man['total_bytes']} B of shards (layers "
          f"{man['layer_bytes']}), written in "
          f"{time.perf_counter() - t0:.1f}s; budget {GPTJ_BUDGET_MB} MiB",
          flush=True)
    if GPTJ_BUDGET_MB * 2**20 >= man["total_bytes"]:
        fail("gpt_j: the budget must sit below the checkpoint")
    (path / "profile_torch_cuda.json").unlink(missing_ok=True)
    kw = dict(GPTJ, arch=cfg, budget_mb=GPTJ_BUDGET_MB)
    outs, stats, launches = run_path(torch, ops, cfg, "gpt_j", "auto", **kw)
    if not (launches["flash_decode"] and launches["flash_attention"]):
        fail(f"gpt_j: a kernel never launched: {launches}")
    if stats.loads <= len(man["shards"]):
        fail(f"gpt_j: {stats.loads} shard loads: layers did not stream")
    outs_plain, _, _ = run_path(torch, ops, cfg, "gpt_j", None, **kw)
    same_tokens(torch, cfg, outs, outs_plain, "gpt_j kernel vs plain "
                "greedy tokens")
    return launches, stats


def phase_vit(torch, ops):
    """Phase 12: vit_large at full size (24 fp16 layers, non-causal)
    through ``PipeloadEngine.run_single``, kernels then plain versions:
    flash_attention once per layer, logits within HALF_RTOL["float16"] of
    the plain run's largest and the same argmax."""
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.core import PipeloadEngine
    from repro_torch.launch.serve import ensure_checkpoint
    cfg = get("vit_large")
    t0 = time.perf_counter()
    path = ensure_checkpoint(cfg, root=CKPT_ROOT)
    print(f"vit_large: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.dtype}, causal={cfg.causal}, written in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (VIT["batch"], VIT["seq"]))
    budget = VIT["budget_mb"] * 2**20
    runs = {}
    for impl in ("auto", None):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with PipeloadEngine(path, cfg, mode="pipeload",
                            num_agents=VIT["agents"], budget_bytes=budget,
                            attn_impl=impl) as eng:
            t0 = time.perf_counter()
            logits, st = eng.run_single(tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        alloc = torch.cuda.max_memory_allocated()
        how = "kernels" if impl else "plain"
        print(f"vit_large ({how}): run_single {wall:.3f}s, ledger peak "
              f"{st.peak_bytes} (budget {budget}), shard loads {st.loads}, "
              f"torch.cuda.max_memory_allocated {alloc}, launches "
              f"{json.dumps(launches)}", flush=True)
        want = dict.fromkeys(launches, 0)
        if impl:
            want["flash_attention"] = cfg.num_layers
        if launches != want:
            fail(f"vit_large ({how}): launches {launches} != {want}")
        if st.peak_bytes > budget or alloc > budget:
            fail(f"vit_large ({how}): peak above the budget")
        if st.loads < cfg.num_layers:
            fail(f"vit_large ({how}): {st.loads} shard loads")
        runs[how] = logits.float(), launches
    got, want = runs["kernels"][0], runs["plain"][0]
    if got.shape != (VIT["batch"], cfg.padded_vocab) or not bool(
            torch.isfinite(got).all()):
        fail(f"vit_large: logits {tuple(got.shape)} not finite or not "
             f"(batch, vocab)")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    print(f"vit_large: kernel vs plain logits max |delta| / max |plain| = "
          f"{rel:.3e} (limit {HALF_RTOL['float16']}), argmax equal "
          f"{same}", flush=True)
    if not (rel <= HALF_RTOL["float16"] and same):
        fail("vit_large: kernel logits disagree with the plain run's")
    return runs["kernels"][1]


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
    t_start = time.perf_counter()
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
    for k in build.KERNELS:
        print(f"  ptxas -v: {build.ptxas_summary(k)}", flush=True)
    for k in ("quant_matmul", "streamed_matmul"):
        counts = build.sass_counts(k, ("HMMA", "HGMMA", "FFMA"))
        print(f"  sass: lib{k}: {json.dumps(counts)}", flush=True)
        if not counts["HMMA"] + counts["HGMMA"]:
            fail(f"lib{k} holds no tensor-core instruction (HMMA or HGMMA "
                 f"in cuobjdump -sass): its matmul is not on the tensor "
                 f"cores")

    # ---- phase 2: kernels against their plain versions
    cases = phase_kernels(torch)

    # ---- phases 3-7: the dense, paged and chunked paths; each path's
    # launch counts are set to 0 just before it and read just after
    cfg, dense_launches, dense_stats = phase_main(torch, ops)
    paged_outs, paged_launches, paged_stats = phase_paged(torch, ops, cfg,
                                                          dense_stats)
    chunk_launches, chunk_stats = phase_chunked(torch, ops, cfg, paged_outs)

    # ---- phases 8-9: the quant paths
    import numpy as np
    watch_widening()
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, MAIN["prompt_len"]).tolist()
    fp32_logits = last_logits(torch, cfg, "fp32", prompt)
    quant_launches, quant_stats = {}, {}
    for quant in ("int8", "int4"):
        bits = 8 if quant == "int8" else 4
        quant_launches[bits], quant_stats[bits] = phase_quant(
            torch, ops, cfg, quant, fp32_logits, prompt)

    # ---- phase 10: kernel autotune; 11-12: the fp16 models
    tune_launches, tune_stats, tuned = phase_autotune(torch, ops, cfg,
                                                      paged_outs)
    phase_gptj(torch, ops)
    phase_vit(torch, ops)

    # ---- the kernels line: each kernel's launches from the path it serves
    csrc = "src/repro_torch/kernels/csrc/"
    # name: (source, TPU kernel, launch key, the path's launches, stats);
    # flash_decode_partial and flash_decode are one CUDA kernel (the
    # partials unnormalised), one launch key
    meta = {
        "flash_decode_partial": (csrc + "flash_decode.cu",
                                 "src/repro/kernels/flash_decode.py:57",
                                 dense_launches, dense_stats),
        "flash_decode": (csrc + "flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:98",
                         dense_launches, dense_stats),
        "flash_attention": (csrc + "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:62",
                            dense_launches, dense_stats),
        "paged_flash_decode": (csrc + "paged_decode.cu",
                               "src/repro/kernels/paged_decode.py:163",
                               paged_launches, paged_stats),
        "paged_flash_verify": (csrc + "paged_decode.cu",
                               "src/repro/kernels/paged_decode.py:113",
                               chunk_launches, chunk_stats),
    }
    if OVER_BUDGET:
        fail("device allocator peak above its limit: "
             + "; ".join(OVER_BUDGET))
    kernels = []
    for kname, (source, replaces, launches, stats) in meta.items():
        key = "flash_decode" if kname == "flash_decode_partial" else kname
        mine = [c for c in cases if c["kernel"] == kname
                and c["dtype"] == "float32"]
        # the main path's shapes; where it launches the kernel at several
        # (the chunk rounds), each takes an equal share of its launches,
        # so the numbers are their mean per launch
        mains = [c for c in mine if c["case"].startswith("main")]
        mean = lambda f: sum(c[f] for c in mains) / len(mains)  # noqa
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launch_key": key,
            "launches": launches[key],
            "serve_launches": stats.kernel_launches[key],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": max(mains, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": mean("library_ms")})
    # quantized_matmul: launches from both quant paths
    kernels.append(dict(
        name="quantized_matmul", route="cuda",
        source=csrc + "quant_matmul.cu",
        replaces="src/repro/kernels/streamed_matmul.py:101",
        launches=sum(ln["quantized_matmul"]
                     for ln in quant_launches.values()),
        serve_launches=sum(st.kernel_launches["quantized_matmul"]
                           for st in quant_stats.values()),
        **quant_row(cases, quant_stats)))
    # streamed_matmul: the autotune sweep's launches; its time at the tile
    # the sweep chose, at the shape it tuned
    tile = [tuned["block_m"], tuned["block_n"], tuned["block_k"]]
    mm = [c for c in cases if c["kernel"] == "streamed_matmul"]
    best = [c for c in mm if c.get("tile") == tile][0]
    kernels.append(dict(
        name="streamed_matmul", route="cuda",
        source=csrc + "streamed_matmul.cu",
        replaces="src/repro/kernels/streamed_matmul.py:46",
        launches=tune_launches["streamed_matmul"],
        serve_launches=tune_stats.kernel_launches["streamed_matmul"],
        max_abs_err=max(c["max_abs_err"] for c in mm
                        if c["dtype"] == "float32"),
        **{k: best[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}))
    print(f"chip_smoke: total wall {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
