#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # one CUDA card, about ten minutes

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit, kernel build time (every CUDA
   kernel is built from ``src/repro_torch/kernels/csrc`` by ``nvcc`` into
   ``build/repro_torch_kernels``, one ``nvcc`` per source, in parallel).
   TF32 is turned off.
2. Every kernel against its plain PyTorch version on the card (fp32,
   tolerance 1e-4 max abs error), with its time beside the plain
   version's, one PyTorch library call's (SDPA; for the paged kernels on
   K/V already gathered to dense, the gather not timed) and its bound.
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
6. Phase 5 through the plain versions; tokens as in phase 4.
7. The chunked-prefill path: the first 4 of phase 5's requests, 16 new
   tokens, ``chunk_prefill=64``.  Chunk jobs must run, flash_attention
   must not launch, paged_flash_verify must launch exactly once per layer
   per round with a chunker, and the tokens must equal phase 5's first
   ones (or first differ at a tie).

Every serve's ledger peak must stay within the budget, and its device
allocator peak (``torch.cuda.max_memory_allocated``) within the budget
plus, in paged mode, the page pool's bytes (freed pages keep their rows
outside the ledger).

Then one JSON line with every kernel: launches (over the whole
``serve.run`` call of the path that runs it, and inside its serving loop
as ``serve_launches``), error, times and bounds at the main path's shapes
(the mean per launch where it runs the kernel at two: the chunk rounds).

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
OVER_BUDGET = []                 # runs whose device allocator passed it


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


def attention_case(torch, fa, ref, gen, name, b, s, kv, g, dh, window=None,
                   sk=None):
    dev = "cuda"
    sk = sk or s
    q = torch.randn((b, s, kv, g, dh), generator=gen, device=dev)
    k = torch.randn((b, sk, kv, dh), generator=gen, device=dev)
    v = torch.randn((b, sk, kv, dh), generator=gen, device=dev)
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
    q_ids = torch.arange(s, device=dev)[:, None]
    k_ids = torch.arange(sk, device=dev)[None, :]
    ok = k_ids <= q_ids
    if window is not None:
        ok &= k_ids > q_ids - window
    if window is None and sk == s:
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


def paged_inputs(torch, gen, b, w, kv, g, dh, page, nb, lengths, shared=0,
                 rows=None, mapped=None):
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
    kp = torch.randn((rows, page, kv, dh), generator=gen, device=dev)
    vp = torch.randn((rows, page, kv, dh), generator=gen, device=dev)
    shape = (b, kv, g, dh) if w is None else (b, w, kv, g, dh)
    q = torch.randn(shape, generator=gen, device=dev)
    perm = torch.randperm(rows, generator=gen, device=dev).tolist()
    prefix, own = perm[:shared], iter(perm[shared:])
    tables = torch.zeros((b, nb), dtype=torch.int32)
    for i, u in enumerate(used):
        tables[i, :u] = torch.tensor(prefix + [next(own)
                                               for _ in range(u - shared)])
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, tables.to(dev), lens


def paged_case(torch, ref, gen, name, b, w, kv, g, dh, page, nb, lengths,
               shared=0, rows=None, mapped=None):
    """Paged decode (``w`` None) or verify (W = ``w``) against its plain
    version.  Library: one SDPA call on K/V already gathered to dense and
    broadcast to the q heads (the gather is not timed).  Bound: bytes of
    q, out, tables, lengths and the K/V of every distinct pool slot some
    row reads (a shared prefix page counts once), or fp32 flops of the
    unmasked (query, slot) pairs."""
    from repro_torch.kernels import paged_decode as pd
    q, kp, vp, tables, lens = paged_inputs(torch, gen, b, w, kv, g, dh,
                                           page, nb, lengths, shared, rows,
                                           mapped)
    kern = pd.paged_flash_decode if w is None else pd.paged_flash_verify
    plain = ref.paged_decode_ref if w is None else ref.paged_verify_ref
    got = kern(q, kp, vp, tables, lens)
    want = plain(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if w == 1:    # one stacked query is paged decode
        dec = pd.paged_flash_decode(q[:, 0].contiguous(), kp, vp, tables,
                                    lens)
        err = max(err, (got[:, 0] - dec).abs().max().item())
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
    nbytes = (4 * (2 * q.numel() + 2 * len(slots) * kv * dh)
              + 4 * (tables.numel() + b))
    b_ms, b_by = bound(nbytes, 4 * pairs * kv * g * dh)
    return dict(kernel="paged_flash_decode" if w is None
                else "paged_flash_verify", case=name, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


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
        # rows 81..99 see no key: they get the mean of V, as in the
        # reference
        attention_case(torch, fa, ref, gen, "Sq=100 Sk=50 H=16 dh=64 "
                       "window=32 (fully masked rows)", 1, 100, 16, 1, 64,
                       window=32, sk=50),
    ] + paged_cases(torch, ref, gen)
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
# phases 3-7: the main paths
# ---------------------------------------------------------------------------
MAIN = dict(requests=8, prompt_len=128, new_tokens=32, max_inflight=4)
# the paged phases: 96 of the 128 prompt tokens shared (6 pages of 16)
PAGED = dict(page_size=16, shared_prefix=96)
CHUNKED = dict(PAGED, requests=4, new_tokens=16, chunk_prefill=64)


def serve(attn_impl, **kw):
    from repro_torch.launch import serve as serve_mod
    args = dict(MAIN, **kw)
    return serve_mod.run("gpt2_base", budget_mb=BUDGET_MB, reduced=False,
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


def same_tokens(torch, cfg, outs, other, what: str, n: int = 0) -> str:
    """Fail unless every request that both runs served has the same tokens
    (the first ``n``, or all), or tokens that first differ at a tie (top-2
    gap below TIE_GAP)."""
    ties = 0
    for rid in sorted(set(outs) & set(other)):
        toks = list(outs[rid][:n or len(outs[rid])])
        ref_toks = list(other[rid][:len(toks)])
        diff = [i for i in range(len(toks)) if toks[i] != ref_toks[i]]
        if diff:
            gap = tie_gap(torch, cfg, toks[:diff[0]])
            print(f"{what}: req{rid} tokens differ first at {diff[0]}; "
                  f"plain top-2 logit gap there {gap:.3e}", flush=True)
            if gap >= TIE_GAP:
                fail(f"{what}: req{rid} greedy tokens differ at step "
                     f"{diff[0]} (gap {gap:.3e})")
            ties += 1
    verdict = "differ only at ties" if ties else "identical"
    print(f"{what}: {verdict}", flush=True)
    return verdict


def expected_serve_launches(stats, n_layers: int, n_chunks: int = 0
                            ) -> dict:
    """Launches the serving loop must make, from its policy log: one
    decode launch (flash_decode, or paged_flash_decode in paged mode) per
    layer per round with a decoder in flight; one flash_attention per
    layer per monolithic prefill; with chunked prefill, one
    paged_flash_verify per layer per round with a chunker (a request
    admitted at round a chunks in rounds a..a+n_chunks-1, then decodes;
    a monolithic one decodes from a+1; a preempted one stops decoding at
    its preemption round and a retired one after its retirement round)."""
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
    want = dict.fromkeys(stats.kernel_launches, 0)
    want["paged_flash_decode" if stats.page_size else "flash_decode"] = (
        n_layers * len(decode_rounds))
    want["flash_attention"] = n_layers * prefills
    want["paged_flash_verify"] = n_layers * len(chunk_rounds)
    return want


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


def run_path(torch, ops, cfg, label: str, attn_impl, n_chunks=0, **kw):
    """Serve one main path with every launch count set to 0 just before
    and read just after; check the serving loop's launches exactly and
    the outputs' shape.  Returns (outs, stats, serve.run launches)."""
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs, stats = serve(attn_impl, **kw)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    alloc_peak = torch.cuda.max_memory_allocated()
    args = dict(MAIN, **kw)
    check_outputs(outs, cfg.padded_vocab, args["requests"],
                  args["prompt_len"] + args["new_tokens"])
    if stats.peak_bytes > BUDGET_MB * 2**20:
        fail(f"{label}: ledger peak {stats.peak_bytes} above the budget")
    # the paged pools hold the mapped high-water mark of rows while the
    # ledger charges mapped pages only: rows on the free list (a retired
    # wave's) are device memory outside it, at most the pool's own bytes
    limit = BUDGET_MB * 2**20 + (stats.cache_bytes_peak if stats.page_size
                                 else 0)
    if alloc_peak > limit:
        # checked at the end, so the later paths still report
        how = "plain" if attn_impl is None else "kernels"
        OVER_BUDGET.append(f"{label} ({how}): torch.cuda.max_memory_"
                           f"allocated {alloc_peak} above {limit} (the "
                           f"budget plus the paged pool's bytes)")
    if attn_impl is None:
        if any(launches.values()):
            fail(f"{label}: attn_impl=None launched kernels: {launches}")
        print(f"{label}: plain versions, rounds {stats.rounds}, "
              f"{stats.tokens_per_s:.3f} tok/s, torch.cuda.max_memory_"
              f"allocated {alloc_peak}, serve.run {wall:.1f}s", flush=True)
        return outs, stats, launches
    want = expected_serve_launches(stats, cfg.num_layers, n_chunks)
    print(f"{label}: kernel launches: serve.run {json.dumps(launches)} "
          f"(profiling and warm-up included); serving loop "
          f"{json.dumps(stats.kernel_launches)}, expected "
          f"{json.dumps(want)}", flush=True)
    if stats.kernel_launches != want:
        fail(f"{label}: serving-loop launches {stats.kernel_launches} != "
             f"{want}")
    print(f"{label}: rounds {stats.rounds}, {stats.tokens_per_s:.3f} tok/s "
          f"aggregate, ledger peak {stats.peak_bytes} bytes (budget "
          f"{BUDGET_MB * 2**20}), breakdown "
          f"{json.dumps(stats.peak_breakdown)}, "
          f"torch.cuda.max_memory_allocated {alloc_peak}, shard loads "
          f"{stats.loads}, streamed {stats.streamed_bytes / 2**20:.1f} MB, "
          f"serve.run {wall:.1f}s", flush=True)
    print(f"{label}: {time_split(stats, cfg)}", flush=True)
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
    outs_plain, _, _ = run_path(torch, ops, cfg, "paged", None, **PAGED)
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

    # ---- phase 2: kernels against their plain versions
    cases = phase_kernels(torch)

    # ---- phases 3-7: the dense, paged and chunked paths; each path's
    # launch counts are set to 0 just before it and read just after
    cfg, dense_launches, dense_stats = phase_main(torch, ops)
    paged_outs, paged_launches, paged_stats = phase_paged(torch, ops, cfg,
                                                          dense_stats)
    chunk_launches, chunk_stats = phase_chunked(torch, ops, cfg, paged_outs)

    # ---- the kernels line: each kernel's launches from the path it serves
    csrc = "src/repro_torch/kernels/csrc/"
    meta = {
        "flash_decode": (csrc + "flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:57",
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
        mine = [c for c in cases if c["kernel"] == kname]
        # the main path's shapes; where it launches the kernel at several
        # (the chunk rounds), each takes an equal share of its launches,
        # so the numbers are their mean per launch
        mains = [c for c in mine if c["case"].startswith("main")]
        mean = lambda key: sum(c[key] for c in mains) / len(mains)  # noqa
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "serve_launches": stats.kernel_launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": max(mains, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": mean("library_ms")})
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
