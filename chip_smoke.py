#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # one CUDA card, about seventeen minutes

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit, kernel build time (every CUDA
   kernel is built from ``src/repro_torch/kernels/csrc`` by ``nvcc`` into
   ``build/repro_torch_kernels``, one ``nvcc`` per source, in parallel),
   each library's ``-Xptxas -v`` registers and spills, and the
   tensor-core instructions (``HMMA`` / ``HGMMA`` in ``cuobjdump -sass``)
   of the two matmul libraries, ``libflash_attention``,
   ``libpaged_decode`` and ``libflash_attention_bwd``: it fails if one of
   the matmul libraries, ``libflash_attention`` or
   ``libflash_attention_bwd`` holds none.
   TF32 is turned off for PyTorch's own matmuls.  While nvcc runs, the
   serving phases' checkpoints and the int8 / int4 transcodes are
   written on the host.
2. Every kernel against its plain PyTorch version on the card (fp32,
   tolerance 1e-4 max abs error; for quantized_matmul and streamed_matmul
   1e-4 of the output's largest magnitude; fp16 / bf16 inputs 2e-3 /
   1.6e-2 of it), with its time beside the plain version's,
   one PyTorch library call's (SDPA; for the paged kernels on K/V already
   gathered to dense, the gather not timed; for quantized_matmul
   ``torch.matmul`` on the weight dequantized to fp32 beforehand, not
   timed; its ``device_ms`` too) and its bound.  quantized_matmul runs at every shape the quant
   phases give it (decode M=4, prefill M=128, the prefill's head M=1),
   int8 and int4.  fp16 and bf16 cases, and head_dim 256, at the fp16
   phases' shapes (gpt_j decode and prefill, vit_large's non-causal
   prefill, the paged kernels, quantized_matmul at gpt_j's MLP width).
   streamed_matmul at gpt2_base's autotune shape (256 x 1024 @ 1024 x
   4096, fp32, TF32 off) at every tile the autotune sweep times, and at
   the reference's sweep shapes in fp32 and bf16; library
   ``torch.matmul``, with its ``device_ms``.  paged_flash_verify also at
   the speculative rounds' shape (B=4, W=5, NB=11, 6 shared pages).
   flash_attention and flash_decode also at phase 16's GQA shapes (32
   query heads on 4 KV heads, G=8, head_dim 128): the prefill B=1 S=32 in
   fp32, fp16 and bf16, the decode B=2 S=40 in fp32 and fp16.
   quantized_matmul also at phase 17's streamed-expert shapes, int8 and
   int4 on fp16 activations: M = 8 (the expert capacity) at K=2048 N=768
   (w_gate, w_up) and K=768 N=2048 (w_down).  Phases 18-19's shapes:
   flash_attention at MLA's q / k 96, v 64 (B=1 S=32 H=40) and the
   latent flash_decode (q 288 against c 256 + kr 32, B=2 S=40 G=40), in
   fp32 and fp16 (SDPA on ``concat(c, kr)`` built beforehand, not timed);
   flash_attention, flash_decode and paged_flash_decode at the VLM's
   G = 6, head_dim 128, in fp16.  quantized_matmul's batched entry at
   phase 20's absorbed products (2 rows, 40 heads, 64 -> 256 and 256 ->
   64, int8 and int4, fp16 activations; library ``torch.bmm`` on the
   per-head weights dequantized beforehand).  flash_attention_bwd (its
   dq, dk, dv against the plain version on the forward kernel's saved
   out and lse, which is held against the plain log-sum-exp) at phase
   21's shape (B=8 S=256 16 x 64 fp32 causal), vit_large's non-causal
   fp16 prefill, a windowed GQA case (G = 4, head_dim 128, window 64),
   qwen3_moe's G = 8 head_dim 128 fp16 and minicpm3's (96, 64) in fp32
   and bf16; library SDPA's backward (``torch.autograd.grad`` of its
   output), bound the bytes of q, k, v, out, d_out, lse, dq, dk, dv
   against five attention-sized products; the bwd and batched lines also
   print their library's ptxas registers / spills and SASS ``HMMA``
   count.  For
   every timed case also ``device_ms``: the
   kernels' own time per call from ``torch.profiler`` (no host time
   between calls), beside ``ms`` (CUDA events over 50 back-to-back calls,
   which read host time when the host is the slower side), and the
   kernels per call; for the attention kernels ``library_device_ms``, the
   same of the SDPA call.  A flash_decode or paged_flash_decode call that
   runs more than one kernel fails.  Every kernel's fp32 operations are
   bound at TF32's 495 TFLOP/s, the fastest rate at which the card
   multiplies fp32 inputs.
3. The dense path at full width: a full-size gpt2_base checkpoint (24
   layers, d=1024, fp32, random weights from a numpy seed) served through
   ``repro_torch.launch.serve.run`` — the first wave of 4 requests,
   128-token prompts, 32 new tokens, 4 in flight, under a budget below
   the model's size so
   layers stream and are destroyed.  The profile is measured anew.  The
   serving loop must launch flash_decode exactly once per layer per
   decode round and flash_attention once per layer per admitted request's
   prefill.
4. Phase 3's 4 requests through the plain versions
   (``attn_impl=None``), their first 8 new tokens (``PLAIN_NEW_TOKENS``):
   the greedy tokens must equal phase 3's first ones, unless the first
   differing step is a tie (top-2 logit gap below 1e-4).
5. The paged path: the same requests with their first 96 prompt tokens
   shared, ``page_size=16``.  The planner must pick page size 16, the
   prefix tree must hit, and the serving loop must launch
   paged_flash_decode exactly once per layer per decode round.
6. Phase 5's 4 requests through the plain versions, 8 new tokens;
   tokens as in phase 4.
7. The chunked-prefill path: the first 4 of phase 5's requests, 16 new
   tokens, ``chunk_prefill=64``.  Chunk jobs must run, flash_attention
   must not launch, paged_flash_verify must launch exactly once per layer
   per round with a chunker, and the tokens must equal phase 5's first
   ones (or first differ at a tie).
8-9. The quant paths, int8 then int4: phase 3's checkpoint transcoded by
   the port's ``ensure_quantized`` and served as phase 3 is (its 4
   requests, ``--quant int8`` / ``int4``) under a budget below the
   quantized checkpoint plus
   its KV (300 / 250 MiB), so layers still stream and are destroyed.
   quantized_matmul must launch exactly 145 times (24 layers x 6 linears
   + the head) per decode round and per prefill, the attention kernels as
   in phase 3; ``streamed_bytes`` must equal the quantized manifest bytes
   of the shards loaded; the same requests through the plain versions,
   8 new tokens, must give the same first tokens (tie rule); and one
   prompt's last-token
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
   (below its ~2.45 GB of shards), kernels then plain versions (their
   first 2 new tokens): launches exact, tokens equal (tie rule: top-2 gap
   within 2e-3 of the largest logit).
12. vit_large at full size (24 fp16 layers, non-causal) through
   ``PipeloadEngine.run_single`` on 2 x 197 tokens under 300 MiB, kernels
   then plain: flash_attention once per layer, logits within 2e-3 of the
   plain run's largest and the same argmax.
13. Speculative serving: phase 5's first 4 requests at page size 16
   through ``Hermes.scheduler`` with a ``DraftModel`` at depth 4: a
   full-width gpt2_base cut to 2 layers, its own checkpoint from numpy
   seed 1, under 1450 MiB (below target plus draft, so target layers
   stream), the planner told to expect acceptance 1.0 (its pick at the
   default 0.8 is printed).  The planner must serve page size 16 at
   depth 4; the tokens
   must be phase 5's (tie rule); the serving loop must launch
   paged_flash_verify once per layer per verify round, flash_attention
   once per layer of target and draft per admission, flash_decode once
   per draft layer per stacked draft step (the script counts
   ``DraftModel.decode_batch`` calls) and paged_flash_decode never; the
   ledger's ``draft`` share at its peak must be the draft's manifest
   bytes, the pool must drain and the draft's device copies must be gone
   after the session.
14. The self-draft ceiling: a full-width gpt2_base cut to 4 layers (its
   own checkpoint, numpy seed 0) serves the same requests under 1150 MiB
   (below target plus draft) without a draft (the planner's schedule)
   and with itself as the draft at depth 4 (1 agent, pin 0, fixed
   through ``Hermes.engine`` and ``BatchScheduler``, as ``serve
   --num-agents 1 --pin-window 0 --spec-depth 4`` fixes it): the same
   tokens (tie rule), acceptance 1.0 unless
   every rejected proposal sits at a tie of the model's top-2 logits
   (each printed), and fewer verify rounds than the plain run's decode
   rounds.  Both walls are printed; no speed-up is claimed.
15. The SLO multi-tenant tier: phase 3's checkpoint through
   ``serve.run(tenants=2, requests=12, prompt_len=192, new_tokens=16,
   shared_prefix=32, arrival_rate=0.5, page_size=16, chunk_prefill=64,
   max_inflight=4)`` under 900 MiB with ``slo_ttft_ms`` 4.5 rounds of the
   plan's predicted round latency and shedding on (``SLO_PATH``).  It
   must serve page size 16 with 64-token chunks, preempt a request in a
   round in which a higher class is admitted, shed one request and let
   one meet its TTFT target, hit a tenant's prefix, and keep the tenants
   apart at every round boundary (no page mapped by two tenants' requests
   or held by two tenants' prefix trees).  The same trace then goes
   through the plain versions on the kernel run's schedule (agents, pin,
   in-flight count, page size, chunk and ``SLO``, fixed through
   ``Hermes.engine`` and ``BatchScheduler``): the same policy sequence,
   and the same tokens for every request not shed (tie rule).  The
   serving loop must launch paged_flash_verify once per layer per round
   with a chunker, paged_flash_decode once per layer per decode round and
   flash_attention once per layer per monolithic prefill, as derived from
   the policy log and the prompt lengths; the ledger peak must stay within
   the budget less cuBLAS's workspace.
16. MoE expert streaming: qwen3_moe_30b_a3b at full width (d 2048, 32
   query heads on 4 KV heads x 128, 128 experts top-8 of d_ff 768, vocab
   151936 -> 153600), depth cut to 2 of 48 layers, stored in fp16 (the
   baseline of phase 17), routers x8 after init (``MOE_ROUTER_SCALE``),
   written expert-split from numpy seed 0: 2 requests of 32 + 8 tokens
   through ``serve.run`` under ``MOE_BUDGET_MB``, kernels then plain
   versions on the same schedule.  The serving loop must launch
   flash_attention once per layer per prefill and flash_decode once per
   layer per decode round; the expert cache must evict (it cannot hold
   both layers' experts).  Every router call of the serving loop is
   recorded in both runs: up to the first call whose top-8 picks differ
   (and before any round that read a differing token) the kernel run's
   router logits at layer l (from 0) must be within (l + 1) x
   ``HALF_RTOL["float16"]`` of the call's largest |logit| of the plain
   run's, and a differing pick must sit at a plain top-8 margin (8th minus
   9th logit) below twice its row's logit difference; the first differing
   pick is printed.  The tokens must be
   the plain run's, unless the first differing step is a tie of the
   head's top-2 logits (``TIE_RTOL_HALF``) or the picks first differed
   in that round or an earlier one; the ledger peak within the budget
   less cuBLAS's workspace with an ``expert_cache`` share, the allocator
   peak within the budget; the expert loads equal to the misses,
   ``streamed_bytes`` to the manifest bytes of every load, and the
   telemetry counters' hits and misses over the serving loop to the
   stats'.
17. Quantized expert streaming: phase 16's checkpoint transcoded to int8
   by the port's ``ensure_quantized`` (while nvcc builds; the routers
   stay fp32) and served as phase 16 is through ``serve.run(...,
   quant="int8")`` under ``MOE_QUANT_BUDGET_MB``, kernels then plain
   versions.  The budget's reckoning from the int8 manifest is printed:
   its ledger share must hold the embed, head, KV, one layer's experts
   and one streaming layer but not two.  Every phase 16 check holds, and
   quantized_matmul must launch exactly once per attention linear per
   layer per pass, once per pass for the head, and three times per
   streamed expert (the union of each recorded router call's picks); the
   kernel run must widen no quantized weight to fp32 and the plain run
   some; the allocator peak follows the quant paths' rule below.  The
   per-expert bytes against phase 16's and how many requests' tokens
   equal phase 16's are printed, not checked.
18. MLA: minicpm3_4b at full width (d 2560, 40 heads, q_lora 768,
   kv_lora 256, rope 32, v / nope 64, d_ff 6400, vocab 73,448 -> 73,728),
   depth cut to 4 of 62 layers, fp16, numpy seed 0: 2 requests of 32 + 8
   tokens through ``serve.run`` under ``MLA_BUDGET_MB`` (the reckoning
   from the manifest is printed: its ledger share holds two streaming
   layers but not three), kernels then plain versions on the same plan,
   then paged at 16 with the kernels on that plan, fixed (``Hermes.engine``
   and ``BatchScheduler``).  Every run's serving loop must launch
   flash_attention (q / k 96, v 64) once per layer per prefill and the
   latent flash_decode once per layer per decode round, and no paged
   kernel (MLA pages take the gather path, as in the reference); layers
   must stream (more loads than layers); the plain run's and the paged
   run's tokens must equal the dense kernel run's (tie rule).
19. VLM: qwen2_vl_2b's backbone at full width (d 1536, 12 heads on 2 KV
   heads of 128, G = 6, d_ff 8960, vocab 151,936 -> 153,600), depth cut
   to 4 of 28 layers, fp16, numpy seed 0 (the embed shard carries
   ``patch_proj``): 4 requests of 64 + 8 tokens, the first 48 shared, at
   most 4 in flight, under ``VLM_BUDGET_MB`` (reckoned as phase 18's),
   paged at 16 on the planner's agents, pin and in-flight count (the page
   size fixed), kernels then plain versions: flash_attention once per
   layer per prefill and paged_flash_decode (G = 6) once per layer per
   decode round, as derived from the policy log; the prefix tree must
   hit, layers stream, and the tokens equal the plain run's (tie rule).
20. MLA on int8 shards: phase 18's checkpoint transcoded to int8 (written
   while nvcc builds), phase 18's 2 requests of 32 + 8 tokens through
   ``serve.run(quant="int8")`` under ``MLA_QUANT_BUDGET_MB``, reckoned from
   the int8 manifest (two streaming layers fit, three do not), kernels
   then plain versions.  quantized_matmul's serving-loop launches are
   checked exactly: 11 per layer per pass plus the head's, the decode's
   W_uk / W_uv absorption being one batched launch each for all 40 heads;
   the kernel run widens no quantized weight and its allocator peak stays
   within the ledger peak + 48 MiB; the tokens equal the plain run's (tie
   rule) and the last-token logits sit within 5% of the fp16 checkpoint's
   largest.
21. Training: ``repro_torch.launch.train``'s path (``train.run``) on full
   gpt2_base (24 fp32 layers, its config's remat), batch 8 x 256 tokens,
   5 AdamW steps, TF32 off, kernels then plain versions from the same
   seed: each step's loss within 1e-4 relative, step 1's gradients (one
   backward on the same parameters and batch) within 1e-4 of each leaf's
   largest |g|; flash_attention launches exactly 24 x 5 x 2 (the forward
   and remat's recompute) and flash_attention_bwd 24 x 5, nothing else,
   the plain run nothing; step ms and the allocator peak beside params +
   grads + two fp32 moments.

Budgets go through ``Hermes`` (``serve.run`` too), whose planner and
ledger take the budget less cuBLAS's 32 MiB workspace
(``Hermes.ledger_budget``).  Every serve's ledger peak must stay within
its budget, and its device
allocator peak (``torch.cuda.max_memory_allocated``) within the budget
plus, in paged mode (phase 13 included), the page pool's bytes (freed pages keep their rows
outside the ledger).  On quantized shards the kernels must widen no
weight to fp32 on the card (every call that could is counted), and their
allocator peak must stay within the ledger peak plus 48 MiB: the planner
fills the budget with ledger bytes, and beside them sit one prefill's
activations (~6 MB) and the caching allocator's rounding (a reused block
is not split when under 1 MiB would remain: up to 1 MiB for each
resident weight tensor above 1 MiB, ~30 on the int4 path).  The plain
versions widen one weight at a time, so their limit is the budget plus
three times the largest weight's fp32 bytes.  Phases 13-14 print the
allocator peak of the warm-up and of the serving loop apart, with the
bytes the process held before the session (cuBLAS's 32 MiB workspace,
taken at the process's first matmul and kept).

Then one JSON line with every kernel: launches (over the whole
``serve.run`` call of the path that runs it, and inside its serving loop
as ``serve_launches``; for quantized_matmul both quant paths; for
streamed_matmul the autotune phase's sweep), fp32 error,
times (``ms``, ``device_ms``; for the attention kernels also
``kernels_per_call`` and ``library_device_ms``) and bounds at the main
path's shapes (where it runs the kernel at
several, the chunk rounds' two and the spec rounds' one for
paged_flash_verify, or quantized_matmul's 16, the mean per launch
weighted by the serving loops' launches at each; streamed_matmul at the
autotune shape and the tile the sweep chose).  paged_flash_verify's
launches add the chunked and the speculative phases'; every attention
kernel also reports phase 13's launches (``spec_launches``,
``spec_serve_launches``), phase 15's (``slo_launches``,
``slo_serve_launches``), phase 16's (``moe_launches``,
``moe_serve_launches``), phase 17's (``moe_quant_launches``,
``moe_quant_serve_launches``; quantized_matmul has these two as well),
phase 18's (``mla_launches``, ``mla_serve_launches``: the dense and the
paged kernel runs together), phase 19's (``vlm_launches``,
``vlm_serve_launches``), phase 20's (``mla_quant_launches``,
``mla_quant_serve_launches``; quantized_matmul too) and phase 21's
(``train_launches``).  flash_attention_bwd's row (the counterpart of the
JAX package's jnp custom VJP, not of a Pallas kernel) takes its launches
from phase 21, its numbers at phase 21's shape, and adds that phase's
mean step ms after the first (``train_step_ms``) and allocator peak.
Before them, each phase's wall.

``--kernels-only`` stops after phase 2 (a quick check of every kernel,
with its times) and prints no result line.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repo's ``src/repro_torch`` beside it, it exits 2 and prints
no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
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
ALLOC_SLACK = 48 * 2**20   # activations + allocator rounding (above)
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
GPTJ_PLAIN_NEW_TOKENS = 2        # the plain partner's new tokens
# vit_large at full size: 24 fp16 layers of ~25 MB, non-causal, batch 2 x
# 197 tokens (196 patches + class token) through run_single, streamed
# under a budget below its ~605 MB
VIT = dict(batch=2, seq=197, budget_mb=300, agents=2)
# speculative serving at depth 4, so verify windows of W = 5.  Phase 13:
# the paged phase's first 4 requests with a full-width 2-layer draft of
# its own weights (~520 MB of shards), under a budget that holds the
# ~900 MiB of the paged phase plus the draft and its cache rows, below
# target plus draft (~2.15 GB).  The planner models a verify round's
# compute as growing with its window (t_decode x R x W), so at the
# facade's default acceptance 0.8 it keeps plain decoding here unless
# layers load slowly; the phase tells it to expect the draft's ceiling,
# 1.0, so the speculative plan is searched on any load path (the
# measured acceptance of the random draft is ~0).  Phase 14: a
# 4-layer full-width target (~620 MB) drafting itself, below target plus
# draft (~1.24 GB).  Pinned whole, the target wins every plan, so its
# speculative run takes the one schedule that fits the draft beside it,
# fixed: 1 agent streaming every layer, pin 0, whose 1,125,695,488 ledger
# bytes and cuBLAS's 32 MiB the budget holds.
SPEC_W = 5
SPEC = dict(requests=4, draft_layers=2, budget_mb=1450, acceptance=1.0)
SELF = dict(layers=4, budget_mb=1150, new_tokens=32, schedule=(1, 0))
# phase 15, the SLO tier on phase 3's checkpoint and budget: two tenants'
# 12 requests from a seeded trace (Poisson arrivals at 0.5 per round,
# lognormal prompts of mean 96 clipped to [4, 192], geometric outputs of
# mean 8 up to 16, priority classes 0-2, a 32-token system prompt per
# tenant reused by 60% of its requests), paged at 16 with 64-token chunks,
# at most 4 in flight, a TTFT target of 4.5 rounds of the plan's round
# latency (4 rounds) with shedding.  Trace seed 2: served at tiny width on
# the CPU at 2, 3 and 4 in flight, it preempts for a higher class, sheds,
# meets the target and hits each tenant's prefix
SLO_PATH = dict(tenants=2, requests=12, prompt_len=192, new_tokens=16,
                shared_prefix=32, arrival_rate=0.5, page_size=16,
                chunk_prefill=64, max_inflight=4, seed=2)
SLO_TTFT_ROUNDS = 4
# phase 16, qwen3_moe_30b_a3b at full width, depth cut to 2 of 48 layers,
# fp16: embed and head 629,145,600 B each, a layer's attention+router
# shard 38,805,504 B, 128 experts of 9,437,184 B per layer (1,207,959,552
# B).  The scheduler's expert floor is every expert of one layer (a
# 40-token prefill may touch all 128), which is also the smallest cache
# the planner offers; the next, both layers' experts, does not fit.  The
# budget holds the embed, head, KV, that cache and ONE streaming layer
# but not two (2,524,971,008 ledger bytes after cuBLAS's 32 MiB, against
# 2,505,388,032 with one layer and 2,544,193,536 with two), so the
# planner can pin no layer: every layer streams and is destroyed, and the
# cache evicts one layer's experts for the other's.  Random routers over
# 128 experts are near-uniform; scaled x8 (as the reference's fixture
# scales them) their top-8 picks rarely sit at a tie
MOE_LAYERS = 2
MOE_PATH = dict(requests=2, prompt_len=32, new_tokens=8, max_inflight=2)
MOE_BUDGET_MB = 2440
MOE_ROUTER_SCALE = 8.0
# phase 17, phase 16's checkpoint transcoded to int8 (the routers kept
# fp32): embed and head 629,772,392 B together, a layer's attention+router
# shard 19,960,016 B, 128 experts of 4,733,084 B per layer (605,834,752 B;
# fp16's 9,437,184 B per expert is 1.994x).  Sized as MOE_BUDGET_MB: the
# ledger's share (1,266,679,808 B after cuBLAS's 32 MiB) holds the embed,
# head, KV, one layer's experts and ONE streaming layer (1,255,894,840 B
# with 2 x 2 x 40 KV rows) but not two (1,275,854,856 B), so every layer
# streams and the cache evicts; the phase prints the reckoning from the
# manifest and fails if the budget falls outside it
MOE_QUANT = "int8"
MOE_QUANT_BUDGET_MB = 1240
# phase 18, minicpm3_4b (MLA) at full width (d 2560, 40 heads, q_lora 768,
# kv_lora 256, rope 32, v / nope 64, d_ff 6400, vocab 73,448 -> 73,728),
# depth cut to 4 of 62 layers, fp16: layers 125,349,888 B each, embed and
# head 377,487,360 B each.  The ledger's share of the budget
# (1,119,879,168 B after cuBLAS's 32 MiB) holds the embed, head, the KV of
# 2 x 40 tokens (576 B per token per layer) and two streaming layers
# (1,005,858,816 B) but not three (1,131,208,704 B), so layers stream and
# are destroyed.  The paged run (page 16) serves the dense run's schedule
# fixed: the planner's page search ties with dense at this KV size, and a
# tie keeps dense
MLA_LAYERS = 4
MLA = dict(requests=2, prompt_len=32, new_tokens=8, max_inflight=2)
MLA_BUDGET_MB = 1100
MLA_PAGE = 16
# phase 19, qwen2_vl_2b's backbone (VLM) at full width (d 1536, 12 heads on
# 2 KV heads of 128, so G = 6; d_ff 8960, vocab 151,936 -> 153,600), depth
# cut to 4 of 28 layers, fp16: layers 93,591,552 B, embed 471,859,200 B
# plus patch_proj 4,718,592 B, head 471,859,200 B.  The ledger's share
# (1,203,765,248 B) holds the embed, head, KV and two streaming layers but
# not three.  4 requests of 64 + 8 tokens, the first 48 shared, paged at
# 16 on the planner's schedule with the page size fixed (as phase 18's
# paged run)
# phase 20: phase 18's model on its int8 transcode; two int8 streaming
# layers fit the budget's ledger share and three do not (embed 188.8 MB +
# head 189.0 MB + KV 0.2 MB + 2 x 62.8 MB layers = 512.2 MiB with cuBLAS's
# 32 MiB workspace, three 572.1 MiB)
MLA_QUANT = "int8"
MLA_QUANT_BUDGET_MB = 540
# phase 21: launch/train.py's path on full gpt2_base (24 layers, fp32, its
# config's remat), TF32 off
TRAIN = dict(batch=8, seq=256, steps=5)
TRAIN_RTOL = 1e-4   # kernels vs plain: each step's loss, step 1's grads
VLM_LAYERS = 4
VLM = dict(requests=4, prompt_len=64, new_tokens=8, max_inflight=4,
           shared_prefix=48)
VLM_BUDGET_MB = 1180
VLM_PAGE = 16
DRAFT_STEPS = [0]                # DraftModel.decode_batch calls
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


def timings(torch, run, plain, lib) -> dict:
    """An attention case's times: CUDA-event ms of the kernel, its plain
    version and the library call, and ``device_ms`` (``torch.profiler``)
    of the kernel (with its kernels per call) and of the library call."""
    dev, per_call, names = device_ms(torch, run)
    return dict(ms=time_ms(torch, run), plain_ms=time_ms(torch, plain),
                library_ms=time_ms(torch, lib), device_ms=dev,
                kernels_per_call=per_call, kernel_names=names,
                library_device_ms=device_ms(torch, lib)[0])


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
DECODE_KERNELS = ("flash_decode", "flash_decode_partial",
                  "paged_flash_decode")


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
    run = lambda: fd.flash_decode_gqa(q, k, v, valid)  # noqa: E731
    plain = lambda: ref.decode_gqa_ref(q, k, v, valid)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    err, limit = error(got, want)
    # library yardstick: SDPA over the same grouped cache and mask
    qs = q.reshape(b, kv * g, 1, dh)
    ks = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vs = v.transpose(1, 2).repeat_interleave(g, dim=1)
    mask = valid[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = timings(torch, run, plain,
                    lambda: sdpa(qs, ks, vs, attn_mask=mask))
    n_valid = int(sum(lengths))
    nbytes = (q.element_size() * (q.numel() + 2 * n_valid * kv * dh
                                  + q.numel()) + b * s)
    flops = 4 * n_valid * kv * g * dh
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    return dict(kernel="flash_decode", case=name, max_abs_err=err,
                limit=limit, dtype=dtype_name(q), **times, bound_ms=b_ms,
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
                 "unnormalised", max_abs_err=err,
                 **timings(torch, run, plain, lambda: sdpa(qs, ks, vs)),
                 bound_ms=b_ms, bound_by=b_by)
    return [combined, timed]


def attention_case(torch, fa, ref, gen, name, b, s, kv, g, dh, window=None,
                   sk=None, dtype=None, causal=True, dv=None):
    """Prefill attention at q / k width ``dh`` and v width ``dv`` (default
    ``dh``) against its plain version; library: SDPA on the same heads
    (broadcast to the q heads, not timed)."""
    dev = "cuda"
    sk = sk or s
    dv = dv or dh
    dtype = dtype or torch.float32
    q = torch.randn((b, s, kv, g, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, kv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, kv, dv), generator=gen, device=dev).to(dtype)
    run = lambda: fa.flash_attention_gqa(q, k, v, causal=causal,  # noqa: E731
                                         window=window)
    got = run()
    want = ref.attention_gqa_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err, limit = error(got, want)
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
    times = timings(torch, run, lambda: ref.attention_gqa_ref(
        q, k, v, causal=causal, window=window), lib)
    pairs = int(ok.sum().item())
    nbytes = q.element_size() * (q.numel() + got.numel() + k.numel()
                                 + v.numel())
    flops = 2 * pairs * b * kv * g * (dh + dv)
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    return dict(kernel="flash_attention", case=name, max_abs_err=err,
                limit=limit, dtype=dtype_name(q), **times, bound_ms=b_ms,
                bound_by=b_by)


def latent_case(torch, fd, ref, gen, name, b, s, g, lengths, dtype=None):
    """MLA's latent decode: q (B, 1, G, 288) against c (B, S, 256) and kr
    (B, S, 32), ragged valid lengths.  Library: SDPA over ``concat(c,
    kr)`` and ``c`` broadcast to the G heads, built beforehand (not timed).
    Bound: bytes of q, out, the valid slots' c and kr rows and the mask, or
    the operations of the valid (head, slot) pairs (288 for the score, 256
    for the value, 2 per multiply-add)."""
    dev = "cuda"
    dtype = dtype or torch.float32
    dc, dr = fd.LATENT_DIMS
    q = torch.randn((b, 1, g, dc + dr), generator=gen, device=dev).to(dtype)
    c = torch.randn((b, s, dc), generator=gen, device=dev).to(dtype)
    kr = torch.randn((b, s, dr), generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, device=dev)
    valid = torch.arange(s, device=dev)[None, :] < lens[:, None]
    run = lambda: fd.flash_decode_latent(q, c, kr, valid)  # noqa: E731
    plain = lambda: ref.decode_latent_ref(q, c, kr, valid)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    err, limit = error(got, want)
    qs = q.transpose(1, 2)                                    # (B, G, 1, 288)
    ks = torch.cat([c, kr], -1)[:, None].expand(b, g, s, dc + dr).contiguous()
    vs = c[:, None].expand(b, g, s, dc).contiguous()
    mask = valid[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = timings(torch, run, plain,
                    lambda: sdpa(qs, ks, vs, attn_mask=mask))
    n_valid = int(sum(lengths))
    nbytes = (q.element_size() * (q.numel() + got.numel()
                                  + n_valid * (dc + dr)) + b * s)
    b_ms, b_by = bound(nbytes, 2 * n_valid * g * (2 * dc + dr),
                       dtype_name(q))
    return dict(kernel="flash_decode", case=name, max_abs_err=err,
                limit=limit, dtype=dtype_name(q), **times, bound_ms=b_ms,
                bound_by=b_by)


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
    times = timings(torch, lambda: kern(q, kp, vp, tables, lens),
                    lambda: plain(q, kp, vp, tables, lens),
                    lambda: sdpa(qs, ks, vs, attn_mask=mask))
    pairs = sum(n - ww + i + 1 for n in lengths for i in range(ww))
    tab = tables.tolist()
    slots = {(tab[i][s // page], s % page)
             for i, n in enumerate(lengths) for s in range(n)}
    nbytes = (q.element_size() * (2 * q.numel() + 2 * len(slots) * kv * dh)
              + 4 * (tables.numel() + b))
    b_ms, b_by = bound(nbytes, 4 * pairs * kv * g * dh, dtype_name(q))
    return dict(kernel="paged_flash_decode" if w is None
                else "paged_flash_verify", case=name, max_abs_err=err,
                limit=limit, dtype=dtype_name(q), **times, bound_ms=b_ms,
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
        # the speculative phase's verify rounds at depth 4: 4 rows feed a
        # 5-token window each through tables of pages_for(160 + 4, 16) =
        # 11 entries, the 6 prompt pages shared; lengths (pos + 5) from
        # the first decode round's 133 to the last's 164
        paged_case(torch, ref, gen, "main path spec round B=4 W=5 KV=16 "
                   "G=1 dh=64 page=16 NB=11, 6 shared pages", 4, SPEC_W,
                   nb=11, lengths=[133, 144, 152, 164], **main),
        # the SLO phase's shapes: tables of pages_for(208, 16) = 13
        # entries, two tenants' 2-page system prompts, prompts up to 192;
        # a decode batch of 4 and a chunk round of 3 windows
        paged_case(torch, ref, gen, "slo path B=4 KV=16 G=1 dh=64 page=16 "
                   "NB=13, 2 shared pages", 4, None, nb=13,
                   lengths=[97, 150, 181, 207], **dict(main, shared=2)),
        paged_case(torch, ref, gen, "slo path chunk round B=3 W=64 KV=16 "
                   "G=1 dh=64 page=16 NB=13, 2 shared pages", 3, 64, nb=13,
                   lengths=[64, 128, 192], mapped=12,
                   **dict(main, shared=2)),
        paged_case(torch, ref, gen, "B=1 W=64 KV=16 G=1 dh=64 page=16 NB=10",
                   1, 64, 16, 1, 64, 16, 10, [128]),
        paged_case(torch, ref, gen, "W=1 B=4 KV=16 G=1 dh=64 page=16 NB=10",
                   4, 1, 16, 1, 64, 16, 10, [129, 140, 150, 160]),
        paged_case(torch, ref, gen, "W=3 B=3 KV=4 G=2 dh=64 page=5 NB=32",
                   3, 3, 4, 2, 64, 5, 32, [3, 101, 160]),
    ]


def quant_shapes(cfg):
    """Every (kind, M, K, N, launches) the quant paths give
    quantized_matmul: kind "decode" at M = the in-flight rows, once per
    decode round, and kind "prefill" at M = the prompt (M = 1 for the
    head, which reads the last position only), once per prefill; phases
    8-9's shapes for a dense config, phase 17's for an MoE one.  An MoE
    config's FFN is its experts' (``expert_d_ff``): kind "expert" at
    M = the capacity of a phase 17 prefill (a decode round's is the same
    8 rows), with its launches per streamed expert (its count per round
    follows the routing)."""
    if cfg.attention == "mla":
        return mla_quant_shapes(cfg)
    path = MOE_PATH if cfg.family == "moe" else MAIN
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    layer = [(d, hd), (d, kvd), (d, kvd), (hd, d)]
    f = cfg.expert_d_ff if cfg.family == "moe" else cfg.d_ff
    ffn = [(d, f), (f, d)] + ([(d, f)] if cfg.gated_mlp else [])
    per_layer = {}
    for kn in layer + ([] if cfg.family == "moe" else ffn):
        per_layer[kn] = per_layer.get(kn, 0) + cfg.num_layers
    head = (d, cfg.padded_vocab)
    out = []
    for kind, m in (("decode", path["max_inflight"]),
                    ("prefill", path["prompt_len"])):
        out += [(kind, m, k, n, c) for (k, n), c in per_layer.items()]
        out.append((kind, m if kind == "decode" else 1) + head + (1,))
    if cfg.family == "moe":
        from repro_torch.models import moe
        cap = moe.capacity(cfg, path["prompt_len"])
        per_expert = {}
        for kn in ffn:
            per_expert[kn] = per_expert.get(kn, 0) + 1
        out += [("expert", cap, k, n, c) for (k, n), c in per_expert.items()]
    return out


def mla_quant_shapes(cfg):
    """``quant_shapes`` of an MLA config on phase 20's path: every linear
    of a layer in both passes (the SwiGLU MLP's included); the prefill
    multiplies by W_uk and W_uv as linears, the decode absorbs them with
    one batched launch each for all heads (its entries: the per-head K x
    N, counted once per layer)."""
    d, h, f = cfg.d_model, cfg.n_heads, cfg.d_ff
    dq, dc, dr = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim
    dn = dv = cfg.v_head_dim
    both = [(d, dq), (dq, h * dn), (dq, h * dr), (d, dc), (d, dr),
            (h * dv, d), (d, f), (f, d)] + ([(d, f)] if cfg.gated_mlp else [])
    per = {"decode": both + [(dn, dc), (dc, dv)],
           "prefill": both + [(dc, h * dn), (dc, h * dv)]}
    out = []
    for kind, m in (("decode", MLA["max_inflight"]),
                    ("prefill", MLA["prompt_len"])):
        counts = {}
        for kn in per[kind]:
            counts[kn] = counts.get(kn, 0) + cfg.num_layers
        out += [(kind, m, k, n, c) for (k, n), c in counts.items()]
        out.append((kind, m if kind == "decode" else 1, d, cfg.padded_vocab,
                    1))
    return out


def linears_per_pass(cfg) -> int:
    """quantized_matmul launches per pass of the model: every linear of
    every layer, and the head's (for an MoE config its attention's and the
    head's: the experts' follow the routing)."""
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
    lib = lambda: torch.matmul(x, w_deq)  # noqa: E731
    lib_ms, lib_dev = time_ms(torch, lib), device_ms(torch, lib)[0]
    del w_deq, lib
    nbytes = x.element_size() * (x.numel() + m * n) + 4 * n + w_q.numel()
    b_ms, b_by = bound(nbytes, 2 * m * k * n, dtype_name(x))
    main = "main path " if dtype == torch.float32 else ""
    return dict(kernel="quantized_matmul", bits=bits, kind=kind,
                count=count, dtype=dtype_name(x), case=f"{main}{kind} M={m} K={k} N={n} "
                f"int{bits} {dtype_name(x)}", max_abs_err=err, limit=limit,
                ms=ms, device_ms=dev_ms, kernels_per_call=per_call,
                kernel_names=names, plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by)


def bwd_case(torch, fa, fab, ref, gen, name, b, s, kv, g, dqk, dv=None,
             window=None, causal=True, dtype=None):
    """The flash-attention backward at one shape against its plain version
    (``ref.attention_gqa_bwd_ref``) on the forward kernel's saved (out,
    lse), whose lse is held against the plain log-sum-exp first.  Error:
    each of dq, dk, dv within TOL (fp32) or ``HALF_RTOL`` of its largest
    magnitude; the worst of the three is reported.  Library: SDPA's
    backward on the same heads (K / V repeated to the q heads, the forward
    not timed).  Bound: the bytes of q, k, v, out, d_out, lse, dq, dk, dv
    against the five products' 2 (3 dqk + 2 dv) flops per unmasked pair."""
    dev = "cuda"
    dv = dv or dqk
    dtype = dtype or torch.float32
    kw = dict(causal=causal, window=window)
    q = torch.randn((b, s, kv, g, dqk), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kv, dqk), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kv, dv), generator=gen, device=dev).to(dtype)
    d_out = torch.randn((b, s, kv, g, dv), generator=gen, device=dev).to(
        dtype)
    out, lse = fa.flash_attention_gqa(q, k, v, return_lse=True, **kw)
    _, want_lse = ref.attention_gqa_lse_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    lse_err = (lse - want_lse).abs().max().item()
    lse_limit = TOL * max(1.0, want_lse.abs().max().item())
    if not lse_err <= lse_limit:
        fail(f"flash_attention {name}: lse error {lse_err} above "
             f"{lse_limit}")
    run = lambda: fab.flash_attention_bwd(q, k, v, out, lse,  # noqa: E731
                                          d_out, **kw)
    plain = lambda: ref.attention_gqa_bwd_ref(q, k, v, out,  # noqa: E731
                                              lse, d_out, **kw)
    got, want = run(), plain()
    torch.cuda.synchronize()
    if any(gt.dtype != dtype for gt in got):
        fail(f"flash_attention_bwd {name}: gradients not in {dtype}")
    rtol = TOL if dtype == torch.float32 else HALF_RTOL[dtype_name(q)]
    errs = [((gt.float() - wt.float()).abs().max().item(),
             rtol * wt.float().abs().max().item())
            for gt, wt in zip(got, want)]
    worst = max(errs, key=lambda e: e[0] / e[1])    # (error, its limit)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q.reshape(b, s, kv * g, dqk).transpose(1, 2).detach()
    ks = k.transpose(1, 2).repeat_interleave(g, dim=1).detach()
    vs = v.transpose(1, 2).repeat_interleave(g, dim=1).detach()
    for t in (qs, ks, vs):
        t.requires_grad_(True)
    ids = torch.arange(s, device=dev)
    ok = (ids[None, :] <= ids[:, None]) if causal else torch.ones(
        (s, s), dtype=torch.bool, device=dev)
    if window is not None:
        ok &= ids[None, :] > ids[:, None] - window
    o = (sdpa(qs, ks, vs, is_causal=True) if causal and window is None
         else sdpa(qs, ks, vs, attn_mask=ok) if window is not None
         else sdpa(qs, ks, vs))
    go = d_out.reshape(b, s, kv * g, dv).transpose(1, 2)
    lib = lambda: torch.autograd.grad(o, (qs, ks, vs), go,  # noqa: E731
                                      retain_graph=True)
    times = timings(torch, run, plain, lib)
    pairs = int(ok.sum().item())
    nbytes = (q.element_size() * (2 * (q.numel() + k.numel() + v.numel())
                                  + 2 * out.numel()) + 4 * lse.numel())
    flops = 2 * pairs * b * kv * g * (3 * dqk + 2 * dv)
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    del o, qs, ks, vs
    return dict(kernel="flash_attention_bwd", case=name,
                max_abs_err=worst[0], limit=worst[1], dtype=dtype_name(q),
                lse_err=lse_err, **times, bound_ms=b_ms, bound_by=b_by)


def bwd_cases(torch, fa, fab, ref, gen):
    """The backward at phase 21's shape (gpt2_base's training batch: B=8,
    S=256, 16 heads of 64, fp32, causal: the main path), vit_large's
    non-causal fp16 prefill (B=2, S=197), a windowed GQA case (yi_9b's
    G = 4 at head_dim 128, window 64, fp32), qwen3_moe's G = 8 head_dim
    128 fp16 (B=1 S=32) and minicpm3's MLA heads (q / k 96, v 64, B=1
    S=32 H=40) in fp32 and bf16."""
    f16, bf16 = torch.float16, torch.bfloat16
    return [
        bwd_case(torch, fa, fab, ref, gen, "main path gpt2_base train B=8 "
                 "S=256 H=16 dh=64 causal float32", 8, 256, 16, 1, 64),
        bwd_case(torch, fa, fab, ref, gen, "vit_large B=2 S=197 H=16 dh=64 "
                 "non-causal float16", 2, 197, 16, 1, 64, causal=False,
                 dtype=f16),
        bwd_case(torch, fa, fab, ref, gen, "windowed GQA B=2 S=256 KV=4 G=4 "
                 "dh=128 window=64 float32", 2, 256, 4, 4, 128, window=64),
        bwd_case(torch, fa, fab, ref, gen, "qwen3_moe B=1 S=32 KV=4 G=8 "
                 "dh=128 causal float16", 1, 32, 4, 8, 128, dtype=f16),
        bwd_case(torch, fa, fab, ref, gen, "minicpm3 B=1 S=32 H=40 qk=96 "
                 "v=64 causal float32", 1, 32, 40, 1, 96, dv=64),
        bwd_case(torch, fa, fab, ref, gen, "minicpm3 B=1 S=32 H=40 qk=96 "
                 "v=64 causal bfloat16", 1, 32, 40, 1, 96, dv=64,
                 dtype=bf16)]


def heads_case(torch, ref, gen, m, bits, trans, dtype):
    """The batched quantized_matmul (MLA's absorbed decode products, all
    40 heads in one launch) at minicpm3_4b's widths against its plain
    version: W_uk's transposed absorption (per head 64 -> 256) or W_uv's
    un-absorption (256 -> 64).  Library: ``torch.bmm`` on the per-head
    weights dequantized beforehand (not timed).  Bound: bytes of x, the
    quantized weight, the scales and the output, or 2 M H K N flops."""
    from repro_torch.kernels import quant_matmul as qm
    dev = "cuda"
    h, k, n = (40, 64, 256) if trans else (40, 256, 64)
    logical = n if trans else k
    rows = logical if bits == 8 else (logical + 1) // 2
    cols = h * (k if trans else n)
    if bits == 8:
        w_q = torch.randint(-127, 128, (rows, cols), generator=gen,
                            device=dev, dtype=torch.int8)
    else:
        w_q = torch.randint(0, 256, (rows, cols), generator=gen, device=dev,
                            dtype=torch.uint8)
    scale = torch.rand((cols,), generator=gen, device=dev) / 64
    x = torch.randn((m, h, k), generator=gen, device=dev).to(dtype)
    run = lambda: qm.quant_matmul_batched(x, w_q, scale, bits,  # noqa: E731
                                          n, trans)
    plain = lambda: ref.quant_matmul_batched_ref(  # noqa: E731
        x, w_q, scale, n, bits=bits, trans=trans)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err, limit = error(got, want)
    w = ref.dequant_ref(w_q, scale, bits=bits)[:logical]
    w_h = (w.reshape(n, h, k).permute(1, 2, 0) if trans
           else w.reshape(k, h, n).transpose(0, 1)).to(dtype).contiguous()
    xt = x.transpose(0, 1).contiguous()
    lib = lambda: torch.bmm(xt, w_h)  # noqa: E731
    dev_ms, per_call, names = device_ms(torch, run)
    nbytes = (x.element_size() * (x.numel() + m * h * n) + 4 * cols
              + w_q.numel())
    b_ms, b_by = bound(nbytes, 2 * m * h * k * n, dtype_name(x))
    what = "W_uk" if trans else "W_uv"
    return dict(kernel="quantized_matmul", bits=bits, kind="heads",
                dtype=dtype_name(x), case=f"mla absorb {what} M={m} H={h} "
                f"K={k} N={n} int{bits} {dtype_name(x)}",
                max_abs_err=err, limit=limit, ms=time_ms(torch, run),
                device_ms=dev_ms, kernels_per_call=per_call,
                kernel_names=names, plain_ms=time_ms(torch, plain),
                library_ms=time_ms(torch, lib),
                library_device_ms=device_ms(torch, lib)[0], bound_ms=b_ms,
                bound_by=b_by)


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


def moe_cases(torch, fd, fa, ref, gen):
    """Phase 16's attention shapes: GQA with 32 query heads on 4 KV heads
    (G=8) at head_dim 128; a 32-token prefill per request, and the decode
    batch of 2 rows against 40-slot caches."""
    cases = []
    for name in ("float32", "float16", "bfloat16"):
        cases.append(attention_case(
            torch, fa, ref, gen, f"qwen3_moe prefill B=1 S=32 H=32 KV=4 "
            f"dh=128 causal {name}", 1, 32, 4, 8, 128,
            dtype=getattr(torch, name)))
    for name in ("float32", "float16"):
        cases.append(decode_case(
            torch, fd, ref, gen, f"qwen3_moe decode B=2 S=40 KV=4 G=8 "
            f"dh=128 {name}", 2, 40, 4, 8, 128, dtype=getattr(torch, name)))
    return cases


def mla_vlm_cases(torch, fd, fa, ref, gen):
    """Phases 18-19's attention shapes.  MLA (minicpm3_4b): the per-request
    prefill of 32 tokens at 40 heads, q / k 96 and v 64, and the latent
    decode of the 2-row batch against 40-slot caches, in fp32 and fp16.
    VLM (qwen2_vl_2b, G = 6 query heads on 2 KV heads of 128, fp16): the
    per-request prefill of 64 tokens, the decode of 4 rows of up to 72
    slots, and the paged decode through tables of 5 pages of 16 with the
    48-token shared prompt's 3 pages mapped by every row."""
    cases = []
    for name in ("float32", "float16"):
        dt = getattr(torch, name)
        cases += [
            attention_case(torch, fa, ref, gen, f"minicpm3 prefill B=1 S=32 "
                           f"H=40 qk=96 v=64 causal {name}", 1, 32, 40, 1,
                           96, dv=64, dtype=dt),
            latent_case(torch, fd, ref, gen, f"minicpm3 latent decode B=2 "
                        f"S=40 G=40 qk=288 v=256 {name}", 2, 40, 40,
                        [40, 36], dtype=dt)]
    f16 = torch.float16
    return cases + [
        attention_case(torch, fa, ref, gen, "qwen2_vl prefill B=1 S=64 KV=2 "
                       "G=6 dh=128 causal float16", 1, 64, 2, 6, 128,
                       dtype=f16),
        decode_case(torch, fd, ref, gen, "qwen2_vl decode B=4 S=72 KV=2 G=6 "
                    "dh=128 float16", 4, 72, 2, 6, 128,
                    lengths=[72, 70, 68, 65], dtype=f16),
        paged_case(torch, ref, gen, "qwen2_vl paged B=4 KV=2 G=6 dh=128 "
                   "page=16 NB=5, 3 shared pages float16", 4, None, 2, 6, 128,
                   16, 5, [65, 68, 70, 72], shared=3, dtype=f16)]


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
    lib_dev = device_ms(torch, lambda: torch.matmul(x, w))[0]
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
            library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by))
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
    from repro_torch.kernels import flash_attention_bwd as fab
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
    cases += moe_cases(torch, fd, fa, ref, gen)
    cases += mla_vlm_cases(torch, fd, fa, ref, gen)
    # phase 20's absorbed products (the 2 rows in flight, fp16 activations)
    cases += [heads_case(torch, ref, gen, MLA["max_inflight"], bits, trans,
                         torch.float16)
              for bits in (8, 4) for trans in (True, False)]
    cases += bwd_cases(torch, fa, fab, ref, gen)
    # phase 17's streamed experts (fp16 activations on int8 / int4 shards)
    cases += [quant_case(torch, ref, gen, *shape, bits, torch.float16)
              for bits in (8, 4) for shape in quant_shapes(moe_config())
              if shape[0] == "expert"]
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
        if "library_device_ms" in c:
            lib = c["library_device_ms"]
            line += (" library_device_ms "
                     + ("not measured" if lib is None else f"{lib:.5f}"))
        print(line, flush=True)
    from repro_torch.kernels import build
    for lib in ("flash_attention_bwd", "quant_matmul_batched"):
        hmma = build.sass_counts(lib, ("HMMA",))["HMMA"]
        print(f"  {lib}: ptxas -v: {build.ptxas_summary(lib)}; sass HMMA "
              f"{hmma}", flush=True)
    bad = [c for c in cases if not c["max_abs_err"] <= c.get("limit", TOL)]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    # one launch per decode call, split or not (the profiler may drop an
    # event, which only lowers the count)
    many = [c for c in cases if c["kernel"] in DECODE_KERNELS
            and (c.get("kernels_per_call") or 0) > 1.0]
    if many:
        fail("a decode call ran more than one kernel: " + "; ".join(
            f"{c['kernel']} {c['case']}: {c['kernels_per_call']} "
            f"{c['kernel_names']}" for c in many))
    return cases


# ---------------------------------------------------------------------------
# phases 3-7: the main paths
# ---------------------------------------------------------------------------
MAIN = dict(requests=8, prompt_len=128, new_tokens=32, max_inflight=4)
# the script's 1200 s are shared by every path: each path serves the first
# wave of 4 requests, and the plain partners of phases 4, 6, 8 and 9 only
# their first PLAIN_NEW_TOKENS new tokens, held to the kernel run's first
PLAIN_NEW_TOKENS = 8
PLAIN = dict(requests=MAIN["max_inflight"], new_tokens=PLAIN_NEW_TOKENS)
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
                            quant: str = "fp32", router_calls=None) -> dict:
    """Launches the serving loop must make: one decode launch
    (flash_decode, or paged_flash_decode in paged mode unless autotune
    chose the "gather" route) per layer per
    round with a decoder in flight; one flash_attention per layer per
    monolithic prefill; with chunked prefill, one paged_flash_verify per
    layer per round with a chunker; on quantized shards, one
    quantized_matmul per linear per pass (decode round, chunk round or
    prefill), the head's included, and for an MoE config three per
    streamed expert: per router call of the loop (``router_calls``,
    ``[(round, layer name, logits, top-k ids)]``, one per layer per pass)
    three times the union of its picks."""
    from repro_torch.kernels import ops
    decode_rounds, chunk_rounds, prefills = serve_rounds(stats, n_chunks)
    n_layers = cfg.num_layers
    want = dict.fromkeys(stats.kernel_launches, 0)
    # autotune's "gather" route decodes paged KV through flash_decode, as
    # MLA's latent pages always do
    paged = (stats.page_size and cfg.attention != "mla"
             and ops.tuned_paged_impl() != "gather")
    want["paged_flash_decode" if paged else "flash_decode"] = (
        n_layers * len(decode_rounds))
    want["flash_attention"] = n_layers * prefills
    want["paged_flash_verify"] = n_layers * len(chunk_rounds)
    if quant != "fp32":
        passes = len(decode_rounds) + len(chunk_rounds) + prefills
        want["quantized_matmul"] = linears_per_pass(cfg) * passes
        if cfg.family == "moe":
            if len(router_calls) != n_layers * passes:
                fail(f"{len(router_calls)} router calls in the serving loop "
                     f"against {n_layers} layers x {passes} passes")
            per_expert = sum(c for kind, *_, c in quant_shapes(cfg)
                             if kind == "expert")
            want["quantized_matmul"] += per_expert * sum(
                len(ids.unique()) for *_, ids in router_calls)
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
    split = (f"time split: wall {stats.latency_s:.3f}s over {stats.rounds} "
             f"rounds; shard loads {load:.3f}s summed over agents; layer "
             f"compute {comp:.3f}s")
    path = ckpt_dir(cfg, quant) / "profile_torch_cuda.json"
    if not path.exists():           # a fixed schedule plans nothing
        return split
    prof = json.loads(path.read_text())
    return (f"{split}; profile per layer t_load "
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
             quant: str = "fp32", budget_mb: float = BUDGET_MB,
             router_calls=None, **kw):
    """Serve one main path with every launch count set to 0 just before
    and read just after; check the serving loop's launches exactly and
    the outputs' shape (an MoE path on quantized shards derives its
    expert launches from ``router_calls()``, the loop's router calls).
    Returns (outs, stats, serve.run launches)."""
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
        limit = stats.peak_bytes + ALLOC_SLACK
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
    want = expected_serve_launches(
        stats, cfg, n_chunks, quant,
        router_calls() if router_calls is not None else None)
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


def scale_routers(params) -> None:
    """Phase 16's router scale, applied to the numpy params before they
    are written."""
    import numpy as np
    params["layers"]["moe"]["router"] *= np.float32(MOE_ROUTER_SCALE)


def checkpoints():
    """Every checkpoint the serving phases read: [(label, cfg, seed,
    transform of the numpy params before they are written, or None)]."""
    from repro_torch.configs import get
    main = get("gpt2_base")
    return [("gpt2_base", main, 0, None),
            ("gpt_j", get("gpt_j").with_(num_layers=GPTJ_LAYERS,
                                         name=f"gpt-j-{GPTJ_LAYERS}layers"),
             0, None),
            ("vit_large", get("vit_large"), 0, None),
            ("spec draft", main.with_(
                num_layers=SPEC["draft_layers"],
                name=f"{main.name}-{SPEC['draft_layers']}layers-draft"), 1,
             None),
            ("self-draft", main.with_(num_layers=SELF["layers"],
                                      name=f"gpt2-base-{SELF['layers']}layers"),
             0, None),
            ("qwen3_moe", get("qwen3_moe_30b_a3b").with_(
                num_layers=MOE_LAYERS, dtype="float16",
                name=f"qwen3-moe-30b-a3b-{MOE_LAYERS}layers-fp16"), 0,
             scale_routers),
            ("minicpm3", get("minicpm3_4b").with_(
                num_layers=MLA_LAYERS, dtype="float16",
                name=f"minicpm3-4b-{MLA_LAYERS}layers-fp16"), 0, None),
            ("qwen2_vl", get("qwen2_vl_2b").with_(
                num_layers=VLM_LAYERS, dtype="float16",
                name=f"qwen2-vl-2b-{VLM_LAYERS}layers-fp16"), 0, None)]


def moe_config():
    """Phases 16-17's model: qwen3_moe_30b_a3b cut to MOE_LAYERS, fp16."""
    return next(c for name, c, *_ in checkpoints() if name == "qwen3_moe")


def checkpoint(label: str):
    """(cfg, path) of the checkpoint ``label``, written from its seed if
    missing (an MoE one expert-split, as ``partition_and_save`` does by
    default)."""
    import numpy as np
    from repro_torch.checkpoint import partition_and_save
    from repro_torch.models.dense_lm import init_params
    cfg, seed, transform = next((c, s, t) for name, c, s, t in checkpoints()
                                if name == label)
    path = ckpt_dir(cfg)
    if not (path / "manifest.json").exists():
        params = init_params(np.random.default_rng(seed), cfg)
        if transform is not None:
            transform(params)
        partition_and_save(params, cfg, path)
    return cfg, path


# the largest checkpoint (3.75 GB) and its int8 transcode, and phases
# 18-19's (2.6 GB), each group written in a thread of its own beside the
# rest: numpy releases the GIL in its generators, array arithmetic and
# file writes
PARALLEL_CHECKPOINTS = (("qwen3_moe",), ("minicpm3", "qwen2_vl"))


def write_checkpoints() -> str:
    """Write every serving checkpoint, the int8 / int4 transcodes of
    phase 3's and the int8 transcode of phase 16's, numpy on the host:
    ``main`` runs this while nvcc builds the kernels.  Returns the seconds
    each took."""
    from repro_torch.checkpoint.partition import ensure_quantized
    took, errors = [], []

    def write(label: str) -> None:
        t0 = time.perf_counter()
        cfg, path = checkpoint(label)
        took.append(f"{label} {time.perf_counter() - t0:.1f}s")
        quants = {"gpt2_base": ("int8", "int4"),
                  "qwen3_moe": (MOE_QUANT,),
                  "minicpm3": (MLA_QUANT,)}.get(label, ())
        for quant in quants:
            t0 = time.perf_counter()
            ensure_quantized(path, ckpt_dir(cfg, quant), quant)
            took.append(f"{label} {quant} {time.perf_counter() - t0:.1f}s")

    def write_parallel(labels) -> None:
        try:
            for label in labels:
                write(label)
        except BaseException as exc:      # noqa: BLE001 (re-raised below)
            errors.append(exc)

    writers = [threading.Thread(target=write_parallel, args=(group,))
               for group in PARALLEL_CHECKPOINTS]
    for w in writers:
        w.start()
    apart = {label for group in PARALLEL_CHECKPOINTS for label in group}
    try:
        for label, *_ in checkpoints():
            if label not in apart:
                write(label)
    finally:
        for w in writers:
            w.join()
    if errors:
        raise errors[0]
    return ", ".join(took)


def phase_main(torch, ops):
    """Phases 3-4: the dense path, kernels then plain versions."""
    cfg, _ = checkpoint("gpt2_base")
    print(f"checkpoint: {cfg.num_layers} layers, d={cfg.d_model}",
          flush=True)
    # profile anew on every run, so the schedule and the launch counts do
    # not depend on an earlier run; the later phases reuse it
    (CKPT_ROOT / cfg.name / "profile_torch_cuda.json").unlink(missing_ok=True)
    # the first wave of 4 requests: the script's time limit is shared by
    # every path
    outs, stats, launches = run_path(torch, ops, cfg, "dense", "auto",
                                     requests=MAIN["max_inflight"])
    if not (launches["flash_decode"] and launches["flash_attention"]):
        fail(f"a kernel of the dense path never launched: {launches}")
    if launches["quantized_matmul"]:
        fail(f"fp32 shards launched quantized_matmul: {launches}")
    outs_plain, _, _ = run_path(torch, ops, cfg, "dense", None, **PLAIN)
    same_tokens(torch, cfg, outs, outs_plain, "dense kernel vs plain "
                "greedy tokens", n=MAIN["prompt_len"] + PLAIN_NEW_TOKENS)
    return cfg, launches, stats


def phase_paged(torch, ops, cfg, dense_stats):
    """Phases 5-6: paged KV with prefix sharing, kernels then plain."""
    # the first wave only, as in the dense phase
    outs, stats, launches = run_path(torch, ops, cfg, "paged", "auto",
                                     **dict(PAGED,
                                            requests=MAIN["max_inflight"]))
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
    outs_plain, _, _ = run_path(torch, ops, cfg, "paged", None,
                                **dict(PAGED, **PLAIN))
    same_tokens(torch, cfg, outs, outs_plain, "paged kernel vs plain "
                "greedy tokens", n=MAIN["prompt_len"] + PLAIN_NEW_TOKENS)
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
                                     quant=quant, budget_mb=budget_mb,
                                     requests=MAIN["max_inflight"])
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
                                budget_mb=budget_mb, **PLAIN)
    same_tokens(torch, cfg, outs, outs_plain, f"{quant} kernel vs plain "
                "greedy tokens", n=MAIN["prompt_len"] + PLAIN_NEW_TOKENS,
                quant=quant)
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
    for key in ("device_ms", "library_device_ms"):
        row[key] = (None if any(c[key] is None for c in mains)
                    else mean(key))
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
    the plain versions on their first GPTJ_PLAIN_NEW_TOKENS new tokens;
    tokens by the tie rule)."""
    from repro_torch.checkpoint import load_manifest
    cfg, path = checkpoint("gpt_j")
    man = load_manifest(path)
    print(f"gpt_j: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.head_dim} heads, d_ff {cfg.d_ff}, "
          f"{cfg.dtype}; {man['total_bytes']} B of shards (layers "
          f"{man['layer_bytes']}); budget {GPTJ_BUDGET_MB} MiB", flush=True)
    if GPTJ_BUDGET_MB * 2**20 >= man["total_bytes"]:
        fail("gpt_j: the budget must sit below the checkpoint")
    (path / "profile_torch_cuda.json").unlink(missing_ok=True)
    kw = dict(GPTJ, arch=cfg, budget_mb=GPTJ_BUDGET_MB)
    outs, stats, launches = run_path(torch, ops, cfg, "gpt_j", "auto", **kw)
    if not (launches["flash_decode"] and launches["flash_attention"]):
        fail(f"gpt_j: a kernel never launched: {launches}")
    if stats.loads <= len(man["shards"]):
        fail(f"gpt_j: {stats.loads} shard loads: layers did not stream")
    outs_plain, _, _ = run_path(torch, ops, cfg, "gpt_j", None,
                                **dict(kw, new_tokens=GPTJ_PLAIN_NEW_TOKENS))
    same_tokens(torch, cfg, outs, outs_plain, "gpt_j kernel vs plain "
                "greedy tokens",
                n=GPTJ["prompt_len"] + GPTJ_PLAIN_NEW_TOKENS)
    return launches, stats


def phase_vit(torch, ops):
    """Phase 12: vit_large at full size (24 fp16 layers, non-causal)
    through ``PipeloadEngine.run_single``, kernels then plain versions:
    flash_attention once per layer, logits within HALF_RTOL["float16"] of
    the plain run's largest and the same argmax."""
    import numpy as np
    from repro_torch.core import PipeloadEngine
    cfg, path = checkpoint("vit_large")
    print(f"vit_large: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.dtype}, causal={cfg.causal}", flush=True)
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
# phases 13-14: speculative serving
# ---------------------------------------------------------------------------
def count_draft_steps() -> None:
    """Count ``DraftModel.decode_batch`` calls in ``DRAFT_STEPS``: each
    launches flash_decode once per draft layer, so the serving loop's
    flash_decode launches follow from them.  The count lives here, not in
    the package."""
    from repro_torch.core.engine import DraftModel
    decode_batch = DraftModel.decode_batch

    def counted(self, *a, **kw):
        DRAFT_STEPS[0] += 1
        return decode_batch(self, *a, **kw)

    DraftModel.decode_batch = counted


def paged_prompts(cfg):
    """Phase 5's first 4 prompts, drawn as ``serve.run`` draws them."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (MAIN["requests"], MAIN["prompt_len"]))
    prompts[:, :PAGED["shared_prefix"]] = prompts[0, :PAGED["shared_prefix"]]
    return prompts[:SPEC["requests"]]


def serve_spec(torch, ops, cfg, label: str, budget_mb: float, draft=None,
               new_tokens: int = MAIN["new_tokens"], schedule=None,
               acceptance: float = 0.8):
    """Serve phase 5's first 4 requests at page size 16, with ``draft`` at
    depth SPEC_W - 1 or without one, the launch counts set to 0 just
    before and read just after: through ``Hermes.scheduler`` (the planner
    models the draft at ``acceptance``), or with ``schedule`` = (agents,
    pin) fixed, as ``serve --num-agents --pin-window --spec-depth`` fixes
    it, through ``Hermes.engine`` and ``BatchScheduler``.  Checks the
    ledger peak against the budget, the allocator peak (warm-up and
    serving loop, each printed with the bytes the process held before the
    session) against the budget plus the pool's bytes, the drained pool
    and, with a draft, the speculative loop's launches exactly.  Returns
    (outs, stats, serve launches, wall seconds)."""
    from repro_torch.core import BatchScheduler, Hermes
    budget = int(budget_mb * 2**20)
    total = MAIN["prompt_len"] + new_tokens
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launches()
    t0 = time.perf_counter()
    hermes = Hermes(ckpt_dir(cfg), cfg, device="cuda")
    depth = SPEC_W - 1 if draft is not None else 0
    if schedule is None:
        sched = hermes.scheduler(
            budget_bytes=budget, max_inflight=MAIN["max_inflight"],
            prompt_len=MAIN["prompt_len"], new_tokens=new_tokens,
            page_sizes=(PAGED["page_size"],),
            shared_prefix_len=PAGED["shared_prefix"], draft=draft,
            spec_depth=depth or None, draft_acceptance=acceptance)
    else:
        eng = hermes.engine(budget_bytes=budget, num_agents=schedule[0],
                            pin_window=schedule[1],
                            page_size=PAGED["page_size"])
        sched = BatchScheduler(eng, max_inflight=MAIN["max_inflight"],
                               max_total_len=total, draft=draft,
                               spec_depth=depth)
    try:
        sched.warmup(prompt_lens=[MAIN["prompt_len"]])
        torch.cuda.synchronize()
        warm_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = sched.engine
        print(f"{label}: {'fixed' if schedule else 'planned'} {eng.m} "
              f"agents, pin {eng.pin}, inflight {sched.max_inflight}, page "
              f"size {sched.page_size}, spec depth {sched.spec_depth}",
              flush=True)
        for p in paged_prompts(cfg):
            sched.submit(p, new_tokens)
        steps0 = DRAFT_STEPS[0]
        outs, stats = sched.run()
        steps = DRAFT_STEPS[0] - steps0
        mapped = sched.pool.mapped_pages
    finally:
        sched.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    loop_peak = torch.cuda.max_memory_allocated()
    alloc_peak = max(warm_peak, loop_peak)
    check_outputs(outs, cfg.padded_vocab, SPEC["requests"], total)
    if stats.page_size != PAGED["page_size"]:
        fail(f"{label}: the planner served page size {stats.page_size}")
    if stats.peak_bytes > budget:
        fail(f"{label}: ledger peak {stats.peak_bytes} above the budget")
    if mapped:
        fail(f"{label}: {mapped} pages still mapped after the run")
    limit = budget + stats.cache_bytes_peak
    what = "the budget plus the paged pool's bytes"
    print(f"{label}: torch.cuda.max_memory_allocated: warm-up {warm_peak}, "
          f"serving loop {loop_peak}; {held} B held by the process before "
          f"the session", flush=True)
    if alloc_peak > limit:
        OVER_BUDGET.append(f"{label}: torch.cuda.max_memory_allocated "
                           f"{alloc_peak} above {limit} ({what})")
    want = dict.fromkeys(stats.kernel_launches, 0)
    if draft is not None:
        if stats.spec_depth != SPEC_W - 1:
            fail(f"{label}: served spec depth {stats.spec_depth}, not "
                 f"{depth}")
        admits = sum(1 for kind, *_ in stats.policy if kind == "admit")
        want["paged_flash_verify"] = cfg.num_layers * stats.spec_rounds
        want["flash_attention"] = (cfg.num_layers
                                   + draft.cfg.num_layers) * admits
        want["flash_decode"] = draft.cfg.num_layers * steps
        print(f"{label}: draft {draft.cfg.num_layers} layers, "
              f"{draft.total_bytes} B of shards; {steps} stacked draft "
              f"steps; spec_rounds {stats.spec_rounds}, draft_tokens "
              f"{stats.draft_tokens}, accepted_tokens "
              f"{stats.accepted_tokens} (acceptance "
              f"{stats.acceptance_rate:.4f})", flush=True)
    else:
        want["paged_flash_decode"] = cfg.num_layers * len(
            serve_rounds(stats)[0])
        want["flash_attention"] = cfg.num_layers * serve_rounds(stats)[2]
    print(f"{label}: kernel launches: whole phase {json.dumps(launches)} "
          f"(warm-up and profiling included); serving loop "
          f"{json.dumps(stats.kernel_launches)}, expected "
          f"{json.dumps(want)}", flush=True)
    if stats.kernel_launches != want:
        fail(f"{label}: serving-loop launches {stats.kernel_launches} != "
             f"{want}")
    print(f"{label}: rounds {stats.rounds}, {stats.tokens_per_s:.3f} tok/s "
          f"aggregate, serving loop {stats.latency_s:.3f}s, phase "
          f"{wall:.1f}s; ledger peak {stats.peak_bytes} B (budget {budget}),"
          f" breakdown {json.dumps(stats.peak_breakdown)}, "
          f"torch.cuda.max_memory_allocated {alloc_peak} (limit {limit}: "
          f"{what}), "
          f"pages allocated {stats.pages_allocated}, prefix hit pages "
          f"{stats.prefix_hit_pages}, cow copies {stats.cow_copies}, "
          f"preemptions {stats.preemptions}, pool peak "
          f"{stats.pool_pages_peak} pages", flush=True)
    print(f"{label}: {time_split(stats, cfg)}", flush=True)
    return outs, stats, launches, wall


def phase_spec(torch, ops, cfg, paged_outs):
    """Phase 13: speculative serving of phase 5's first 4 requests on the
    full-width checkpoint with a weak full-width 2-layer draft (its own
    checkpoint, numpy seed 1) at depth 4 through ``Hermes.scheduler``,
    under a budget below target plus draft: tokens equal phase 5's (tie
    rule), launches exact, the ledger's draft share equal to the draft's
    manifest bytes.  The planner is told to expect SPEC["acceptance"];
    its pick at the facade's default 0.8 is printed beside it."""
    from repro_torch.checkpoint import load_manifest
    from repro_torch.core import Hermes
    from repro_torch.core.engine import DraftModel
    from repro_torch.core.hermes import spec_plan_kw
    dcfg, dpath = checkpoint("spec draft")
    dman = load_manifest(dpath)
    target = load_manifest(ckpt_dir(cfg))["total_bytes"]
    print(f"spec: draft {dcfg.num_layers} layers, d={dcfg.d_model}, vocab "
          f"{dcfg.vocab_size}; {dman['total_bytes']} B of shards (layers "
          f"{dman['layer_bytes']}); target {target} B; budget "
          f"{SPEC['budget_mb']} MiB", flush=True)
    if SPEC["budget_mb"] * 2**20 >= target + dman["total_bytes"]:
        fail("spec: the budget must sit below target plus draft")
    draft = DraftModel(dpath, dcfg, device="cuda")
    total = MAIN["prompt_len"] + MAIN["new_tokens"]
    for acc in (0.8, SPEC["acceptance"]):
        g = Hermes(ckpt_dir(cfg), cfg, device="cuda").plan_generate(
            [int(SPEC["budget_mb"] * 2**20)], prompt_len=MAIN["prompt_len"],
            new_tokens=MAIN["new_tokens"], max_inflight=MAIN["max_inflight"],
            page_sizes=(PAGED["page_size"],),
            shared_prefix_len=PAGED["shared_prefix"],
            **spec_plan_kw(draft, SPEC_W - 1, total, acc))[0]
        print(f"spec: the planner at acceptance {acc}: depth "
              f"{g.spec_depth}, {g.num_agents} agents, pin {g.pin_window}, "
              f"predicted {g.predicted_throughput_tps:.3f} tok/s", flush=True)
    outs, stats, launches, _ = serve_spec(
        torch, ops, cfg, "spec", SPEC["budget_mb"], draft,
        acceptance=SPEC["acceptance"])
    if stats.peak_breakdown.get("draft") != dman["total_bytes"]:
        fail(f"spec: the ledger peak's draft share "
             f"{stats.peak_breakdown.get('draft')} is not the draft's "
             f"{dman['total_bytes']} manifest bytes")
    if draft.weights is not None:
        fail("spec: the draft's device copies outlived its session")
    same_tokens(torch, cfg, outs, paged_outs, "spec vs paged greedy tokens")
    return launches, stats


def phase_self_draft(torch, ops):
    """Phase 14: the self-draft ceiling.  A full-width gpt2_base cut to 4
    layers (its own checkpoint, numpy seed 0) serves phase 5's first 4
    requests twice under one budget below target plus draft, without a
    draft and with itself as the draft at depth 4: the tokens must agree
    (tie rule), acceptance must be 1.0 but for rejections at ties of the
    model's own top-2 gap, and multi-token commits must leave fewer verify
    rounds than the plain run's decode rounds.  No speed-up is claimed."""
    from repro_torch.checkpoint import load_manifest
    from repro_torch.core import BatchScheduler
    from repro_torch.core.engine import DraftModel
    cfg, path = checkpoint("self-draft")
    total = load_manifest(path)["total_bytes"]
    print(f"self-draft: {cfg.num_layers} layers, {total} B of shards; "
          f"budget {SELF['budget_mb']} MiB", flush=True)
    if SELF["budget_mb"] * 2**20 >= 2 * total:
        fail("self-draft: the budget must sit below target plus draft")
    new = SELF["new_tokens"]
    plain, pst, _, pwall = serve_spec(torch, ops, cfg, "self-draft plain",
                                      SELF["budget_mb"], new_tokens=new)
    # each round's proposals, beside what the requests held before it
    rounds = []
    propose = BatchScheduler._draft_propose

    def recorded(self):
        props = propose(self)
        rounds.append([(r.rid, len(r.tokens), r.max_new_tokens - r.generated,
                        p) for r, p in zip(self.inflight, props)])
        return props

    BatchScheduler._draft_propose = recorded
    try:
        outs, st, launches, wall = serve_spec(
            torch, ops, cfg, "self-draft spec", SELF["budget_mb"],
            DraftModel(path, cfg, device="cuda"), new_tokens=new,
            schedule=SELF["schedule"])
    finally:
        BatchScheduler._draft_propose = propose
    same_tokens(torch, cfg, outs, plain, "self-draft spec vs plain greedy "
                "tokens")
    # a rejection: the first proposal that is not the committed token,
    # inside the request's remaining allowance
    rejected = []
    for rows in rounds:
        for rid, n, remaining, props in rows:
            toks = list(outs[rid])
            for j, t in enumerate(props[:remaining]):
                if t != toks[n + j]:
                    rejected.append((rid, n + j))
                    break
    for rid, at in rejected:
        gap, limit = tie_gap(torch, cfg, list(outs[rid])[:at])
        print(f"self-draft: req{rid} proposal rejected at token {at}; "
              f"top-2 logit gap there {gap:.3e} (tie below {limit:.3e})",
              flush=True)
        if gap >= limit:
            fail(f"self-draft: req{rid}'s proposal rejected at token {at} "
                 f"outside a tie (gap {gap:.3e})")
    if (st.acceptance_rate == 1.0) != (not rejected):
        fail(f"self-draft: acceptance {st.acceptance_rate} against "
             f"{len(rejected)} rejections found")
    plain_rounds = len(serve_rounds(pst)[0])
    print(f"self-draft: acceptance {st.acceptance_rate:.4f} "
          f"({st.accepted_tokens}/{st.draft_tokens}), {len(rejected)} "
          f"rejections at ties; spec rounds {st.spec_rounds} against the "
          f"plain run's {plain_rounds} decode rounds; serving loop "
          f"{st.latency_s:.3f}s against {pst.latency_s:.3f}s (phases "
          f"{wall:.1f}s / {pwall:.1f}s)", flush=True)
    if not st.spec_rounds < plain_rounds:
        fail("self-draft: no multi-token commit on the card")
    return launches, st


# ---------------------------------------------------------------------------
# phase 15: the SLO multi-tenant serving tier
# ---------------------------------------------------------------------------
def tenant_isolation(sched, admitted) -> None:
    """Fail unless, at this round boundary, no physical page is mapped by
    requests of two tenants and no page is indexed by two tenants' prefix
    trees (nor by one tenant's tree while another tenant maps it)."""
    owner = {}
    for r in sched.inflight + admitted:
        for pid in r.table.pages:
            if owner.setdefault(pid, r.tenant) != r.tenant:
                fail(f"slo: page {pid} mapped by tenants {owner[pid]} and "
                     f"{r.tenant} at round {sched.round}")
    held = {}
    for tenant in (sched.tree.tenants if sched.tree is not None else []):
        for pid in sched.tree.tree(tenant)._where:
            if held.setdefault(pid, tenant) != tenant:
                fail(f"slo: page {pid} in the prefix trees of {held[pid]} "
                     f"and {tenant} at round {sched.round}")
            if owner.get(pid, tenant) != tenant:
                fail(f"slo: page {pid} of {tenant}'s prefix tree mapped by "
                     f"{owner[pid]} at round {sched.round}")


def slo_serve_rounds(policy, lengths: dict, chunk: int):
    """(decode rounds, chunk rounds, monolithic prefills) of an SLO serving
    loop, from its policy log and each request's prompt length: an
    admission of L tokens (its prompt and the tokens it generated before a
    preemption) feeds ceil(L / C) chunk rounds from its admission round
    when L > C, else one monolithic prefill in that round, and either way
    samples a token in the last of them; it then decodes one token per
    round through its retirement round, or until the boundary that
    preempts it (a preemption mid-chunk ends the chunk rounds there)."""
    decode, chunks, prefills = set(), set(), 0
    gen = dict.fromkeys(lengths, 0)
    live = {}                     # rid -> (admission round, chunk rounds)
    for kind, rid, r, _ in policy:
        if kind == "admit":
            n = lengths[rid] + gen[rid]
            k = -(-n // chunk) if chunk and n > chunk else 0
            prefills += not k
            live[rid] = (r, k)
            continue
        if kind not in ("preempt", "retire"):
            continue
        a, k = live.pop(rid)
        end = r if kind == "preempt" else r + 1   # rounds it took part in
        chunks.update(range(a, min(a + k, end)))
        first = a + max(k, 1)                     # its first decode round
        if first - 1 < end:                       # its first token landed
            gen[rid] += 1 + max(0, end - first)
            decode.update(range(first, end))
    return decode, chunks, prefills


def phase_slo(torch, ops, cfg):
    """Phase 15: the SLO multi-tenant tier through ``serve.run`` on phase
    3's checkpoint, then the same trace through the plain versions on the
    kernel run's schedule fixed through ``Hermes.engine`` and
    ``BatchScheduler``.  Checks: a priority preemption in the round a
    higher class is admitted, a shed request and one that meets its TTFT
    target; tenant isolation at every round boundary of both runs, prefix
    hits within a tenant; the same policy sequence and the same tokens
    (tie rule) from the plain partner; the serving loop's launches exact;
    the ledger peak within the budget less cuBLAS's workspace and the
    allocator peak within the budget plus the pool's bytes."""
    from repro_torch.core import BatchScheduler, Hermes
    from repro_torch.core.engine import blas_workspace_bytes
    from repro_torch.launch import serve as serve_mod
    budget = int(BUDGET_MB * 2**20)
    path = SLO_PATH
    hermes = Hermes(ckpt_dir(cfg), cfg, device="cuda")
    total = path["prompt_len"] + path["new_tokens"]
    g = hermes.plan_generate(
        [budget], prompt_len=path["prompt_len"], new_tokens=path["new_tokens"],
        max_inflight=path["max_inflight"], page_sizes=(path["page_size"],),
        shared_prefix_len=path["shared_prefix"],
        chunk_prefill=path["chunk_prefill"])[0]
    rl = g.predicted_per_token_s
    ttft_ms = (SLO_TTFT_ROUNDS + 0.5) * rl * 1e3
    print(f"slo: the plan's predicted round latency {rl * 1e3:.3f} ms "
          f"({g.num_agents} agents, pin {g.pin_window}, inflight "
          f"{g.inflight}, page size {g.page_size}); --slo-ttft-ms "
          f"{ttft_ms:.3f} = {SLO_TTFT_ROUNDS + 0.5} rounds of it, shed on; "
          f"trace seed {path['seed']}", flush=True)
    seen = {"sched": None, "boundaries": 0, "trace": None}
    admit, submit_trace = BatchScheduler._admit, serve_mod.submit_trace

    def checked_admit(self):
        admitted = admit(self)
        if seen["sched"] is None:
            seen["sched"] = self
        tenant_isolation(self, admitted)
        seen["boundaries"] += 1
        return admitted

    def recorded_submit(sched, trace, **kw):
        seen["trace"] = list(trace)
        return submit_trace(sched, trace, **kw)

    BatchScheduler._admit = checked_admit
    serve_mod.submit_trace = recorded_submit
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        outs, stats = serve_mod.run(
            "gpt2_base", budget_mb=BUDGET_MB, reduced=False, device="cuda",
            ckpt_root=CKPT_ROOT, attn_impl="auto", slo_ttft_ms=ttft_ms,
            slo_shed=True, **path)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        alloc_peak = torch.cuda.max_memory_allocated()
        sched, trace = seen["sched"], seen["trace"]
        kernel_boundaries = seen["boundaries"]
        slo = sched.slo
        print(f"slo: served {sched.engine.m} agents, pin {sched.engine.pin}, "
              f"inflight {sched.max_inflight}, page size {sched.page_size}, "
              f"chunk {sched.chunk}, SLO {slo}; tenant isolation held at "
              f"{kernel_boundaries} round boundaries", flush=True)
        if (stats.page_size, sched.chunk) != (path["page_size"],
                                              path["chunk_prefill"]):
            fail(f"slo: served page size {stats.page_size}, chunk "
                 f"{sched.chunk}")
        if slo is None or not slo.shed or slo.ttft_rounds is None:
            fail(f"slo: the run served no shedding TTFT target: {slo}")
        # the plain partner: the same trace on the kernel run's schedule
        eng = hermes.engine(budget_bytes=budget, num_agents=sched.engine.m,
                            pin_window=sched.engine.pin, attn_impl=None,
                            page_size=sched.page_size)
        plain = BatchScheduler(eng, max_inflight=sched.max_inflight,
                               max_total_len=sched.max_total_len,
                               seed=path["seed"], chunk_prefill=sched.chunk,
                               slo=slo)
        seen["boundaries"] = 0
        t1 = time.perf_counter()
        try:
            plain.warmup(prompt_lens=[path["prompt_len"]])
            rids = submit_trace(plain, trace)
            pouts, pstats = plain.run()
        finally:
            plain.close()
        pwall = time.perf_counter() - t1
    finally:
        BatchScheduler._admit = admit
        serve_mod.submit_trace = submit_trace
    if rids != {t.rid: t.rid for t in trace}:
        fail("slo: trace ids are not the scheduler's")
    shed = sorted(r for r, q in sched.done.items() if q.rejected)
    met = sorted(r for r, q in sched.done.items() if sched._req_slo(q)[2])
    served = sorted(set(sched.done) - set(shed))
    for t in trace:
        toks = list(outs[t.rid])
        if t.rid in served and (toks[:len(t.prompt)] != t.prompt
                                or len(toks) != len(t.prompt)
                                + t.new_tokens):
            fail(f"slo: req{t.rid} is not its trace request served whole")
    prio = {t.rid: t.priority for t in trace}
    admits = {}
    for kind, rid, r, _ in stats.policy:
        if kind == "admit":
            admits.setdefault(r, []).append(rid)
    bounced = [(rid, r) for kind, rid, r, _ in stats.policy
               if kind == "preempt" and any(prio[a] > prio[rid]
                                            for a in admits.get(r, []))]
    print(f"slo: {len(trace)} requests of tenants "
          f"{sorted({t.tenant for t in trace})}, priorities "
          f"{[t.priority for t in trace]}, prompts "
          f"{[len(t.prompt) for t in trace]}, arrivals "
          f"{[t.arrival_round for t in trace]}", flush=True)
    print(f"slo: rounds {stats.rounds}; ttft p50/p99 "
          f"{stats.ttft_p50_rounds:.1f} / {stats.ttft_p99_rounds:.1f} "
          f"rounds, tpot p50/p99 {stats.tpot_p50_rounds:.3f} / "
          f"{stats.tpot_p99_rounds:.3f} rounds ({stats.ttft_p50_s:.3f} / "
          f"{stats.ttft_p99_s:.3f} s, {stats.tpot_p50_s:.3f} / "
          f"{stats.tpot_p99_s:.3f} s); slo_attained "
          f"{stats.slo_attained:.4f}, goodput_tokens {stats.goodput_tokens} "
          f"of {stats.new_tokens} ({stats.goodput_tokens_per_s:.3f} tok/s), "
          f"slo_rejections {stats.slo_rejections} {shed}, tenants "
          f"{stats.tenants}, preemptions {stats.preemptions} (by a higher "
          f"class admitted in the same round: {bounced}), prefix hit "
          f"pages {stats.prefix_hit_pages} by tenant "
          f"{sched.tree.hits_by_tenant()}, chunk jobs {stats.chunk_jobs}",
          flush=True)
    if not bounced:
        fail("slo: no priority preemption")
    if not shed or not met:
        fail(f"slo: shed {shed}, met its TTFT target {met}: each must be "
             f"non-empty")
    if stats.prefix_hit_pages <= 0:
        fail("slo: no prefix hit within a tenant")
    if [p[:3] for p in pstats.policy] != [p[:3] for p in stats.policy]:
        fail(f"slo: the plain partner's policy differs: "
             f"{[p[:3] for p in pstats.policy]} against "
             f"{[p[:3] for p in stats.policy]}")
    print(f"slo: plain partner: the same {len(stats.policy)} policy "
          f"decisions; tenant isolation held at {seen['boundaries']} round "
          f"boundaries; serving loop {pstats.latency_s:.3f}s, plain run "
          f"{pwall:.1f}s", flush=True)
    same_tokens(torch, cfg, {r: outs[r] for r in served},
                {r: pouts[r] for r in served}, "slo kernel vs plain greedy "
                "tokens")
    decode, chunks, prefills = slo_serve_rounds(
        stats.policy, {t.rid: len(t.prompt) for t in trace}, sched.chunk)
    want = dict.fromkeys(stats.kernel_launches, 0)
    paged = ops.tuned_paged_impl() != "gather"
    want["paged_flash_decode" if paged else "flash_decode"] = (
        cfg.num_layers * len(decode))
    want["paged_flash_verify"] = cfg.num_layers * len(chunks)
    want["flash_attention"] = cfg.num_layers * prefills
    print(f"slo: kernel launches: serve.run {json.dumps(launches)} "
          f"(profiling and warm-up included); serving loop "
          f"{json.dumps(stats.kernel_launches)}, expected {json.dumps(want)} "
          f"({len(decode)} decode rounds, {len(chunks)} chunk rounds, "
          f"{prefills} monolithic prefills)", flush=True)
    if stats.kernel_launches != want:
        fail(f"slo: serving-loop launches {stats.kernel_launches} != {want}")
    ledger_budget = budget - blas_workspace_bytes(torch.device("cuda"))
    limit = budget + stats.cache_bytes_peak
    print(f"slo: {stats.tokens_per_s:.3f} tok/s aggregate, serving loop "
          f"{stats.latency_s:.3f}s, serve.run {wall:.1f}s; ledger peak "
          f"{stats.peak_bytes} B (ledger budget {ledger_budget}), breakdown "
          f"{json.dumps(stats.peak_breakdown)}, kv_pages at the peak "
          f"{stats.peak_breakdown.get('kv_pages', 0)} B, pool peak "
          f"{stats.pool_pages_peak} pages ({stats.cache_bytes_peak} B), "
          f"torch.cuda.max_memory_allocated {alloc_peak} (limit {limit}: "
          f"the budget plus the paged pool's bytes), shard loads "
          f"{stats.loads}", flush=True)
    print(f"slo: {time_split(stats, cfg)}", flush=True)
    if stats.peak_bytes > ledger_budget:
        fail(f"slo: ledger peak {stats.peak_bytes} above the budget less "
             f"cuBLAS's workspace ({ledger_budget})")
    if alloc_peak > limit:
        OVER_BUDGET.append(f"slo: torch.cuda.max_memory_allocated "
                           f"{alloc_peak} above {limit} (the budget plus the "
                           f"paged pool's bytes)")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 16: MoE expert streaming
# ---------------------------------------------------------------------------
def router_picks(torch, cfg, calls, plain_calls, before: float,
                 label: str = "moe"):
    """Hold the kernel run's router calls to the plain run's, call for call
    (``[(round, layer name, fp32 logits, top-k ids)]`` each, in order), up
    to the first call whose top-k picks differ, and over rounds before
    ``before`` only (later rounds read a differing token).  Fails if the
    calls differ in round, layer or shape; if up to the first differing
    pick the logits of layer l (from 0) differ by more than (l + 1) x
    ``HALF_RTOL["float16"]`` of the call's largest |logit| (each fp16
    layer adds its roundings to the residual stream the router reads); or
    if a differing pick sits at a plain top-k margin that twice the row's
    largest logit difference cannot close.  Returns the first differing
    pick as ``{"round", "call", "rows"}``, or None."""
    k = cfg.top_k
    if ([(r, n, t.shape) for r, n, t, _ in calls]
            != [(r, n, t.shape) for r, n, t, _ in plain_calls]):
        fail(f"{label}: the kernel and plain runs made different router "
             f"calls")
    worst, checked, flip = {}, 0, None
    for call, ((rnd, name, got, ids), (_, _, want, plain_ids)) in enumerate(
            zip(calls, plain_calls)):
        if rnd >= before:
            break
        layer = int(name.split("_")[1])
        delta = (got - want).abs()
        rel = (delta.max() / want.abs().max()).item()
        limit = (layer + 1) * HALF_RTOL["float16"]
        worst[layer], checked = max(worst.get(layer, 0.0), rel), checked + 1
        if rel > limit:
            fail(f"{label}: router logits of round {rnd} call {call} ({name}) "
                 f"differ by {rel:.3e} of the largest |logit| (limit "
                 f"{limit:.1e}) before any pick differed")
        ids, plain_ids = ids.sort(-1).values, plain_ids.sort(-1).values
        rows = (ids != plain_ids).any(-1).nonzero().flatten().tolist()
        if not rows:
            continue
        top = torch.topk(want, k + 1, dim=-1).values
        for row in rows:
            margin = (top[row, k - 1] - top[row, k]).item()
            # a swap of the k-th and (k+1)-th logits needs their
            # differences between the runs to sum to the margin
            room = 2 * delta[row].max().item()
            print(f"{label}: router picks differ first at round {rnd} call "
                  f"{call} ({name}) row {row}: kernels {ids[row].tolist()}, "
                  f"plain {plain_ids[row].tolist()}; plain top-{k} margin "
                  f"{margin:.3e}, twice the row's largest logit difference "
                  f"{room:.3e}", flush=True)
            if margin >= room:
                fail(f"{label}: round {rnd} call {call} row {row} picked "
                     f"other experts than the plain run at a margin the "
                     f"logit difference cannot close")
        flip = {"round": rnd, "call": call, "rows": rows}
        break
    picks = (f"differ first at round {flip['round']}" if flip
             else "identical")
    per_layer = ", ".join(f"layer {l} {w:.3e}" for l, w in worst.items())
    print(f"{label}: router logits held to the plain run's at {checked} of "
          f"{len(calls)} calls: largest difference of the call's largest "
          f"|logit| {per_layer} (limit (layer + 1) x "
          f"{HALF_RTOL['float16']}); top-{k} picks {picks}", flush=True)
    return flip


def moe_tokens(torch, cfg, outs, other, policy, prompt_len: int, calls,
               plain_calls, quant: str = "fp32", label: str = "moe") -> str:
    """Fail unless each request's tokens equal ``other``'s, or first differ
    at a tie: of the head's top-2 logits (``tie_gap``), or of the router,
    where ``router_picks`` finds the two runs' expert picks first differ in
    the round that sampled the differing token or an earlier one (an
    expert picked differently there wrote the K/V that round reads)."""
    admitted = {rid: r for kind, rid, r, _ in policy if kind == "admit"}
    first = {}
    for rid in sorted(outs):
        toks, ref_toks = list(outs[rid]), list(other[rid])
        diff = [i for i in range(len(toks)) if toks[i] != ref_toks[i]]
        if diff:
            first[rid] = (diff[0], admitted[rid] + diff[0] - prompt_len)
    flip = router_picks(torch, cfg, calls, plain_calls,
                        min((rnd for _, rnd in first.values()),
                            default=float("inf")) + 1, label)
    for rid, (i, rnd) in first.items():
        gap, limit = tie_gap(torch, cfg, outs[rid][:i], quant)
        picked = flip is not None and flip["round"] <= rnd
        where = (f"from round {flip['round']}" if picked
                 else "in no round up to it")
        print(f"{label}: req{rid} tokens differ first at {i} (round {rnd}); "
              f"plain top-2 logit gap there {gap:.3e} (tie below "
              f"{limit:.3e}); router picks differ {where}", flush=True)
        if gap >= limit and not picked:
            fail(f"{label}: req{rid} greedy tokens differ at step {i}")
    verdict = "differ only at ties" if first else "identical"
    print(f"{label} kernel vs plain greedy tokens: {verdict}", flush=True)
    return verdict


def moe_runs(torch, ops, cfg, label: str, quant: str, budget_mb: float):
    """Serve MOE_PATH on ``cfg``'s ``quant`` checkpoint through
    ``serve.run`` under ``budget_mb``, kernels then plain versions on the
    same plan, recording every router call of each serving loop; check
    what phases 16 and 17 share (run_path's launches and allocator peak,
    every layer streamed and destroyed each round, the expert cache below
    both layers' experts and evicting, the ledger peak within the budget
    less cuBLAS's workspace with an ``expert_cache`` share, expert loads
    equal to the misses, streamed bytes equal to the manifest bytes of
    every load, the telemetry counters over the serving loop equal to the
    stats' hits and misses) and hold the kernel run's router picks and
    tokens to the plain run's (``moe_tokens``).  Returns {impl: (outs,
    stats, serve.run launches, router calls, counters)}."""
    from repro_torch.checkpoint import load_manifest
    from repro_torch.core import telemetry as tele
    from repro_torch.core.engine import blas_workspace_bytes
    from repro_torch.core.expert_stream import ExpertStreamEngine
    from repro_torch.core.scheduler import BatchScheduler
    from repro_torch.models import moe
    path = ckpt_dir(cfg, quant)
    man = load_manifest(path)
    rows = {s["name"]: s for s in man["shards"]}
    ledger_budget = (int(budget_mb * 2**20)
                     - blas_workspace_bytes(torch.device("cuda")))
    (path / "profile_torch_cuda.json").unlink(missing_ok=True)
    # the round a router call serves (None outside the serving loop), the
    # serving loop's router calls [[round, layer name, fp32 logits, top-k
    # ids]] and the telemetry counters' (hits, misses) over it
    seen = {"round": None, "calls": [], "counters": None}
    router_logits, step = moe.router_logits, BatchScheduler.step
    experts, run = ExpertStreamEngine._experts, BatchScheduler.run

    def recorded_logits(router, x_flat):
        logits = router_logits(router, x_flat)
        if seen["round"] is not None:
            seen["calls"].append([seen["round"], None,
                                  logits.detach().cpu(), None])
        return logits

    def recorded_picks(self, layer_name, top_ids):
        # the routed ids the call just made, as the expert engine gets them
        if seen["round"] is not None:
            call = seen["calls"][-1]
            call[1], call[3] = layer_name, top_ids.cpu()
        return experts(self, layer_name, top_ids)

    def tagged_step(self):
        seen["round"] = self.round
        try:
            return step(self)
        finally:
            seen["round"] = None

    def counted_run(self):
        c0 = tele.counter_values("expert.hits", "expert.misses")
        out = run(self)
        c1 = tele.counter_values("expert.hits", "expert.misses")
        seen["counters"] = (c1[0] - c0[0], c1[1] - c0[1])
        return out

    moe.router_logits, BatchScheduler.step = recorded_logits, tagged_step
    ExpertStreamEngine._experts = recorded_picks
    BatchScheduler.run = counted_run
    runs = {}
    try:
        for impl in ("auto", None):
            seen["calls"] = []
            outs, stats, launches = run_path(
                torch, ops, cfg, label, impl, quant=quant, arch=cfg,
                budget_mb=budget_mb, router_calls=lambda: seen["calls"],
                **MOE_PATH)
            runs[impl] = (outs, stats, launches, seen["calls"],
                          seen["counters"])
    finally:
        moe.router_logits, BatchScheduler.step = router_logits, step
        ExpertStreamEngine._experts, BatchScheduler.run = experts, run
    for impl, (_, st, _, calls, counters) in runs.items():
        how = "kernels" if impl else "plain"
        loads = [rows[key] for _, kind, key in st.events
                 if kind == "load_end"]
        expert_loads = sum(1 for r in loads if r["kind"] == "expert")
        layer_loads = sum(1 for r in loads if r["kind"] == "layer")
        print(f"{label} ({how}): rounds {st.rounds}, serving loop "
              f"{st.latency_s:.3f}s, {st.tokens_per_s:.3f} tok/s; expert "
              f"hit rate {st.expert_hit_rate:.4f} ({st.expert_hits} hits, "
              f"{st.expert_misses} misses, {st.expert_evictions} evicted), "
              f"unique experts per round {st.unique_experts_per_round:.2f}, "
              f"expert cache {st.expert_cache_bytes} B; loads: "
              f"{expert_loads} experts, {layer_loads} layers, "
              f"{st.streamed_bytes} B streamed; counters (hits, misses) "
              f"{counters}; {len(calls)} router calls", flush=True)
        if st.peak_bytes > ledger_budget:
            fail(f"{label} ({how}): ledger peak {st.peak_bytes} above the "
                 f"budget less cuBLAS's workspace ({ledger_budget})")
        if not st.peak_breakdown.get("expert_cache"):
            fail(f"{label} ({how}): no expert_cache share at the ledger "
                 f"peak: {st.peak_breakdown}")
        if not st.expert_evictions:
            fail(f"{label} ({how}): the expert cache never evicted")
        if st.expert_cache_bytes >= man["expert_total_bytes"]:
            fail(f"{label} ({how}): the cache holds every layer's experts")
        if layer_loads != st.rounds * cfg.num_layers:
            fail(f"{label} ({how}): {layer_loads} layer loads in "
                 f"{st.rounds} rounds: layers were not all streamed and "
                 f"destroyed")
        if expert_loads != st.expert_misses:
            fail(f"{label} ({how}): {expert_loads} expert loads against "
                 f"{st.expert_misses} misses")
        if st.streamed_bytes != sum(r["bytes"] for r in loads):
            fail(f"{label} ({how}): streamed_bytes {st.streamed_bytes} is "
                 f"not the {man['quant'] or man['dtype']} manifest bytes of "
                 f"the loads")
        if counters != (st.expert_hits, st.expert_misses):
            fail(f"{label} ({how}): counters {counters} against "
                 f"{st.expert_hits} hits, {st.expert_misses} misses")
    outs, stats, launches = runs["auto"][:3]
    if not (launches["flash_decode"] and launches["flash_attention"]):
        fail(f"{label}: a kernel never launched: {launches}")
    moe_tokens(torch, cfg, outs, runs[None][0], stats.policy,
               MOE_PATH["prompt_len"], runs["auto"][3], runs[None][3],
               quant, label)
    return runs


def phase_moe(torch, ops):
    """Phase 16: expert-streaming MoE, qwen3_moe_30b_a3b at full width cut
    to MOE_LAYERS layers, fp16, through ``serve.run`` under MOE_BUDGET_MB,
    kernels then plain versions on the same plan (``moe_runs``).  Returns
    the kernel run's (outs, serve.run launches, stats)."""
    from repro_torch.checkpoint import load_manifest
    from repro_torch.core.engine import blas_workspace_bytes
    cfg = moe_config()
    man = load_manifest(checkpoint("qwen3_moe")[1])
    ledger_budget = (int(MOE_BUDGET_MB * 2**20)
                     - blas_workspace_bytes(torch.device("cuda")))
    print(f"moe: {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.head_dim} heads on {cfg.n_kv_heads} KV, "
          f"{cfg.n_experts} experts top-{cfg.top_k} d_ff {cfg.expert_d_ff}, "
          f"{cfg.dtype}; {man['total_bytes']} B of shards (attention+router "
          f"layers {man['layer_bytes']}, experts "
          f"{man['expert_total_bytes']}); budget {MOE_BUDGET_MB} MiB "
          f"(ledger {ledger_budget})", flush=True)
    outs, stats, launches = moe_runs(torch, ops, cfg, "moe", "fp32",
                                     MOE_BUDGET_MB)["auto"][:3]
    return outs, launches, stats


def phase_moe_quant(torch, ops, fp16_outs):
    """Phase 17: phase 16's model on its int8 expert-split transcode
    (``ensure_quantized``, written while nvcc built), through ``serve.run(
    quant="int8")`` under MOE_QUANT_BUDGET_MB, kernels then plain versions
    (``moe_runs``).  Beyond phase 16's checks: the budget's reckoning from
    the int8 manifest (its ledger share holds one streaming layer but not
    two), quantized_matmul's serving-loop launches derived from the
    recorded unions (run_path), no fp32 widening in the kernel run and
    some in the plain run (run_path).  Printed, not checked: the
    per-expert bytes against phase 16's and the requests' tokens that
    equal phase 16's fp16 run's."""
    from repro_torch.checkpoint import load_manifest
    from repro_torch.core.engine import blas_workspace_bytes
    cfg = moe_config()
    man = load_manifest(ckpt_dir(cfg, MOE_QUANT))
    fp16 = load_manifest(ckpt_dir(cfg))
    if not (man["quant"] == MOE_QUANT and man["expert_split"]):
        fail(f"moe {MOE_QUANT}: the transcode is not an {MOE_QUANT} "
             f"expert-split checkpoint")
    kinds = {}
    for row in man["shards"]:
        kinds.setdefault(row["kind"], []).append(row["bytes"])
    outer = sum(kinds["embed"]) + sum(kinds["head"])
    layer = max(kinds["layer"])
    experts = man["expert_total_bytes"] // cfg.num_layers
    kv = (MOE_PATH["max_inflight"] * cfg.num_layers
          * cfg.cache_bytes(1, MOE_PATH["prompt_len"]
                            + MOE_PATH["new_tokens"]))
    one = outer + kv + experts + layer
    ledger_budget = (int(MOE_QUANT_BUDGET_MB * 2**20)
                     - blas_workspace_bytes(torch.device("cuda")))
    print(f"moe {MOE_QUANT}: {man['total_bytes']} B of shards; budget "
          f"{MOE_QUANT_BUDGET_MB} MiB, ledger {ledger_budget} B against "
          f"embed + head {outer} + KV {kv} + one layer's experts {experts} "
          f"+ one streaming layer {layer} = {one} B (two streaming layers "
          f"{one + layer} B)", flush=True)
    if not one < ledger_budget < one + layer:
        fail(f"moe {MOE_QUANT}: the ledger budget must hold one streaming "
             f"layer but not two")
    eb = {m["quant"] or m["dtype"]: max(r["bytes"] for r in m["shards"]
                                        if r["kind"] == "expert")
          for m in (fp16, man)}
    print(f"moe {MOE_QUANT}: per-expert bytes {eb}, fp16 / "
          f"{MOE_QUANT} {eb['float16'] / eb[MOE_QUANT]:.4f}", flush=True)
    runs = moe_runs(torch, ops, cfg, f"moe {MOE_QUANT}", MOE_QUANT,
                    MOE_QUANT_BUDGET_MB)
    outs, stats, launches = runs["auto"][:3]
    same = [rid for rid in sorted(outs)
            if list(outs[rid]) == list(fp16_outs[rid])]
    print(f"moe {MOE_QUANT}: {len(same)} of {len(outs)} requests' tokens "
          f"equal phase 16's fp16 run's (not checked)", flush=True)
    return launches, stats


# ---------------------------------------------------------------------------
# phases 18-19: the MLA and VLM engine families
# ---------------------------------------------------------------------------
def stream_reckoning(torch, label: str, cfg, budget_mb: float, path_kw,
                     quant: str = "fp32"):
    """Print the budget's reckoning from the manifest of ``cfg``'s
    ``quant`` checkpoint and fail unless its ledger share holds the embed,
    head, the path's KV and two streaming layers but not three."""
    from repro_torch.checkpoint import load_manifest
    from repro_torch.core.engine import blas_workspace_bytes
    man = load_manifest(ckpt_dir(cfg, quant))
    kinds = {}
    for row in man["shards"]:
        kinds.setdefault(row["kind"], []).append(row["bytes"])
    outer = sum(kinds["embed"]) + sum(kinds["head"])
    layer = max(kinds["layer"])
    kv = (path_kw["max_inflight"] * cfg.num_layers
          * cfg.cache_bytes(1, path_kw["prompt_len"]
                            + path_kw["new_tokens"]))
    ledger_budget = (int(budget_mb * 2**20)
                     - blas_workspace_bytes(torch.device("cuda")))
    two = outer + kv + 2 * layer
    print(f"{label}: {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.attention}, {cfg.dtype}; "
          f"{man['total_bytes']} B of shards (layers {layer} B each, embed "
          f"{sum(kinds['embed'])}, head {sum(kinds['head'])}); KV "
          f"{cfg.cache_bytes(1, 1)} B per token per layer; budget "
          f"{budget_mb} MiB, ledger {ledger_budget} B against embed + head "
          f"+ KV {kv} + two streaming layers = {two} B (three {two + layer}"
          f" B)", flush=True)
    if not two <= ledger_budget < two + layer:
        fail(f"{label}: the ledger budget must hold two streaming layers "
             f"but not three")
    return man


def serve_prompts(cfg, path_kw):
    """The prompts ``serve.run`` makes for ``path_kw`` at seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (path_kw["requests"],
                                               path_kw["prompt_len"]))
    shared = path_kw.get("shared_prefix", 0)
    if shared:
        prompts[:, :shared] = prompts[0, :shared]
    return prompts


def plan_for(cfg, budget_mb: float, path_kw, page_size: int = 0):
    """The plan ``serve.run`` makes for ``path_kw`` (from the checkpoint's
    cached profile): agents, pin and in-flight count."""
    from repro_torch.core import Hermes
    return Hermes(ckpt_dir(cfg), cfg, device="cuda").plan_generate(
        [int(budget_mb * 2**20)], prompt_len=path_kw["prompt_len"],
        new_tokens=path_kw["new_tokens"],
        max_inflight=path_kw["max_inflight"],
        page_sizes=(page_size,) if page_size else (),
        shared_prefix_len=path_kw.get("shared_prefix", 0))[0]


def fixed_run(torch, ops, cfg, label: str, attn_impl, budget_mb: float,
              plan, path_kw, page_size: int):
    """Serve ``path_kw``'s prompts on ``plan``'s agents, pin and in-flight
    count with the page size fixed, through ``Hermes.engine`` and
    ``BatchScheduler`` (as ``serve.run`` builds them), the launch counts
    set to 0 just before and read just after.  Checks the outputs' shape,
    the ledger peak against the budget, the allocator peak against the
    budget plus the pool's bytes (checked at the end), the drained pool,
    and the serving loop's launches against the policy log's (none for
    the plain versions).  Returns (outs, stats, launches)."""
    from repro_torch.core import BatchScheduler, Hermes
    budget = int(budget_mb * 2**20)
    prompts = serve_prompts(cfg, path_kw)
    total = path_kw["prompt_len"] + path_kw["new_tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    eng = Hermes(ckpt_dir(cfg), cfg, device="cuda").engine(
        budget_bytes=budget, num_agents=plan.num_agents,
        pin_window=plan.pin_window, attn_impl=attn_impl,
        page_size=page_size)
    sched = BatchScheduler(eng, max_inflight=plan.inflight,
                           max_total_len=total)
    try:
        sched.warmup(prompt_lens=[path_kw["prompt_len"]])
        for p in prompts:
            sched.submit(p, path_kw["new_tokens"])
        outs, stats = sched.run()
        mapped = sched.pool.mapped_pages
    finally:
        sched.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    alloc_peak = torch.cuda.max_memory_allocated()
    how = "kernels" if attn_impl else "plain"
    check_outputs(outs, cfg.padded_vocab, len(prompts), total)
    if stats.page_size != page_size:
        fail(f"{label} ({how}): served page size {stats.page_size}")
    if stats.peak_bytes > budget:
        fail(f"{label} ({how}): ledger peak {stats.peak_bytes} above the "
             f"budget")
    if mapped:
        fail(f"{label} ({how}): {mapped} pages still mapped after the run")
    limit = budget + stats.cache_bytes_peak
    if alloc_peak > limit:
        OVER_BUDGET.append(f"{label} ({how}): torch.cuda.max_memory_"
                           f"allocated {alloc_peak} above {limit} (the "
                           f"budget plus the paged pool's bytes)")
    want = (expected_serve_launches(stats, cfg) if attn_impl
            else dict.fromkeys(stats.kernel_launches, 0))
    print(f"{label} ({how}): {plan.num_agents} agents, pin "
          f"{plan.pin_window}, inflight {plan.inflight}, page size "
          f"{stats.page_size} (fixed); kernel launches: whole run "
          f"{json.dumps(launches)}; serving loop "
          f"{json.dumps(stats.kernel_launches)}, expected "
          f"{json.dumps(want)}", flush=True)
    if stats.kernel_launches != want or (attn_impl is None
                                         and any(launches.values())):
        fail(f"{label} ({how}): launches {stats.kernel_launches} != {want}")
    print(f"{label} ({how}): rounds {stats.rounds}, {stats.tokens_per_s:.3f}"
          f" tok/s aggregate, serving loop {stats.latency_s:.3f}s, run "
          f"{wall:.1f}s; ledger peak {stats.peak_bytes} B (budget {budget}),"
          f" breakdown {json.dumps(stats.peak_breakdown)}, "
          f"torch.cuda.max_memory_allocated {alloc_peak} (limit {limit}), "
          f"shard loads {stats.loads}, pages allocated "
          f"{stats.pages_allocated}, prefix hit pages "
          f"{stats.prefix_hit_pages}, pool peak {stats.pool_pages_peak} "
          f"pages", flush=True)
    print(f"{label} ({how}): {time_split(stats, cfg)}", flush=True)
    return outs, stats, launches


def phase_mla(torch, ops):
    """Phase 18: minicpm3_4b (MLA) at full width, MLA_LAYERS deep, fp16,
    through ``serve.run`` under MLA_BUDGET_MB with the kernels, then the
    plain versions on the same plan, then paged at MLA_PAGE with the
    kernels on that plan (``fixed_run``): every run's serving loop
    launches flash_attention once per layer per prefill and flash_decode
    (the latent layout) once per layer per decode round, never a paged
    kernel; layers stream (more loads than layers); the tokens equal the
    dense kernel run's (tie rule).  Returns the kernel runs' summed
    (serve.run launches, serving-loop launches)."""
    cfg, path = checkpoint("minicpm3")
    man = stream_reckoning(torch, "mla", cfg, MLA_BUDGET_MB, MLA)
    (path / "profile_torch_cuda.json").unlink(missing_ok=True)
    kw = dict(MLA, arch=cfg, budget_mb=MLA_BUDGET_MB)
    outs, stats, launches = run_path(torch, ops, cfg, "mla", "auto", **kw)
    if stats.loads <= cfg.num_layers:
        fail(f"mla: {stats.loads} shard loads for {cfg.num_layers} layers: "
             f"layers did not stream")
    if launches["paged_flash_decode"] or launches["paged_flash_verify"]:
        fail(f"mla: a paged kernel launched: {launches}")
    outs_plain, _, _ = run_path(torch, ops, cfg, "mla", None, **kw)
    same_tokens(torch, cfg, outs, outs_plain, "mla kernel vs plain greedy "
                "tokens")
    plan = plan_for(cfg, MLA_BUDGET_MB, MLA)
    p_outs, p_stats, p_launches = fixed_run(
        torch, ops, cfg, "mla paged", "auto", MLA_BUDGET_MB, plan, MLA,
        MLA_PAGE)
    if p_launches["paged_flash_decode"] or p_launches["paged_flash_verify"]:
        fail(f"mla paged: a paged kernel launched: {p_launches}")
    print(f"mla paged: pages allocated {p_stats.pages_allocated}, kv_pages "
          f"at the ledger peak {p_stats.peak_breakdown.get('kv_pages', 0)}"
          f" B (dense {stats.peak_breakdown.get('kv_pages', 0)} B); "
          f"{len(man['shards'])} shards", flush=True)
    same_tokens(torch, cfg, p_outs, outs, "mla paged vs dense greedy "
                "tokens")
    total = {k: launches[k] + p_launches[k] for k in launches}
    serve_total = {k: stats.kernel_launches[k] + p_stats.kernel_launches[k]
                   for k in stats.kernel_launches}
    return total, serve_total


def phase_vlm(torch, ops):
    """Phase 19: qwen2_vl_2b's backbone (VLM) at full width, VLM_LAYERS
    deep, fp16: 4 requests of 64 + 8 tokens with 48 shared prompt tokens,
    paged at VLM_PAGE on the planner's agents, pin and in-flight count
    under VLM_BUDGET_MB (``fixed_run``), kernels then plain versions: the
    serving loop launches flash_attention once per layer per prefill and
    paged_flash_decode (G = 6) once per layer per decode round; the
    prefix tree hits; layers stream; the tokens equal the plain run's (tie
    rule).  Returns the kernel run's (launches, serving-loop launches)."""
    cfg, path = checkpoint("qwen2_vl")
    stream_reckoning(torch, "vlm", cfg, VLM_BUDGET_MB, VLM)
    (path / "profile_torch_cuda.json").unlink(missing_ok=True)
    plan = plan_for(cfg, VLM_BUDGET_MB, VLM, VLM_PAGE)
    print(f"vlm: planned {plan.num_agents} agents, pin {plan.pin_window}, "
          f"inflight {plan.inflight}, page size {plan.page_size} "
          f"(served at {VLM_PAGE})", flush=True)
    runs = {impl: fixed_run(torch, ops, cfg, "vlm", impl, VLM_BUDGET_MB,
                            plan, VLM, VLM_PAGE) for impl in ("auto", None)}
    outs, stats, launches = runs["auto"]
    if stats.prefix_hit_pages <= 0:
        fail("vlm: no prefix hit on the shared prompt")
    if stats.loads <= cfg.num_layers:
        fail(f"vlm: {stats.loads} shard loads for {cfg.num_layers} layers: "
             f"layers did not stream")
    if not (launches["paged_flash_decode"] and launches["flash_attention"]):
        fail(f"vlm: a kernel never launched: {launches}")
    same_tokens(torch, cfg, outs, runs[None][0], "vlm kernel vs plain "
                "greedy tokens")
    return launches, stats.kernel_launches


# ---------------------------------------------------------------------------
# phase 20: MLA on int8 shards; phase 21: training
# ---------------------------------------------------------------------------
def phase_mla_quant(torch, ops):
    """Phase 20: phase 18's model on its int8 transcode (written while nvcc
    built), through ``serve.run(quant="int8")`` under MLA_QUANT_BUDGET_MB
    (reckoned from the int8 manifest: two streaming layers fit, three do
    not), kernels then plain versions (``run_path``: quantized_matmul's
    serving-loop launches exactly, 11 per layer per pass plus the head's,
    of which the decode's two per layer are the batched W_uk / W_uv
    absorption launches; no fp32 widening in the kernel run; its allocator
    peak within the ledger peak + 48 MiB); tokens equal the plain run's
    (tie rule); the last-token logits within INT8_LOGIT_RTOL of the fp16
    checkpoint's largest.  Returns the kernel run's (serve.run launches,
    serving-loop launches)."""
    cfg, _ = checkpoint("minicpm3")
    label = f"mla {MLA_QUANT}"
    man = stream_reckoning(torch, label, cfg, MLA_QUANT_BUDGET_MB, MLA,
                           quant=MLA_QUANT)
    if man["quant"] != MLA_QUANT:
        fail(f"{label}: the transcode is not an {MLA_QUANT} checkpoint")
    kw = dict(MLA, arch=cfg, quant=MLA_QUANT, budget_mb=MLA_QUANT_BUDGET_MB)
    outs, stats, launches = run_path(torch, ops, cfg, label, "auto", **kw)
    if stats.loads <= cfg.num_layers:
        fail(f"{label}: {stats.loads} shard loads for {cfg.num_layers} "
             f"layers: layers did not stream")
    if launches["paged_flash_decode"] or launches["paged_flash_verify"]:
        fail(f"{label}: a paged kernel launched: {launches}")
    decode_rounds, _, prefills = serve_rounds(stats)
    batched = 2 * cfg.num_layers * len(decode_rounds)
    print(f"{label}: quantized_matmul in the serving loop "
          f"{stats.kernel_launches['quantized_matmul']} = "
          f"{linears_per_pass(cfg)} per pass x ({len(decode_rounds)} decode "
          f"rounds + {prefills} prefills), of which {batched} batched "
          f"W_uk / W_uv absorption launches (2 per layer per decode round)",
          flush=True)
    outs_plain, _, _ = run_path(torch, ops, cfg, label, None, **kw)
    same_tokens(torch, cfg, outs, outs_plain, f"{label} kernel vs plain "
                "greedy tokens", quant=MLA_QUANT)
    prompt = serve_prompts(cfg, MLA)[0].tolist()
    fp16 = last_logits(torch, cfg, "fp32", prompt)
    logits = last_logits(torch, cfg, MLA_QUANT, prompt)
    rel = ((logits.float() - fp16.float()).abs().max()
           / fp16.float().abs().max()).item()
    print(f"{label}: last-token logits vs the fp16 checkpoint's: max "
          f"|delta| / max |fp16| = {rel:.5f} (limit {INT8_LOGIT_RTOL})",
          flush=True)
    if not rel <= INT8_LOGIT_RTOL:
        fail(f"{label}: logit error {rel} above {INT8_LOGIT_RTOL}")
    return launches, stats.kernel_launches


def phase_train(torch, ops):
    """Phase 21: ``repro_torch.launch.train``'s path (``train.run``) on
    full gpt2_base, 24 fp32 layers with its config's remat, TRAIN's batch,
    sequence and steps, TF32 off: the kernels, then the plain versions
    from the same seed.  Each step's loss within TRAIN_RTOL of the plain
    run's, and step 1's gradients (one ``api.loss`` backward on the same
    parameters and batch, outside the counted runs) within TRAIN_RTOL of
    each leaf's largest |g|; the kernel run launches flash_attention
    exactly layers x steps x 2 (the forward and remat's recompute) and
    flash_attention_bwd layers x steps, and nothing else; the plain run
    launches nothing.  Prints step ms and the allocator peak beside params
    + grads + two fp32 moments.  Returns the kernel run's launches and
    its numbers."""
    import numpy as np
    from repro_torch.checkpoint.partition import tree_leaves
    from repro_torch.configs import get
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch import train
    from repro_torch.models.api import build_model
    cfg = get("gpt2_base")
    n_layers, steps = cfg.num_layers, TRAIN["steps"]
    batch = {k: v.cuda() for k, v in make_batch(
        cfg, TRAIN["batch"], TRAIN["seq"], seed=0).items()}
    params = build_model(cfg).init(np.random.default_rng(0), "cuda")
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    for p in leaves:
        p.requires_grad_(True)
    grads = {}
    for impl in ("auto", None):
        loss, _ = build_model(cfg, attn_impl=impl).loss(params, batch)
        grads[impl] = torch.autograd.grad(loss, leaves)
    worst = max((gk - gp).abs().max().item()
                / max(gp.abs().max().item(), 1e-30)
                for gk, gp in zip(grads["auto"], grads[None]))
    print(f"train: step 1 gradients, kernels vs plain: worst leaf max "
          f"|delta| / max |g| = {worst:.3e} over {len(leaves)} leaves "
          f"(limit {TRAIN_RTOL})", flush=True)
    if not worst <= TRAIN_RTOL:
        fail(f"train: step 1 gradients differ by {worst} of a leaf's "
             f"largest |g|")
    del params, leaves, grads, loss
    torch.cuda.empty_cache()
    runs = {}
    for impl in ("auto", None):
        how = "kernels" if impl else "plain"
        secs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        losses = train.run(cfg, steps=steps, batch=TRAIN["batch"],
                           seq=TRAIN["seq"], device="cuda", attn_impl=impl,
                           log_every=1, step_seconds=secs)
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        runs[impl] = (losses, launches)
        print(f"train ({how}): losses {losses}; step ms "
              f"{[round(t * 1e3, 3) for t in secs]}; kernel launches "
              f"{json.dumps(launches)}; torch.cuda.max_memory_allocated "
              f"{peak} B against params + grads + two fp32 moments "
              f"{16 * n_params} B ({n_params} params)", flush=True)
        if impl:
            step_ms = 1e3 * sum(secs[1:]) / max(len(secs) - 1, 1)
            kernel = dict(launches=launches, step_ms=step_ms, peak=peak)
    remat = 2 if cfg.remat else 1
    want = dict.fromkeys(runs["auto"][1], 0)
    want["flash_attention"] = n_layers * steps * remat
    want["flash_attention_bwd"] = n_layers * steps
    if runs["auto"][1] != want:
        fail(f"train (kernels): launches {runs['auto'][1]} != {want}")
    if any(runs[None][1].values()):
        fail(f"train (plain): launched kernels: {runs[None][1]}")
    for i, (lk, lp) in enumerate(zip(runs["auto"][0], runs[None][0])):
        if not abs(lk - lp) <= TRAIN_RTOL * abs(lp):
            fail(f"train: step {i} loss {lk} (kernels) vs {lp} (plain)")
    print(f"train: {steps} steps' losses within {TRAIN_RTOL} relative of "
          f"the plain run's; launches as predicted {json.dumps(want)}",
          flush=True)
    return kernel


# ---------------------------------------------------------------------------
def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke test of the "
                                 "PyTorch/CUDA port (see the docstring).")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-2 only: build, check and time every "
                    "kernel; prints no result line")
    args = ap.parse_args()
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
    # nvcc runs in its own processes; the serving phases' checkpoints are
    # written on the host meanwhile
    build_error = []

    def run_build():
        try:
            build.build_all()
        except BaseException as exc:      # noqa: BLE001 (re-raised below)
            build_error.append(exc)

    builder = threading.Thread(target=run_build)
    builder.start()
    try:
        if not args.kernels_only:
            took = write_checkpoints()
            print(f"checkpoints written while the kernels built in "
                  f"{time.perf_counter() - t0:.1f}s ({took})", flush=True)
    finally:
        builder.join()
    if build_error:
        raise build_error[0]
    for k in build.KERNELS:
        build.library(k)
    print(f"kernels built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(build.BUILD_SECONDS)})", flush=True)
    for k in build.KERNELS:
        print(f"  ptxas -v: {build.ptxas_summary(k)}", flush=True)
    for k in ("quant_matmul", "streamed_matmul", "flash_attention",
              "paged_decode", "flash_attention_bwd"):
        counts = build.sass_counts(k, ("HMMA", "HGMMA", "FFMA"))
        print(f"  sass: lib{k}: {json.dumps(counts)}", flush=True)
        tensor_cores = k in ("quant_matmul", "streamed_matmul",
                             "flash_attention", "flash_attention_bwd")
        if tensor_cores and not counts["HMMA"] + counts["HGMMA"]:
            fail(f"lib{k} holds no tensor-core instruction (HMMA or HGMMA "
                 f"in cuobjdump -sass): its products are not on the tensor "
                 f"cores")

    # ---- phase 2: kernels against their plain versions
    cases = phase_kernels(torch)
    if args.kernels_only:
        print(f"chip_smoke: phases 1-2 passed in "
              f"{time.perf_counter() - t_start:.1f}s ({smi})", flush=True)
        return 0

    walls = {"1-2": time.perf_counter() - t_start}

    def timed(label, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        walls[label] = time.perf_counter() - t
        return out

    # ---- phases 3-7: the dense, paged and chunked paths; each path's
    # launch counts are set to 0 just before it and read just after
    cfg, dense_launches, dense_stats = timed("3-4", phase_main, torch, ops)
    paged_outs, paged_launches, paged_stats = timed(
        "5-6", phase_paged, torch, ops, cfg, dense_stats)
    chunk_launches, chunk_stats = timed("7", phase_chunked, torch, ops, cfg,
                                        paged_outs)

    # ---- phases 8-9: the quant paths
    import numpy as np
    watch_widening()
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, MAIN["prompt_len"]).tolist()
    fp32_logits = last_logits(torch, cfg, "fp32", prompt)
    quant_launches, quant_stats = {}, {}
    for quant in ("int8", "int4"):
        bits = 8 if quant == "int8" else 4
        quant_launches[bits], quant_stats[bits] = timed(
            "8" if bits == 8 else "9", phase_quant, torch, ops, cfg, quant,
            fp32_logits, prompt)

    # ---- phase 10: kernel autotune; 11-12: the fp16 models
    tune_launches, tune_stats, tuned = timed("10", phase_autotune, torch,
                                             ops, cfg, paged_outs)
    timed("11", phase_gptj, torch, ops)
    timed("12", phase_vit, torch, ops)

    # ---- phases 13-14: speculative serving (weak draft, self-draft)
    count_draft_steps()
    spec_launches, spec_stats = timed("13", phase_spec, torch, ops, cfg,
                                      paged_outs)
    timed("14", phase_self_draft, torch, ops)

    # ---- phase 15: the SLO multi-tenant tier
    slo_launches, slo_stats = timed("15", phase_slo, torch, ops, cfg)

    # ---- phases 16-17: expert-streaming MoE, fp16 then int8 shards
    moe_outs, moe_launches, moe_stats = timed("16", phase_moe, torch, ops)
    moe_q_launches, moe_q_stats = timed("17", phase_moe_quant, torch, ops,
                                        moe_outs)

    # ---- phases 18-19: the MLA and VLM engine families
    mla_launches, mla_serve = timed("18", phase_mla, torch, ops)
    vlm_launches, vlm_serve = timed("19", phase_vlm, torch, ops)

    # ---- phase 20: MLA on int8 shards; 21: training
    mla_q_launches, mla_q_serve = timed("20", phase_mla_quant, torch, ops)
    trained = timed("21", phase_train, torch, ops)
    train_launches = trained["launches"]

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
    # paged_flash_verify serves two paths: the chunk rounds (two shapes,
    # an equal share of the chunked loop's launches each) and the spec
    # rounds; its numbers are the mean per launch over all three
    for c in cases:
        if c["kernel"] == "paged_flash_verify" and c["case"].startswith(
                "main"):
            c["weight"] = (spec_stats.kernel_launches["paged_flash_verify"]
                           if "spec round" in c["case"] else
                           chunk_stats.kernel_launches["paged_flash_verify"]
                           / 2)
    if OVER_BUDGET:
        fail("device allocator peak above its limit: "
             + "; ".join(OVER_BUDGET))
    kernels = []
    for kname, (source, replaces, launches, stats) in meta.items():
        key = "flash_decode" if kname == "flash_decode_partial" else kname
        mine = [c for c in cases if c["kernel"] == kname
                and c["dtype"] == "float32"]
        # the main path's shapes; where it launches the kernel at several
        # (the chunk and spec rounds), the mean per launch, each shape
        # weighted by its launches
        mains = [c for c in mine if c["case"].startswith("main")]
        weights = [c.get("weight", 1) for c in mains]

        def mean(f):
            vals = [c[f] for c in mains]
            return None if None in vals else sum(
                w * v for w, v in zip(weights, vals)) / sum(weights)
        both = kname == "paged_flash_verify"    # the chunk and spec paths
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launch_key": key,
            "launches": launches[key] + (spec_launches[key] if both else 0),
            "serve_launches": stats.kernel_launches[key] + (
                spec_stats.kernel_launches[key] if both else 0),
            "spec_launches": spec_launches[key],
            "spec_serve_launches": spec_stats.kernel_launches[key],
            "slo_launches": slo_launches[key],
            "slo_serve_launches": slo_stats.kernel_launches[key],
            "moe_launches": moe_launches[key],
            "moe_serve_launches": moe_stats.kernel_launches[key],
            "moe_quant_launches": moe_q_launches[key],
            "moe_quant_serve_launches": moe_q_stats.kernel_launches[key],
            "mla_launches": mla_launches[key],
            "mla_serve_launches": mla_serve[key],
            "vlm_launches": vlm_launches[key],
            "vlm_serve_launches": vlm_serve[key],
            "mla_quant_launches": mla_q_launches[key],
            "mla_quant_serve_launches": mla_q_serve[key],
            "train_launches": train_launches[key],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": max(mains, key=lambda c: c["bound_ms"])["bound_by"],
            "library_ms": mean("library_ms"), "device_ms": mean("device_ms"),
            "kernels_per_call": mean("kernels_per_call"),
            "library_device_ms": mean("library_device_ms")})
    # quantized_matmul: launches from both quant paths
    kernels.append(dict(
        name="quantized_matmul", route="cuda",
        source=csrc + "quant_matmul.cu",
        batched_source=csrc + "quant_matmul_batched.cu",
        replaces="src/repro/kernels/streamed_matmul.py:101",
        launches=sum(ln["quantized_matmul"]
                     for ln in quant_launches.values()),
        serve_launches=sum(st.kernel_launches["quantized_matmul"]
                           for st in quant_stats.values()),
        moe_quant_launches=moe_q_launches["quantized_matmul"],
        moe_quant_serve_launches=moe_q_stats.kernel_launches[
            "quantized_matmul"],
        mla_quant_launches=mla_q_launches["quantized_matmul"],
        mla_quant_serve_launches=mla_q_serve["quantized_matmul"],
        **quant_row(cases, quant_stats)))
    # flash_attention_bwd: phase 21's launches; its numbers at phase 21's
    # shape (the main path's)
    bwd = [c for c in cases if c["kernel"] == "flash_attention_bwd"]
    main_bwd = [c for c in bwd if c["case"].startswith("main")][0]
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source=csrc + "flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:192",
        launches=train_launches["flash_attention_bwd"],
        sass_hmma=build.sass_counts("flash_attention_bwd", ("HMMA",))["HMMA"],
        train_step_ms=trained["step_ms"],
        train_alloc_peak=trained["peak"],
        max_abs_err=max(c["max_abs_err"] for c in bwd
                        if c["dtype"] == "float32"),
        **{k: main_bwd[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "library_device_ms",
                                    "kernels_per_call")}))
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
                                "bound_by", "library_ms",
                                "library_device_ms")}))
    print("chip_smoke: phase walls "
          + ", ".join(f"{k} {v:.1f}s" for k, v in walls.items()), flush=True)
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
