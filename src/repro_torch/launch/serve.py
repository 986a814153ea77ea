"""Serving launcher: continuous-batching PIPELOAD inference, PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-base \\
        --budget-mb 600 --requests 8 --max-inflight 4 --new-tokens 8

Builds (or reuses) a layer-partitioned checkpoint written from a numpy
seed, profiles it on the device, lets the generation-aware Pipeline
Planner pick the ``(num_agents, pin_window, inflight)`` triple for the
memory budget, and serves the requests through the continuous-batching
scheduler: each PIPELOAD round streams every layer ONCE and applies it to
all in-flight requests.

``--quant int8|int4`` serves int8/int4 shards of the checkpoint (a
sibling directory, transcoded once), every linear layer through the
dequantizing matmul kernel; ``--quant auto`` lets the planner pick the
shard dtype jointly with the schedule.

``--autotune`` tunes the kernels for the planner's winning (dtype, page
size) before serving: the streamed matmul's tiles at the model's FFN
shape and, with ``--page-size``, the paged-decode route, timed on the
device and cached (``~/.cache/repro_torch/autotune.json``, or
``$REPRO_TORCH_AUTOTUNE_CACHE``), so a repeat run skips the sweep.

``--shared-prefix N`` makes every request's first N prompt tokens
identical, and ``--page-size P`` adds the PAGED KV reservation
(core/kv_pages.py) to the planner's search: requests map fixed-size cache
pages through block tables and the radix prefix tree maps the shared
prompt's pages once across the fleet (``--no-prefix-cache`` turns the
sharing off).  ``--chunk-prefill C`` (needs ``--page-size``) splits
prompts longer than C into page-aligned chunks joined into decode rounds.

``--draft-arch`` turns on SPECULATIVE serving (needs ``--page-size``): a
small draft model, pinned whole on the device under the budget like the
pin window, proposes ``--spec-depth`` tokens per request per round; the
target scores each request's whole window in ONE stacked verify round
over the paged block tables, and the accepted prefix plus the target's
bonus token commit together, so a round advances each request by up to
``depth + 1`` tokens for one weight stream.  The draft must share the
target's vocabulary; greedy outputs are the non-speculative ones.
``--spec-depth 0`` (the default with a draft) lets the planner search the
depth jointly with the rest of the schedule.

The SLO multi-tenant tier: ``--tenants N`` serves a seeded heavy-tailed
multi-tenant trace (``repro_torch.data.traces``: Poisson arrivals at
``--arrival-rate``, lognormal prompts up to ``--prompt-len``, geometric
outputs up to ``--new-tokens``, priority classes 0..2, and a per-tenant
system prompt of ``--shared-prefix`` tokens that 60% of a tenant's
requests reuse); ``--trace FILE`` replays a saved one.  Each request
carries its priority (a higher class may preempt a lower one) and its
tenant (prefix pages share within a tenant, never across).
``--slo-ttft-ms`` / ``--slo-tpot-ms`` gate the planner's search and,
through the planned round latency, set the scheduler's rounds-based
``SLO``; ``--slo-shed`` rejects requests whose TTFT target is out of
reach at admission.

MoE architectures (e.g. ``--arch qwen3_moe_30b_a3b``) are partitioned
expert-split and served through the expert-streaming subsystem
(``core/expert_stream.py``): attention+router shards stream as layers do,
the round's activated experts are demand-loaded after the router runs,
and the planner sizes the expert cache jointly with the schedule.  The
summary reports the expert hit rate, the unique experts per round and the
cache's bytes.  ``--quant int8|int4|auto`` transcodes the expert-split
checkpoint into a sibling ``<ckpt>-<quant>`` directory once, as for a
dense model: the expert rows keep their layout at the quantized bytes, and
each streamed expert's SwiGLU runs on the quantized matmul.  Paged KV
(``--page-size``) is refused with expert-split checkpoints, as the
reference's scheduler refuses it.

Flags follow ``repro.launch.serve``, plus ``--device {cuda,cpu}`` (default
``cuda``; asking for CUDA without a card raises).  Checkpoints live under
``$TMPDIR/repro_torch_ckpts``, apart from the JAX package's, and the
profile is cached as ``profile_torch_<device>.json``.  MLA configs
(``--arch minicpm3_4b``) serve through the same scheduler, their latent
{c, kr} caches paged through the gather path; VLM configs (``--arch
qwen2_vl_2b``) serve their decoder backbone on text, as the reference's
engine does.  ``--quant`` with an MLA arch serves its int8 / int4
transcode as for a dense model: the absorbed W_uk / W_uv products run as
one batched quantized matmul launch each for all heads.  An ``--arch`` of
a family not yet ported (recurrent, encoder-decoder) exits with a "not
yet ported in repro_torch" error before any checkpoint is written.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.analysis.report import (drift_report, format_drift,
                                         format_peak_breakdown,
                                         peak_breakdown_report)
from repro_torch.checkpoint import partition_and_save
from repro_torch.configs import get, names
from repro_torch.core import SLO, BatchScheduler, Hermes
from repro_torch.core import telemetry as tele
from repro_torch.core.engine import DraftModel, resolve_device
from repro_torch.core.hermes import spec_plan_kw
from repro_torch.core.modules import check_engine_family
from repro_torch.data.traces import (load_trace, make_trace, submit_trace,
                                     trace_max_len)
from repro_torch.models.config import MOE
from repro_torch.models.dense_lm import init_params

CKPT_ROOT = Path(tempfile.gettempdir()) / "repro_torch_ckpts"
QUANT_CHOICES = ("fp32", "int8", "int4", "auto")


def ensure_checkpoint(cfg, seed: int = 0, root=None) -> Path:
    """The checkpoint for ``cfg`` under ``root`` (default ``CKPT_ROOT``),
    written from numpy-seeded random weights if it is not there yet."""
    path = Path(root or CKPT_ROOT) / cfg.name.replace("/", "_")
    if not (path / "manifest.json").exists():
        params = init_params(np.random.default_rng(seed), cfg)
        partition_and_save(params, cfg, path)
    return path


def poisson_arrivals(n: int, rate: float | None,
                     rng: np.random.Generator) -> list[int]:
    """Arrival round per request: a Poisson process at ``rate`` requests
    per ROUND.  ``rate=None``/0 = all arrive at once."""
    if not rate:
        return [0] * n
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(int).tolist()


def export_telemetry(trace_out: str | None, metrics_out: str | None):
    if trace_out:
        tele.export_chrome_trace(trace_out)
        print(f"trace: wrote {trace_out} (load it in ui.perfetto.dev "
              "or chrome://tracing)")
    if metrics_out:
        Path(metrics_out).write_text(
            json.dumps(tele.metrics().snapshot(), indent=1))
        print(f"metrics: wrote {metrics_out}")


def check_ported(cfg, flag: str, name: str) -> None:
    """Exit with a "not yet ported" error for a model the port cannot
    serve yet, before anything is written for it."""
    try:
        check_engine_family(cfg, where="serving")
    except NotImplementedError:
        raise SystemExit(f"error: {flag} {name} is not yet ported in "
                         f"repro_torch") from None


def run(arch, *, budget_mb: float | None = None, requests: int = 4,
        prompt_len: int = 16, new_tokens: int = 8, reduced: bool = True,
        num_agents: int | None = None, pin_window: int | None = None,
        kv_cache: bool = True, max_inflight: int = 4,
        arrival_rate: float | None = None, seed: int = 0,
        quant: str = "fp32", page_size: int = 0, prefix_cache: bool = True,
        shared_prefix: int = 0, chunk_prefill: int = 0,
        trace_out: str | None = None, metrics_out: str | None = None,
        device: str = "cuda", ckpt_root=None, attn_impl: str | None = "auto",
        autotune: bool = False, draft_arch: str | None = None,
        spec_depth: int = 0, trace: str | None = None, tenants: int = 0,
        slo_ttft_ms: float | None = None, slo_tpot_ms: float | None = None,
        slo_shed: bool = False):
    """Serve ``requests`` seeded prompts (or, with ``tenants`` / ``trace``,
    a multi-tenant trace); returns ``(outs, stats)``.  ``arch`` is a
    registered name (cut by ``reduced``) or a model config served as
    given, e.g. one whose depth a caller cut; its checkpoint directory is
    named by ``cfg.name``.  ``attn_impl=None`` runs the kernels' plain
    PyTorch versions."""
    resolve_device(device)              # no card: raise before any work
    cfg = get(arch) if isinstance(arch, str) else arch
    check_ported(cfg, "--arch", arch if isinstance(arch, str) else cfg.name)
    if draft_arch:
        check_ported(get(draft_arch), "--draft-arch", draft_arch)
    if cfg.family == MOE and page_size:
        raise SystemExit("error: paged KV serving is not supported with "
                         "expert-split MoE checkpoints yet; repartition "
                         "whole-layer or drop page_size")
    if chunk_prefill and not page_size:
        raise SystemExit("error: --chunk-prefill needs --page-size (chunk "
                         "rounds write through the paged KV kernel)")
    if chunk_prefill and draft_arch:
        raise SystemExit("error: --chunk-prefill is incompatible with "
                         "--draft-arch (speculative rounds own the verify "
                         "window)")
    if (trace or tenants) and not kv_cache:
        raise SystemExit("error: --trace/--tenants need the KV-cache "
                         "scheduler; drop --no-kv-cache")
    tele.metrics().reset()
    if trace_out:
        tele.enable()
    if isinstance(arch, str) and reduced:
        cfg = cfg.reduced().with_(num_layers=8)
    ckpt = ensure_checkpoint(cfg, root=ckpt_root)
    hermes = Hermes(ckpt, cfg, device=device)
    draft = None
    if draft_arch:
        if not page_size:
            raise SystemExit("error: --draft-arch needs --page-size (the "
                             "verify window rides the paged KV block "
                             "tables)")
        if not kv_cache:
            raise SystemExit("error: --draft-arch needs the KV-cache "
                             "scheduler; drop --no-kv-cache")
        dcfg = get(draft_arch)
        if reduced:
            dcfg = dcfg.reduced()       # 2 layers: a genuinely small draft
        dcfg = dcfg.with_(name=dcfg.name + "-draft")
        if dcfg.vocab_size != cfg.vocab_size:
            raise SystemExit(
                f"error: draft vocab ({dcfg.vocab_size}) must match the "
                f"target's ({cfg.vocab_size}): proposals are target token "
                f"ids")
        draft = DraftModel(ensure_checkpoint(dcfg, root=ckpt_root), dcfg,
                           attn_impl=attn_impl, device=device)
    # fixed dtype = a one-entry search; "auto" lets the planner pick the
    # shard precision jointly with the schedule
    quants = ("fp32", "int8", "int4") if quant == "auto" else (quant,)
    budget = int(budget_mb * 2**20) if budget_mb else None
    rng = np.random.default_rng(seed)
    shared_prefix = max(0, min(shared_prefix, prompt_len))
    prompts = rng.integers(0, cfg.vocab_size, (requests, prompt_len))
    if shared_prefix:
        # shared-system-prompt trace: every request opens with the same
        # tokens (what the prefix tree maps once across the fleet)
        prompts[:, :shared_prefix] = prompts[0, :shared_prefix]
    serve_trace = None
    if trace:
        serve_trace = load_trace(trace)
    elif tenants:
        # seeded heavy-tailed multi-tenant mix: prompt_len / new_tokens
        # bound the distributions, so the planned reservation still fits
        serve_trace = make_trace(
            requests, tenants=tenants, seed=seed, vocab=cfg.vocab_size,
            arrival_rate=arrival_rate or 1.0,
            prompt_mean=max(prompt_len // 2, 4), max_prompt=prompt_len,
            new_mean=max(new_tokens // 2, 1), max_new=new_tokens,
            prefix_len=shared_prefix, share_prefix=0.6)
    total_len = prompt_len + new_tokens
    if serve_trace:
        total_len = max(total_len, trace_max_len(serve_trace))

    if not kv_cache:
        # paper's engine (§V-B2): sequential re-prefill
        plan = hermes.plan([budget], quants=quants)[0]
        hermes = hermes.quantized(plan.dtype)
        agents, pin = num_agents or plan.num_agents, pin_window or 0
        print(f"planner: budget={budget_mb}MB -> {agents} agents, "
              f"dtype={plan.dtype}, predicted latency {plan.predicted_latency_s*1e3:.0f}ms, "
              f"peak {plan.predicted_peak_bytes/2**20:.0f}MB")
        with hermes.engine(mode="pipeload", budget_bytes=budget,
                           num_agents=agents, pin_window=pin,
                           attn_impl=attn_impl) as eng:
            eng.warmup(requests, prompt_len)
            t0 = time.time()
            out, stats = eng.run_generate(prompts, new_tokens,
                                          kv_cache=False)
            dt = time.time() - t0
        print(f"served {requests} reqs x {new_tokens} tokens in {dt:.2f}s "
              f"({requests*new_tokens/dt:.1f} tok/s), "
              f"peak {stats.peak_bytes/2**20:.0f}MB, "
              f"{stats.loads} shard loads "
              f"({stats.streamed_bytes/2**20:.0f}MB streamed)")
        print(format_peak_breakdown(peak_breakdown_report(stats)))
        export_telemetry(trace_out, metrics_out)
        outs = {i: row for i, row in enumerate(out.cpu().numpy())}
        return outs, stats

    spec_kw = {} if draft is None else spec_plan_kw(draft, spec_depth,
                                                    total_len)
    g = hermes.plan_generate([budget], prompt_len=prompt_len,
                             new_tokens=new_tokens,
                             max_inflight=max_inflight,
                             quants=quants,
                             page_sizes=(page_size,) if page_size else (),
                             # with sharing off every page is private:
                             # the plan must not assume hits
                             shared_prefix_len=(shared_prefix
                                                if prefix_cache else 0),
                             slo_ttft_s=(slo_ttft_ms / 1e3
                                         if slo_ttft_ms else None),
                             slo_tpot_s=(slo_tpot_ms / 1e3
                                         if slo_tpot_ms else None),
                             chunk_prefill=chunk_prefill, **spec_kw)[0]
    if not g.feasible:
        raise SystemExit(
            f"error: no feasible serving schedule for budget="
            f"{budget_mb}MB (best candidate predicts peak "
            f"{g.predicted_peak_bytes/2**20:.1f}MB, of which "
            f"{g.cache_bytes/2**20:.1f}MB KV cache at inflight="
            f"{g.inflight}); raise the budget, shrink "
            f"prompt/new-tokens, or pass --no-kv-cache")
    if autotune:
        # kernel tiles / routes for the planner's winning (dtype, page
        # size), seeded from that checkpoint's profile and cached to disk:
        # repeat serves skip the timing sweep
        sel = hermes.autotune(page_size=g.page_size or None,
                              quant=(g.dtype if g.dtype != "fp32"
                                     else None))
        mm = sel["matmul"]
        print(f"autotune({sel['arch']}): matmul tiles "
              f"{mm['block_m']}x{mm['block_n']}x{mm['block_k']}"
              + (f", paged impl {sel['paged_decode']['impl']}"
                 if "paged_decode" in sel else ""))
    hermes = hermes.quantized(g.dtype)
    agents = num_agents or g.num_agents
    pin = g.pin_window if pin_window is None else pin_window
    # an explicit --spec-depth pins the verify depth; 0 defers to the
    # planner's joint pick (which may conclude speculation does not pay)
    depth = (spec_depth or g.spec_depth) if draft is not None else 0
    print(f"planner(serve): budget={budget_mb}MB -> {agents} agents, "
          f"pin={pin}, inflight={g.inflight}, dtype={g.dtype}, predicted "
          f"{g.predicted_throughput_tps:.1f} tok/s aggregate, peak "
          f"{g.predicted_peak_bytes/2**20:.0f}MB "
          f"(cache {g.cache_bytes/2**20:.1f}MB"
          + (f", page size {g.page_size}" if g.page_size else "")
          + (f", spec depth {depth}" if depth else "")
          + (f", chunk {chunk_prefill}" if chunk_prefill else "")
          + (f", expert cache {g.expert_cache_bytes/2**20:.1f}MB"
             if g.expert_cache_bytes else "") + ")")
    if slo_ttft_ms or slo_tpot_ms:
        print(f"planner(slo): predicted ttft {g.predicted_ttft_s*1e3:.0f}ms"
              f" / tpot {g.predicted_tpot_s*1e3:.1f}ms -> "
              f"{'MEETS' if g.slo_ok else 'MISSES'} the target"
              + ("" if g.slo_ok else " (serving degraded: no feasible "
                 "schedule attains it)"))
    slo = None
    if slo_ttft_ms or slo_tpot_ms:
        # seconds targets -> the scheduler's deterministic rounds clock,
        # through the planned round latency (as the facade converts them)
        rl = g.predicted_per_token_s
        if rl and rl > 0 and np.isfinite(rl):
            slo = SLO(ttft_rounds=(max(int(slo_ttft_ms / 1e3 / rl), 1)
                                   if slo_ttft_ms else None),
                      tpot_rounds=((slo_tpot_ms / 1e3 / rl)
                                   if slo_tpot_ms else None),
                      shed=slo_shed)
    eng = hermes.engine(mode="pipeload", budget_bytes=budget,
                        num_agents=agents, pin_window=pin,
                        attn_impl=attn_impl,
                        expert_cache_bytes=g.expert_cache_bytes or None,
                        page_size=g.page_size or None)
    sched = BatchScheduler(eng, max_inflight=g.inflight,
                           max_total_len=total_len,
                           prefix_cache=prefix_cache, seed=seed,
                           draft=(draft if depth else None),
                           spec_depth=depth,
                           chunk_prefill=(chunk_prefill if g.page_size
                                          else 0),
                           slo=slo)
    try:
        sched.warmup(prompt_lens=[prompt_len])
        if serve_trace is not None:
            submit_trace(sched, serve_trace)
        else:
            arrivals = poisson_arrivals(requests, arrival_rate, rng)
            for i in range(requests):
                sched.submit(prompts[i], new_tokens,
                             arrival_round=arrivals[i])
        t0 = time.time()
        outs, stats = sched.run()
        dt = time.time() - t0
    finally:
        sched.close()
    print(f"served {stats.requests} reqs x {new_tokens} tokens in "
          f"{stats.rounds} rounds / {dt:.2f}s "
          f"({stats.tokens_per_s:.1f} tok/s aggregate), peak "
          f"{stats.peak_bytes/2**20:.0f}MB "
          f"(cache {stats.cache_bytes_peak/2**20:.1f}MB), "
          f"{stats.loads} shard loads "
          f"({stats.streamed_bytes/2**20:.0f}MB streamed), "
          f"max inflight seen {stats.max_inflight_seen}, "
          f"seed {stats.seed}, device {eng.device}")
    rows: dict[str, object] = {
        "streamed_mb": f"{stats.streamed_bytes/2**20:.0f}",
        "ledger_peak_mb": (f"{stats.peak_bytes/2**20:.0f}"
                           + (f" / budget {budget_mb:.0f}"
                              if budget_mb else "")),
        "cache_peak_mb": f"{stats.cache_bytes_peak/2**20:.1f}",
        "shard_loads": stats.loads,
    }
    if stats.retries or stats.faults_absorbed:
        rows["prefetch_retries"] = stats.retries
        rows["faults_absorbed"] = stats.faults_absorbed
    if stats.page_size:
        rows["page_size"] = stats.page_size
        rows["page_allocs"] = (f"{stats.pages_allocated} "
                               f"({stats.page_reuses} from the free "
                               f"list, pool peak {stats.pool_pages_peak})")
        rows["prefix_hit_pages"] = stats.prefix_hit_pages
        rows["cow_copies"] = stats.cow_copies
        rows["preemptions"] = stats.preemptions
    if stats.chunk_size:
        rows["chunk_prefill"] = (f"{stats.chunk_size}-token chunks, "
                                 f"{stats.chunk_jobs} jobs joined into "
                                 "decode rounds")
    if serve_trace is not None or slo is not None:
        rows["ttft_p50_p99_rounds"] = (f"{stats.ttft_p50_rounds:.1f} / "
                                       f"{stats.ttft_p99_rounds:.1f}")
        rows["tpot_p50_p99_rounds"] = (f"{stats.tpot_p50_rounds:.2f} / "
                                       f"{stats.tpot_p99_rounds:.2f}")
        rows["slo_attained"] = f"{stats.slo_attained:.0%}"
        rows["goodput_tokens"] = (f"{stats.goodput_tokens} "
                                  f"({stats.goodput_tokens_per_s:.1f} "
                                  "tok/s)")
        rows["shed"] = stats.slo_rejections
        rows["tenants"] = stats.tenants
    if eng.expert is not None:
        rows["expert_hit_rate"] = (f"{stats.expert_hit_rate:.0%} "
                                   f"({stats.expert_hits} hits / "
                                   f"{stats.expert_misses} loads, "
                                   f"{stats.expert_evictions} evicted)")
        rows["experts_per_round"] = f"{stats.unique_experts_per_round:.1f}"
        rows["expert_cache_mb"] = f"{stats.expert_cache_bytes/2**20:.1f}"
    if stats.spec_depth:
        rows["spec_depth"] = stats.spec_depth
        rows["spec_accepted"] = (f"{stats.accepted_tokens}/"
                                 f"{stats.draft_tokens} "
                                 f"({stats.acceptance_rate:.0%}) over "
                                 f"{stats.spec_rounds} verify rounds")
    print(tele.summary_table(rows, title="serve summary"))
    print(format_peak_breakdown(peak_breakdown_report(stats)))
    print(format_drift(drift_report(g, stats)))
    for rid, req in sorted(sched.done.items()):
        tag = (f" [{req.tenant} p{req.priority}]"
               if serve_trace is not None else "")
        state = ("SHED" if req.rejected else
                 f"admitted r{req.admitted_round} finished "
                 f"r{req.finished_round}")
        print(f"  req{rid}{tag}: arrived r{req.born_round} {state}")
    export_telemetry(trace_out, metrics_out)
    return outs, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2_base", choices=names(),
                    type=lambda a: a.replace("-", "_").replace(".", "_"),
                    help="architecture id from the config registry "
                    "(dashes/dots tolerated)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (cuda raises without a card)")
    ap.add_argument("--budget-mb", type=float, default=None)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--num-agents", type=int, default=None)
    ap.add_argument("--pin-window", type=int, default=None)
    ap.add_argument("--max-inflight", type=int, default=4,
                    help="concurrency cap; the planner may pick less "
                    "under a tight budget")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrivals, requests per round "
                    "(default: all at once)")
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed for the prompt/arrival trace")
    ap.add_argument("--no-kv-cache", action="store_true",
                    help="paper's per-token re-prefill engine (§V-B2)")
    ap.add_argument("--quant", default="fp32", choices=QUANT_CHOICES,
                    help="shard precision; 'auto' = planner searches "
                    "dtype jointly with the schedule")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV: cache page size in tokens added to "
                    "the planner's search (0 = dense only)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged KV: disable radix-tree prompt-prefix "
                    "page sharing")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="first N prompt tokens identical across requests")
    ap.add_argument("--draft-arch", default=None, choices=names(),
                    type=lambda a: a.replace("-", "_").replace(".", "_"),
                    help="speculative serving: draft architecture (needs "
                    "--page-size; must share the target's vocabulary)")
    ap.add_argument("--spec-depth", type=int, default=0,
                    help="draft tokens per verify round (0 = planner "
                    "searches {1, 2, 4})")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the kernels' tiles / paged route for the "
                    "planned dtype and page size (cached per device)")
    ap.add_argument("--trace", default=None,
                    help="replay a saved multi-tenant JSON trace "
                    "(repro_torch.data.traces.save_trace) verbatim")
    ap.add_argument("--tenants", type=int, default=0,
                    help="generate a seeded heavy-tailed multi-tenant "
                    "trace with N tenants (Zipf mix, priority classes, "
                    "per-tenant prefix namespaces)")
    ap.add_argument("--chunk-prefill", type=int, default=0,
                    help="split prompts longer than C tokens into "
                    "page-aligned chunks joined into decode rounds "
                    "(needs --page-size)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="time-to-first-token target: gates the planner "
                    "and sets the scheduler's rounds-based SLO")
    ap.add_argument("--slo-tpot-ms", type=float, default=None,
                    help="time-per-output-token target (as --slo-ttft-ms)")
    ap.add_argument("--slo-shed", action="store_true",
                    help="reject requests at admission once their best "
                    "TTFT already misses the --slo-ttft-ms target")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="enable the span tracer and write the run as "
                    "Chrome trace-event JSON")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the end-of-run metrics-registry snapshot")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    run(args.arch, budget_mb=args.budget_mb, requests=args.requests,
        prompt_len=args.prompt_len, new_tokens=args.new_tokens,
        reduced=not args.full, num_agents=args.num_agents,
        pin_window=args.pin_window, kv_cache=not args.no_kv_cache,
        max_inflight=args.max_inflight, arrival_rate=args.arrival_rate,
        seed=args.seed, quant=args.quant, page_size=args.page_size,
        prefix_cache=not args.no_prefix_cache,
        shared_prefix=args.shared_prefix, chunk_prefill=args.chunk_prefill,
        trace_out=args.trace_out, metrics_out=args.metrics_out,
        device=args.device, autotune=args.autotune,
        draft_arch=args.draft_arch, spec_depth=args.spec_depth,
        trace=args.trace, tenants=args.tenants,
        slo_ttft_ms=args.slo_ttft_ms, slo_tpot_ms=args.slo_tpot_ms,
        slo_shed=args.slo_shed)


if __name__ == "__main__":
    main()
