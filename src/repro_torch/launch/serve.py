"""Serving launcher: continuous-batching PIPELOAD inference, PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-base \\
        --budget-mb 600 --requests 8 --max-inflight 4 --new-tokens 8

Builds (or reuses) a layer-partitioned checkpoint written from a numpy
seed, profiles it on the device, lets the generation-aware Pipeline
Planner pick the ``(num_agents, pin_window, inflight)`` triple for the
memory budget, and serves the requests through the continuous-batching
scheduler: each PIPELOAD round streams every layer ONCE and applies it to
all in-flight requests.

Flags follow ``repro.launch.serve``, plus ``--device {cuda,cpu}`` (default
``cuda``; asking for CUDA without a card raises).  Checkpoints live under
``$TMPDIR/repro_torch_ckpts``, apart from the JAX package's, and the
profile is cached as ``profile_torch_<device>.json``.  The flags of
slices not yet ported (paged KV, quantization, speculation, the SLO tier,
trace replay, autotune) exit with a "not yet ported in repro_torch"
error.
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
from repro_torch.core import BatchScheduler, Hermes
from repro_torch.core import telemetry as tele
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


def _not_ported(flag: str):
    raise SystemExit(f"error: {flag} is not yet ported in repro_torch")


def run(arch: str, *, budget_mb: float | None = None, requests: int = 4,
        prompt_len: int = 16, new_tokens: int = 8, reduced: bool = True,
        num_agents: int | None = None, pin_window: int | None = None,
        kv_cache: bool = True, max_inflight: int = 4,
        arrival_rate: float | None = None, seed: int = 0,
        quant: str = "fp32", page_size: int = 0, shared_prefix: int = 0,
        trace_out: str | None = None, metrics_out: str | None = None,
        device: str = "cuda", ckpt_root=None, attn_impl: str | None = "auto"):
    """Serve ``requests`` seeded prompts; returns ``(outs, stats)``.
    ``attn_impl=None`` runs the kernels' plain PyTorch versions."""
    if quant != "fp32":
        _not_ported(f"--quant {quant}")
    if page_size:
        _not_ported("--page-size")
    tele.metrics().reset()
    if trace_out:
        tele.enable()
    cfg = get(arch)
    if reduced:
        cfg = cfg.reduced().with_(num_layers=8)
    ckpt = ensure_checkpoint(cfg, root=ckpt_root)
    hermes = Hermes(ckpt, cfg, device=device)
    budget = int(budget_mb * 2**20) if budget_mb else None
    rng = np.random.default_rng(seed)
    shared_prefix = max(0, min(shared_prefix, prompt_len))
    prompts = rng.integers(0, cfg.vocab_size, (requests, prompt_len))
    if shared_prefix:
        prompts[:, :shared_prefix] = prompts[0, :shared_prefix]
    total_len = prompt_len + new_tokens

    if not kv_cache:
        # paper's engine (§V-B2): sequential re-prefill
        plan = hermes.plan([budget], quants=("fp32",))[0]
        agents, pin = num_agents or plan.num_agents, pin_window or 0
        print(f"planner: budget={budget_mb}MB -> {agents} agents, "
              f"predicted latency {plan.predicted_latency_s*1e3:.0f}ms, "
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

    g = hermes.plan_generate([budget], prompt_len=prompt_len,
                             new_tokens=new_tokens,
                             max_inflight=max_inflight,
                             quants=("fp32",))[0]
    if not g.feasible:
        raise SystemExit(
            f"error: no feasible serving schedule for budget="
            f"{budget_mb}MB (best candidate predicts peak "
            f"{g.predicted_peak_bytes/2**20:.1f}MB, of which "
            f"{g.cache_bytes/2**20:.1f}MB KV cache at inflight="
            f"{g.inflight}); raise the budget, shrink "
            f"prompt/new-tokens, or pass --no-kv-cache")
    agents = num_agents or g.num_agents
    pin = g.pin_window if pin_window is None else pin_window
    print(f"planner(serve): budget={budget_mb}MB -> {agents} agents, "
          f"pin={pin}, inflight={g.inflight}, dtype={g.dtype}, predicted "
          f"{g.predicted_throughput_tps:.1f} tok/s aggregate, peak "
          f"{g.predicted_peak_bytes/2**20:.0f}MB "
          f"(cache {g.cache_bytes/2**20:.1f}MB)")
    eng = hermes.engine(mode="pipeload", budget_bytes=budget,
                        num_agents=agents, pin_window=pin,
                        attn_impl=attn_impl)
    sched = BatchScheduler(eng, max_inflight=g.inflight,
                           max_total_len=total_len, seed=seed)
    try:
        sched.warmup(prompt_lens=[prompt_len])
        arrivals = poisson_arrivals(requests, arrival_rate, rng)
        for i in range(requests):
            sched.submit(prompts[i], new_tokens, arrival_round=arrivals[i])
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
    print(tele.summary_table(rows, title="serve summary"))
    print(format_peak_breakdown(peak_breakdown_report(stats)))
    print(format_drift(drift_report(g, stats)))
    for rid, req in sorted(sched.done.items()):
        print(f"  req{rid}: arrived r{req.born_round} admitted "
              f"r{req.admitted_round} finished r{req.finished_round}")
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
                    help="shard precision (only fp32 is ported)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV page size (not yet ported; 0 = dense)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged KV prefix sharing off (dense mode has "
                    "none)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="first N prompt tokens identical across requests")
    ap.add_argument("--draft-arch", default=None,
                    help="speculative serving (not yet ported)")
    ap.add_argument("--spec-depth", type=int, default=0,
                    help="speculative depth (not yet ported)")
    ap.add_argument("--autotune", action="store_true",
                    help="kernel autotune (not yet ported)")
    ap.add_argument("--trace", default=None,
                    help="multi-tenant trace replay (not yet ported)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="multi-tenant trace (not yet ported)")
    ap.add_argument("--chunk-prefill", type=int, default=0,
                    help="chunked prefill (not yet ported)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="SLO tier (not yet ported)")
    ap.add_argument("--slo-tpot-ms", type=float, default=None,
                    help="SLO tier (not yet ported)")
    ap.add_argument("--slo-shed", action="store_true",
                    help="SLO tier (not yet ported)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="enable the span tracer and write the run as "
                    "Chrome trace-event JSON")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the end-of-run metrics-registry snapshot")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    unported = [("--page-size", args.page_size),
                ("--quant", args.quant != "fp32"),
                ("--draft-arch", args.draft_arch),
                ("--spec-depth", args.spec_depth),
                ("--autotune", args.autotune), ("--trace", args.trace),
                ("--tenants", args.tenants),
                ("--chunk-prefill", args.chunk_prefill),
                ("--slo-ttft-ms", args.slo_ttft_ms),
                ("--slo-tpot-ms", args.slo_tpot_ms),
                ("--slo-shed", args.slo_shed)]
    for flag, value in unported:
        if value:
            _not_ported(flag)
    run(args.arch, budget_mb=args.budget_mb, requests=args.requests,
        prompt_len=args.prompt_len, new_tokens=args.new_tokens,
        reduced=not args.full, num_agents=args.num_agents,
        pin_window=args.pin_window, kv_cache=not args.no_kv_cache,
        max_inflight=args.max_inflight, arrival_rate=args.arrival_rate,
        seed=args.seed, shared_prefix=args.shared_prefix,
        trace_out=args.trace_out, metrics_out=args.metrics_out,
        device=args.device)


if __name__ == "__main__":
    main()
