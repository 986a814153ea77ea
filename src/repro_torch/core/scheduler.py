"""Continuous-batching scheduler: one weight stream serves every request.

PyTorch port of ``repro/core/scheduler.py``, dense mode.  PIPELOAD's
dominant cost is streaming layer weights, paid once per pipeline round;
the scheduler amortises it: each round, layer ``k`` is loaded once,
applied to the stacked single-token states of ALL in-flight requests
(ragged positions — every request sits at its own cache slot) and to the
cache-capturing prefill of requests admitted at this round boundary, then
destroyed (``S_dest``).

Lifecycle (transitions happen at round boundaries, except retirement
detection, which happens the instant a request's last token is sampled):

    submit() -> QUEUED -> [admission] -> PREFILLING -> DECODING -> DONE

Memory protocol: every request's KV cache is charged to the engine's
``_Ledger`` — the same budget the streamed weights draw from.  Admission
is FIFO and blocks whenever the post-admission decode floor

    other_bytes + pinned + all in-flight caches + one streaming layer

would exceed the budget, or the in-flight count would exceed
``max_inflight``.  A request's cache bytes are released the round it
finishes, so a queued request can be admitted at the same boundary.

All caches are padded to ``max_total_len`` slots so stacked decode keeps
one shape per batch size (padding past a request's position is masked
out exactly), so batched decoding is token-for-token identical to
sequential runs.  The stacked per-layer caches live on the engine's
device; rows are dropped and appended with ``index_select``/``cat`` at
round boundaries.

Not yet ported (they raise): paged KV, prefix sharing, speculative
serving, chunked prefill and the SLO tier (priorities, tenants,
shedding).  TTFT/TPOT percentiles are still reported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import telemetry as _tele
from repro_torch.core.engine import PipeloadEngine, _Ledger, _not_ported
from repro_torch.kernels import ops as _ops


@dataclasses.dataclass
class Request:
    """One generation request; scheduler-owned fields below ``rid``."""
    rid: int
    prompt: np.ndarray            # (S,) int token ids
    max_new_tokens: int
    arrival_round: int = 0        # earliest boundary it may be admitted at
    # -- scheduler state ------------------------------------------------
    tokens: List[int] = dataclasses.field(default_factory=list)
    generated: int = 0
    admitted_round: int = -1
    finished_round: int = -1
    cache_bytes: int = 0          # ledger reservation while in flight
    first_token_round: int = -1
    t_arrival: float = -1.0       # wall-clock marks (observability only)
    t_first: float = -1.0
    t_done: float = -1.0

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    @property
    def pos(self) -> int:
        """Cache slot of the token about to be fed (current length - 1)."""
        return len(self.tokens) - 1

    @property
    def born_round(self) -> int:
        return self.arrival_round


@dataclasses.dataclass
class ServeStats:
    rounds: int
    latency_s: float
    peak_bytes: int
    loads: int
    streamed_bytes: int
    new_tokens: int
    requests: int
    max_inflight_seen: int
    cache_bytes_peak: int
    events: List[Tuple[float, str, str]]
    # reproducibility: the RNG seed the serving trace was generated with
    seed: Optional[int] = None
    ttft_p50_rounds: float = 0.0   # rounds from arrival to first token
    ttft_p99_rounds: float = 0.0
    tpot_p50_rounds: float = 0.0   # rounds per subsequent token
    tpot_p99_rounds: float = 0.0
    ttft_p50_s: float = 0.0        # wall-clock mirrors
    ttft_p99_s: float = 0.0
    tpot_p50_s: float = 0.0
    tpot_p99_s: float = 0.0
    # (kind, rid, round, t_wall) for every admit / retire decision
    policy: List[Tuple[str, int, int, float]] = dataclasses.field(
        default_factory=list)
    retries: int = 0
    faults_absorbed: int = 0
    # per-owner byte shares at the session ledger's peak
    peak_breakdown: Dict[str, int] = dataclasses.field(default_factory=dict)
    # kernel launches inside run() alone (profiling and warm-up excluded)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def tokens_per_s(self) -> float:
        return self.new_tokens / self.latency_s if self.latency_s else 0.0

    def event_log(self, kinds=None):
        return [e for e in self.events if kinds is None or e[1] in kinds]


class BatchScheduler:
    """Round-boundary continuous batching over a ``PipeloadEngine``.

    ``max_total_len`` bounds every request's prompt + generation length
    and fixes the padded cache shape; ``max_inflight`` caps concurrency,
    and the budget caps it further through admission control."""

    def __init__(self, engine: PipeloadEngine, *, max_inflight: int = 4,
                 max_total_len: int = 128, page_size: Optional[int] = None,
                 seed: Optional[int] = None, draft=None,
                 spec_depth: int = 0, chunk_prefill: int = 0, slo=None):
        if engine.mode == "baseline":
            raise ValueError("continuous batching needs a pipelined mode "
                             "(pipeload / pipeswitch)")
        if page_size:
            raise _not_ported("paged KV serving (page_size)")
        if draft is not None or spec_depth:
            raise _not_ported("speculative serving")
        if chunk_prefill:
            raise _not_ported("chunked prefill")
        if slo is not None:
            raise _not_ported("the SLO serving tier")
        self.engine = engine
        self.max_inflight = max(1, max_inflight)
        self.max_total_len = max_total_len
        self.page_size = None
        self.policy_log: List[Tuple[str, int, int, float]] = []
        m = _tele.metrics()
        self._m_admits = m.counter("sched.admits")
        self._m_retires = m.counter("sched.retires")
        self._fault_base = _tele.counter_values("prefetch.retries",
                                                "prefetch.faults_absorbed")
        self.seed = seed
        self.queue: List[Request] = []   # by (arrival, rid)
        self.inflight: List[Request] = []
        self.done: Dict[int, Request] = {}
        self.round = 0
        self._next_rid = 0
        # per-request-row stacked caches (rows parallel to self.inflight)
        self._caches: Optional[Dict[str, dict]] = None   # leaves (R, T, ...)
        # ONE ledger across all rounds: weights, caches and the pinned
        # window share a single budget
        self.ledger = _Ledger(engine.budget)
        self.events: List[Tuple[float, str, str]] = []
        self._t0 = time.perf_counter()
        self._cache_resident = 0
        self._cache_peak = 0
        self._max_seen = 0
        self._per_req_cache = (len(engine.layer_names)
                               * engine.cfg.cache_bytes(1, max_total_len))

    # ------------------------------------------------------------------
    def close(self):
        """End the serving session: tear down the engine's prefetch
        runtime.  Idempotent."""
        self.engine.close()

    def __enter__(self) -> "BatchScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               arrival_round: int = 0) -> int:
        """Queue a request; returns its id.  Raises if it could NEVER be
        admitted: too long for ``max_total_len``, or a cache reservation
        above the budget floor even with nothing else in flight."""
        prompt = np.asarray(prompt).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.max_total_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_total_len "
                f"{self.max_total_len}")
        self.engine._check_kv_budget(self._per_req_cache, inflight=1)
        req = Request(self._next_rid, prompt, max_new_tokens,
                      arrival_round=max(arrival_round, 0),
                      cache_bytes=self._per_req_cache)
        self._next_rid += 1
        self.queue.append(req)
        self.queue.sort(key=lambda r: (r.arrival_round, r.rid))
        return req.rid

    def _fits(self, extra_cache: int) -> bool:
        """Would the decode floor still clear the budget after granting
        ``extra_cache`` more cache bytes?"""
        eng = self.engine
        if eng.budget is None:
            return True
        return eng._kv_floor(self._cache_resident + extra_cache) \
            <= eng.budget

    def _admit(self) -> List[Request]:
        """FIFO head-of-line admission at the current boundary (skipping
        the head never helps: every request reserves the same padded
        size)."""
        admitted: List[Request] = []
        while self.queue:
            req = self.queue[0]
            if req.arrival_round > self.round:
                break
            if len(self.inflight) + len(admitted) >= self.max_inflight:
                break
            if not self._fits(req.cache_bytes):
                break
            # never blocks: _fits checked the floor, and at a boundary
            # nothing is streaming
            self.ledger.acquire(req.cache_bytes, owner="kv_pages",
                                detail=f"req{req.rid}")
            self._cache_resident += req.cache_bytes
            self._cache_peak = max(self._cache_peak, self._cache_resident)
            req.tokens = list(map(int, req.prompt))
            self.queue.pop(0)
            req.admitted_round = self.round
            now = time.perf_counter() - self._t0
            self.events.append((now, "admit", f"req{req.rid}"))
            self.policy_log.append(("admit", req.rid, self.round, now))
            self._m_admits.inc()
            tr = _tele.get_tracer()
            if tr.enabled:
                tr.instant("admit", rid=req.rid, round=self.round)
            admitted.append(req)
        return admitted

    def _retire(self, finished: List[Request]):
        """S_dest for cache bytes: release them the moment a request
        completes so the next boundary can re-grant them."""
        for req in finished:
            self.ledger.release(req.cache_bytes, owner="kv_pages",
                                detail=f"req{req.rid}")
            self._cache_resident -= req.cache_bytes
            req.finished_round = self.round
            req.t_done = time.perf_counter() - self._t0
            self.done[req.rid] = req
            self.events.append((req.t_done, "retire", f"req{req.rid}"))
            self.policy_log.append(("retire", req.rid, self.round,
                                    req.t_done))
            self._m_retires.inc()
            tr = _tele.get_tracer()
            if tr.enabled:
                tr.instant("retire", rid=req.rid, round=self.round)

    def _drop_rows(self, keep: List[int]):
        if self._caches is None:
            return
        if not keep:
            self._caches = None
            return
        idx = torch.as_tensor(keep, dtype=torch.long,
                              device=self.engine.device)
        self._caches = {name: {k: a.index_select(0, idx)
                               for k, a in c.items()}
                        for name, c in self._caches.items()}

    def _append_rows(self, new_caches: List[Dict[str, dict]]):
        stacks = ([self._caches] if self._caches is not None else []) \
            + new_caches
        if not stacks:
            return
        if len(stacks) == 1:
            self._caches = stacks[0]
            return
        self._caches = {name: {k: torch.cat([s[name][k] for s in stacks])
                               for k in stacks[0][name]}
                        for name in stacks[0]}

    def _first_token(self, req: Request) -> None:
        if req.generated == 0 and req.first_token_round < 0:
            req.first_token_round = self.round
            req.t_first = time.perf_counter() - self._t0

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One round boundary + (if there is work) one pipeline round.
        Returns False once every submitted request has retired."""
        eng = self.engine
        now = time.perf_counter() - self._t0
        for r in self.queue:
            if r.arrival_round <= self.round and r.t_arrival < 0:
                r.t_arrival = now
        admitted = self._admit()
        if not self.inflight and not admitted:
            if not self.queue:
                return False
            # idle gap: fast-forward to the next arrival (no weight stream)
            self.round = max(self.round + 1,
                             min(r.arrival_round for r in self.queue))
            return True

        fns, t0 = eng.fns, self._t0
        self.events.append((time.perf_counter() - t0, "round",
                            str(self.round)))
        tr = _tele.get_tracer()
        if tr.enabled:
            tr.instant("serve_round", round=self.round,
                       inflight=len(self.inflight) + len(admitted))
        eng._ensure_aux(self.ledger, self.events, t0)
        emb = eng._resident["embed"]
        decoders = list(self.inflight)
        # ---- the decode batch: stacked last tokens, ragged device pos
        dec_x = dec_pos = None
        if decoders:
            dec_x = fns["embed"](emb, eng.tokens([[r.tokens[-1]]
                                                  for r in decoders]))
            dec_pos = eng.tokens([r.pos for r in decoders])
        # ---- one prefill job per admission
        pre_xs = [fns["embed"](emb, eng.tokens([req.tokens]))
                  for req in admitted]
        dec_x, caches, pre_outs, pre_caches = eng.run_batch_round(
            self.ledger, self.events, t0, decode_x=dec_x,
            decode_caches=self._caches, decode_pos=dec_pos,
            prefill_xs=pre_xs, prefill_total=self.max_total_len)
        self._caches = caches

        # ---- heads: one greedy token per request this round (the only
        # host round trip: the token readback)
        head = eng._resident["head"]
        if dec_x is not None:
            nxt = torch.argmax(fns["head"](head, dec_x), -1).tolist()
            for row, req in enumerate(decoders):
                req.tokens.append(int(nxt[row]))
                req.generated += 1
        for i, req in enumerate(admitted):
            logits = fns["head"](head, pre_outs[i])            # (1, V)
            self._first_token(req)
            req.tokens.append(int(torch.argmax(logits, -1)[0]))
            req.generated += 1

        # ---- merge admissions, then retire finishers
        self._append_rows(pre_caches)
        self.inflight.extend(admitted)
        self._max_seen = max(self._max_seen, len(self.inflight))
        finished = [r for r in self.inflight if r.done]
        if finished:
            keep = [i for i, r in enumerate(self.inflight) if not r.done]
            self.inflight = [self.inflight[i] for i in keep]
            self._drop_rows(keep)
            self._retire(finished)
        self.round += 1
        return bool(self.inflight or self.queue)

    # ------------------------------------------------------------------
    def run(self) -> Tuple[Dict[int, np.ndarray], ServeStats]:
        """Drain the queue; returns ({rid: full token sequence}, stats)."""
        launches0 = dict(_ops.LAUNCHES)
        t_start = time.perf_counter()
        while self.step():
            pass
        lat = time.perf_counter() - t_start
        launches = {k: n - launches0[k] for k, n in _ops.LAUNCHES.items()}
        outs = {rid: np.asarray(r.tokens)
                for rid, r in sorted(self.done.items())}
        faults = _tele.counter_values("prefetch.retries",
                                      "prefetch.faults_absorbed")
        # every request retired: the request-scoped tiers must have
        # drained exactly (audit mode raises naming the leaking owner)
        self.ledger.audit_check_drained("stream", "kv_pages")
        stats = ServeStats(
            rounds=self.round, latency_s=lat, peak_bytes=self.ledger.peak,
            loads=sum(1 for e in self.events if e[1] == "load_end"),
            streamed_bytes=self.engine._streamed(self.events),
            new_tokens=sum(r.generated for r in self.done.values()),
            requests=len(self.done), max_inflight_seen=self._max_seen,
            cache_bytes_peak=self._cache_peak, events=self.events,
            seed=self.seed,
            retries=faults[0] - self._fault_base[0],
            faults_absorbed=faults[1] - self._fault_base[1],
            peak_breakdown=dict(self.ledger.peak_breakdown),
            kernel_launches=launches,
            policy=list(self.policy_log), **self._latency_stats())
        self._record_metrics(stats)
        return outs, stats

    def _record_metrics(self, stats: ServeStats) -> None:
        """Publish the session's headline stats into the metrics
        registry (serve.py's summary and ``--metrics-out`` read it)."""
        m = _tele.metrics()
        m.gauge("serve.rounds").set(stats.rounds)
        m.gauge("serve.requests").set(stats.requests)
        m.gauge("serve.new_tokens").set(stats.new_tokens)
        m.gauge("serve.tokens_per_s").set(stats.tokens_per_s)
        m.gauge("serve.streamed_bytes").set(stats.streamed_bytes)
        m.gauge("serve.ledger_peak_bytes").set(stats.peak_bytes)
        m.gauge("serve.cache_peak_bytes").set(stats.cache_bytes_peak)
        for owner, nbytes in stats.peak_breakdown.items():
            m.gauge(f"ledger.peak.{owner}_bytes").set(nbytes)

    def _latency_stats(self) -> Dict:
        """Round-based TTFT/TPOT percentiles (deterministic under a fixed
        trace) and their wall-clock mirrors."""
        ttfts, tpots, ttfts_s, tpots_s = [], [], [], []
        for r in self.done.values():
            if r.first_token_round < 0:
                continue
            ttfts.append(float(r.first_token_round - r.born_round + 1))
            tpots.append(float(r.finished_round - r.first_token_round)
                         / (r.generated - 1) if r.generated > 1 else 0.0)
            if r.t_first >= 0 and r.t_arrival >= 0:
                ttfts_s.append(r.t_first - r.t_arrival)
            if r.generated > 1 and r.t_done >= 0 and r.t_first >= 0:
                tpots_s.append((r.t_done - r.t_first) / (r.generated - 1))

        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

        m = _tele.metrics()
        for v in ttfts_s:
            m.histogram("serve.ttft_s").observe(v)
        for v in tpots_s:
            m.histogram("serve.tpot_s").observe(v)
        return dict(ttft_p50_rounds=pct(ttfts, 50),
                    ttft_p99_rounds=pct(ttfts, 99),
                    tpot_p50_rounds=pct(tpots, 50),
                    tpot_p99_rounds=pct(tpots, 99),
                    ttft_p50_s=pct(ttfts_s, 50), ttft_p99_s=pct(ttfts_s, 99),
                    tpot_p50_s=pct(tpots_s, 50), tpot_p99_s=pct(tpots_s, 99))

    # ------------------------------------------------------------------
    def warmup(self, prompt_lens=()) -> "BatchScheduler":
        """Run the serving modules once at every serving shape — the
        prefill per distinct prompt length and the stacked decode at every
        batch size up to ``max_inflight`` — so kernels are built and the
        allocator is warm before the timed loop."""
        eng = self.engine
        fns = eng.fns
        emb = eng._resident.get("embed") or eng._load("embed")
        head = eng._resident.get("head") or eng._load("head")
        w0 = eng._load(eng.layer_names[0])
        T = self.max_total_len
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.long,  # noqa
                                           device=eng.device)
        for s in sorted(set(int(p) for p in prompt_lens)):
            px, _ = fns["layer_cache"](w0, fns["embed"](emb, zeros(1, s)), T)
            fns["head"](head, px)
        _, c1 = fns["layer_cache"](w0, fns["embed"](emb, zeros(1, 1)), T)
        for r in range(1, self.max_inflight + 1):
            cr = {k: torch.cat([a] * r) for k, a in c1.items()}
            dr, _ = fns["layer_decode"](w0, fns["embed"](emb, zeros(r, 1)),
                                        cr, zeros(r))
            fns["head"](head, dr)
        eng._sync()
        del w0, emb, head
        self._t0 = time.perf_counter()
        return self
