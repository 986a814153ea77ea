"""Continuous-batching scheduler: one weight stream serves every request.

PyTorch port of ``repro/core/scheduler.py``.  PIPELOAD's
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
is FIFO within a priority class and blocks whenever the post-admission
decode floor

    other_bytes + pinned + all in-flight caches + one streaming layer

would exceed the budget, or the in-flight count would exceed
``max_inflight``.  A request's cache bytes are released the round it
finishes, so a queued request can be admitted at the same boundary.

All dense caches are padded to ``max_total_len`` slots so stacked decode
keeps one shape per batch size (padding past a request's position is
masked out exactly), so batched decoding is token-for-token identical to
sequential runs.  The stacked per-layer caches live on the engine's
device; rows are dropped and appended with ``index_select``/``cat`` at
round boundaries.

**Paged mode** (``page_size`` set, core/kv_pages.py): the KV ledger bytes
are carved into fixed-size pages mapped through per-request block tables.

  * Admission charges only the request's PROMPT pages; pages a live
    sibling already mapped through the ``PrefixTree`` are refcount bumps,
    so requests behind one system prompt charge its pages once.  The
    decode floor is pages actually mapped plus one page of headroom per
    in-flight request.
  * Decode grows a request one page at a time as its position crosses a
    page boundary; a write into a shared page copy-on-writes it first.
  * If growth cannot clear the floor, the lowest-priority YOUNGEST
    in-flight request is preempted: its pages are freed and it re-queues
    with its tokens so far (re-prefilled on re-admission).  The oldest
    request always fits alone (``submit`` enforced it), so serving never
    deadlocks.
  * Retirement drops one reference per page: pages shared with a live
    sibling survive until the last sharer retires.

Physical pages are one ``(rows, page_size, KV, dh)`` tensor per layer per
leaf on the engine's device, sized once (``max_inflight`` worst-case
tables + COW slack); the ledger charges only MAPPED pages.  Unlike the
reference, which rebinds new arrays, the pools are written IN PLACE: the
round's decode and chunk writes, the boundary's prefill scatter and its
copy-on-write copies.  Every one of them runs on the compute stream, and
the copies are made at the boundary before the round that writes the new
page.

**Chunked prefill** (``chunk_prefill=C``, paged mode; ``C`` rounds up to a
page multiple).  A prompt longer than ``C`` joins decode rounds as C-token
chunk jobs riding the stacked ``layer_verify_paged`` window, which writes
the chunk's K/V straight into the request's pages.  The final chunk slides
back to ``[L - C, L)``, re-feeding tokens whose K/V is already paged in,
and its last column feeds the head for the first generated token.

**Speculative serving** (``draft`` + ``spec_depth``, paged mode): a
``DraftModel`` pinned on the device for the whole session proposes
``spec_depth`` tokens per request per round from its own dense cache rows
(one per in-flight request, charged to ``spec_headroom``), and the round's
decode batch widens to each request's verify window ``[last committed,
proposals...]`` through ``layer_verify_paged``.  The accepted prefix plus
the target's own next token commit, so one weight stream advances a
request by up to ``spec_depth + 1`` tokens; every committed token is the
target's greedy pick.  A rejected proposal's K/V stays in the request's
own pages past its committed length, where no query reads it, until the
next round's window writes over it.

**Serving tier** (multi-tenant SLO serving on the mechanisms above):

  * *Priority classes with preemption.*  ``submit(..., priority=p)``
    orders the queue by ``(-priority, arrival_round, rid)``, and admission
    may bounce an in-flight request of a strictly lower class back to the
    queue, for a concurrency slot or for cache room, in paged and dense
    mode alike.  The victim is always the lowest-priority, youngest
    in-flight request, the order growth preemption uses too; preemption
    only flows downhill, so a boundary's admission loop ends.
  * *Per-tenant prefix namespaces.*  ``submit(..., tenant=t)`` keys the
    prefix index by tenant (``PrefixNamespaces``): prompt pages share
    within a tenant, never across.
  * *SLO accounting and shedding.*  ``slo=SLO(...)`` sets TTFT / TPOT
    targets in ROUNDS, the deterministic clock; ``ServeStats`` reports
    their p50 / p99 in rounds and seconds and goodput under the SLO, and
    ``SLO.shed=True`` rejects a queued request at admission once its TTFT
    target is out of reach.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import telemetry as _tele
from repro_torch.core.engine import DraftModel, PipeloadEngine, _Ledger
from repro_torch.core.kv_pages import (BlockTable, PagePool,
                                       PrefixNamespaces, pages_for)
from repro_torch.kernels import ops as _ops
from repro_torch.models.attention import empty_cache


@dataclasses.dataclass(frozen=True)
class SLO:
    """Service-level objectives in ROUNDS, the scheduler's deterministic
    clock, so a replayed trace attains or misses them identically on any
    machine (policy never reads the wall clock).

    ``ttft_rounds``: a request attains its TTFT target when its first token
    lands within that many rounds of arrival (inclusive: 1 means the
    arrival round itself).  ``tpot_rounds``: mean rounds per token after
    the first.  ``shed=True`` rejects a queued request at admission once
    its TTFT target is out of reach (its queueing delay plus its own
    prefill rounds already exceed it)."""
    ttft_rounds: Optional[int] = None
    tpot_rounds: Optional[float] = None
    shed: bool = False


@dataclasses.dataclass
class Request:
    """One generation request; scheduler-owned fields below ``rid``."""
    rid: int
    prompt: np.ndarray            # (S,) int token ids
    max_new_tokens: int
    arrival_round: int = 0        # earliest boundary it may be admitted at
    priority: int = 0             # higher = admitted (and kept) first
    tenant: str = "default"       # prefix-namespace key
    # -- scheduler state ------------------------------------------------
    tokens: List[int] = dataclasses.field(default_factory=list)
    generated: int = 0
    admitted_round: int = -1
    finished_round: int = -1
    cache_bytes: int = 0          # ledger reservation while in flight
    table: Optional[BlockTable] = None   # paged mode: page ids + n_shared
    draft_pos: int = 0            # speculative: draft cache slots valid
    # -- chunked prefill ------------------------------------------------
    prefilling: bool = False      # True while chunks are still feeding
    prefill_pos: int = 0          # tokens whose K/V is already paged in
    born_round: int = 0           # original arrival (preemption re-queues
                                  # move arrival_round; TTFT uses this)
    first_token_round: int = -1
    rejected: bool = False        # shed by SLO admission control
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
    # paged-KV extras (0 / dense defaults when page_size is unset)
    page_size: int = 0
    pages_allocated: int = 0       # pool allocs (fresh + free-list reuse)
    page_reuses: int = 0           # allocs served from the free list
    prefix_hit_pages: int = 0      # prompt pages shared via the PrefixTree
    cow_copies: int = 0            # copy-on-write page swaps
    preemptions: int = 0           # requests bounced back to the queue
    pool_pages_peak: int = 0       # high-water MAPPED page count
    # expert-streaming extras (0 for dense / whole-layer MoE serving)
    expert_hits: int = 0
    expert_misses: int = 0
    expert_evictions: int = 0
    expert_cache_bytes: int = 0
    unique_experts_per_round: float = 0.0
    # speculative-decoding extras (0 when spec_depth is unset)
    spec_depth: int = 0            # draft tokens proposed per round
    spec_rounds: int = 0           # verify rounds executed
    draft_tokens: int = 0          # proposals the draft emitted
    accepted_tokens: int = 0       # proposals the target committed
    # serving-tier extras (SLO / multi-tenant / chunked prefill)
    tenants: int = 0               # distinct tenant namespaces served
    chunk_size: int = 0            # chunked-prefill chunk tokens (0 = off)
    chunk_jobs: int = 0            # prefill chunks joined into rounds
    ttft_p50_rounds: float = 0.0   # rounds from arrival to first token
    ttft_p99_rounds: float = 0.0
    tpot_p50_rounds: float = 0.0   # rounds per subsequent token
    tpot_p99_rounds: float = 0.0
    ttft_p50_s: float = 0.0        # wall-clock mirrors
    ttft_p99_s: float = 0.0
    tpot_p50_s: float = 0.0
    tpot_p99_s: float = 0.0
    slo_attained: float = 1.0      # fraction of requests meeting the SLO
    goodput_tokens: int = 0        # tokens from requests meeting the SLO
    slo_rejections: int = 0        # requests shed at admission
    # (kind, rid, round, t_wall) for every admit / preempt / retire /
    # reject decision
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

    @property
    def goodput_tokens_per_s(self) -> float:
        """Goodput under the SLO: only tokens of requests that met every
        target count."""
        return (self.goodput_tokens / self.latency_s
                if self.latency_s else 0.0)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft proposals the target accepted."""
        return (self.accepted_tokens / self.draft_tokens
                if self.draft_tokens else 0.0)

    @property
    def expert_hit_rate(self) -> float:
        """Fraction of expert activations served from the ExpertCache."""
        total = self.expert_hits + self.expert_misses
        return self.expert_hits / total if total else 0.0

    def event_log(self, kinds=None):
        return [e for e in self.events if kinds is None or e[1] in kinds]


class BatchScheduler:
    """Round-boundary continuous batching over a ``PipeloadEngine``.

    ``max_total_len`` bounds every request's prompt + generation length
    and fixes the padded cache shape; ``max_inflight`` caps concurrency,
    and the budget caps it further through admission control.
    ``page_size`` (default: the engine's) turns on paged KV,
    ``prefix_cache`` its prefix sharing, ``chunk_prefill`` chunked prefill
    in paged mode, ``draft`` with ``spec_depth`` speculative serving
    in paged mode, and ``slo`` (an ``SLO`` in rounds) the serving tier's
    accounting and shedding."""

    def __init__(self, engine: PipeloadEngine, *, max_inflight: int = 4,
                 max_total_len: int = 128, page_size: Optional[int] = None,
                 prefix_cache: bool = True, seed: Optional[int] = None,
                 draft: Optional[DraftModel] = None, spec_depth: int = 0,
                 chunk_prefill: int = 0, slo: Optional[SLO] = None):
        if engine.mode == "baseline":
            raise ValueError("continuous batching needs a pipelined mode "
                             "(pipeload / pipeswitch)")
        self.engine = engine
        self.max_inflight = max(1, max_inflight)
        self.max_total_len = max_total_len
        # paged KV: an explicit page_size wins, else the engine's (the
        # planner threads its pick through the engine); 0/None = dense
        if page_size is None:
            page_size = engine.page_size
        self.page_size = page_size if page_size and page_size > 0 else None
        # speculative serving: a pinned draft proposes spec_depth tokens per
        # round per request and one stacked verify round scores them
        self.spec_depth = max(0, spec_depth) if draft is not None else 0
        self.draft = draft if self.spec_depth else None
        if self.spec_depth:
            if not self.page_size:
                raise ValueError(
                    "speculative serving needs paged KV (the verify "
                    "window rides the block tables); set page_size")
            if "layer_verify_paged" not in engine.fns:
                raise ValueError(
                    "engine's model fns lack layer_verify_paged "
                    "(speculative verify); architecture unsupported")
            if draft.device != engine.device:
                raise ValueError(
                    f"the draft runs on {draft.device}, the engine on "
                    f"{engine.device}: build both on one device")
        # chunked prefill: prompts longer than ``chunk`` tokens prefill C
        # tokens per round through the stacked verify window
        self.chunk = 0
        if chunk_prefill and chunk_prefill > 0:
            if not self.page_size:
                raise ValueError(
                    "chunked prefill needs paged KV (chunks write K/V "
                    "through the block tables); set page_size")
            if self.spec_depth:
                raise ValueError(
                    "chunked prefill and speculative serving are "
                    "mutually exclusive (both reshape the round); pick "
                    "one")
            if "layer_verify_paged" not in engine.fns:
                raise ValueError(
                    "engine's model fns lack layer_verify_paged (the "
                    "chunk window); architecture unsupported for "
                    "chunked prefill")
            # page-aligned: a chunk never splits a page's writes across
            # rounds
            ps = self.page_size
            self.chunk = -(-int(chunk_prefill) // ps) * ps
        self.slo = slo
        self.slo_rejections = 0
        self.policy_log: List[Tuple[str, int, int, float]] = []
        self._chunk_jobs = 0
        m = _tele.metrics()
        self._m_admits = m.counter("sched.admits")
        self._m_preempts = m.counter("sched.preemptions")
        self._m_retires = m.counter("sched.retires")
        self._m_rejects = m.counter("sched.rejections")
        self._fault_base = _tele.counter_values("prefetch.retries",
                                                "prefetch.faults_absorbed")
        self.seed = seed
        self.queue: List[Request] = []   # by (-priority, arrival, rid)
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
        # ---- paged-KV state (unused in dense mode) ----
        self.pool: Optional[PagePool] = None
        self.tree: Optional[PrefixNamespaces] = None
        self._pools: Optional[Dict[str, dict]] = None  # layer -> (P, ps, ..)
        self.preemptions = 0
        if self.page_size:
            if engine.expert is not None:
                raise ValueError(
                    "paged KV serving is not supported with expert-split "
                    "MoE checkpoints yet; repartition whole-layer or drop "
                    "page_size")
            ps = self.page_size
            # the verify window writes K/V for [pos, pos + depth]; the last
            # round's can run past max_total_len, so tables carry those
            # slots (masked garbage, freed at retirement)
            self._nb = pages_for(max_total_len + self.spec_depth, ps)
            self._page_bytes = (len(engine.layer_names)
                                * engine.cfg.cache_bytes(1, ps))
            self.pool = PagePool(ps, self._page_bytes, self.ledger)
            self.tree = PrefixNamespaces(ps) if prefix_cache else None
        # ---- speculative state (the draft pinned for the whole session;
        # its cache rows parallel to self.inflight)
        self._draft_caches: Optional[Dict[str, dict]] = None  # (R, T, ...)
        self._spec_rounds = 0
        self._draft_tokens = 0
        self._accepted_tokens = 0
        if self.spec_depth:
            # growth headroom per request: a verify round can map a whole
            # window of fresh pages at once
            self._req_headroom = pages_for(self.spec_depth + 1,
                                           self.page_size)
            self._draft_total = max_total_len + self.spec_depth
            self._draft_cache_bytes = self.draft.cache_bytes(
                1, self._draft_total)
            self.draft.pin(self.ledger)
        else:
            self._req_headroom = 1 if self.page_size else 0
        self._draft_pinned = self.spec_depth > 0
        self._expert_snap = (engine.expert.snapshot()
                             if engine.expert is not None else None)
        # the widest fetch this workload can lock (a max-length prompt's
        # prefill): admission may shrink the ExpertCache to this, never
        # below, and submit-time feasibility reasons from it
        self._expert_floor = (
            engine.expert.working_set_bytes(max_total_len)
            if engine.expert is not None else None)

    # ------------------------------------------------------------------
    def close(self):
        """End the serving session: unpin the draft (its ledger bytes and
        its device copies) and tear down the engine's prefetch runtime.
        Idempotent."""
        if self.draft is not None and self._draft_pinned:
            self._draft_caches = None
            self.draft.unpin(self.ledger)
            self._draft_pinned = False
        self.engine.close()

    def __enter__(self) -> "BatchScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               arrival_round: int = 0, *, priority: int = 0,
               tenant: str = "default") -> int:
        """Queue a request; returns its id.  ``priority`` orders admission
        (higher first, FIFO within a class), and a strictly higher class
        may preempt the lowest-priority youngest in-flight request to get
        in; ``tenant`` names the prefix namespace its prompt pages share
        within.  Raises if it could NEVER be admitted: too long for
        ``max_total_len``, or a cache reservation above the budget floor
        even with nothing else in flight (paged mode: every page of its
        final length, unshared, plus the admission headroom)."""
        prompt = np.asarray(prompt).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.max_total_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_total_len "
                f"{self.max_total_len}")
        if self.page_size:
            # the guarantee growth-with-preemption leans on: a request
            # ALONE can always map its next page (its whole verify window
            # in speculative mode, where the draft and its cache row are
            # charged as extra residents too)
            per_req = ((pages_for(len(prompt) + max_new_tokens
                                  + self.spec_depth, self.page_size)
                        + self._req_headroom) * self._page_bytes)
        else:
            per_req = self._per_req_cache
        self.engine._check_kv_budget(per_req, inflight=1,
                                     expert_floor=self._expert_floor,
                                     extra_resident=self._spec_resident(1))
        arrival = max(arrival_round, 0)
        req = Request(self._next_rid, prompt, max_new_tokens,
                      arrival_round=arrival, priority=int(priority),
                      tenant=str(tenant), cache_bytes=per_req,
                      born_round=arrival)
        self._next_rid += 1
        self.queue.append(req)
        self._sort_queue()
        return req.rid

    def _sort_queue(self) -> None:
        """Higher classes first, FIFO by arrival within a class (a
        preempted request re-enters with arrival_round = now, behind its
        class's newest arrivals)."""
        self.queue.sort(key=lambda r: (-r.priority, r.arrival_round, r.rid))

    def _tree(self, req: Request):
        """The request's tenant namespace of the prefix index (None when
        prefix caching is off)."""
        return self.tree.tree(req.tenant) if self.tree is not None else None

    def _fits(self, extra_cache: int) -> bool:
        """Would the decode floor still clear the budget after granting
        ``extra_cache`` more cache bytes?  When it misses only because the
        ExpertCache holds the headroom, the cache shrinks first (LRU
        eviction releasing ledger bytes, the cache's ``S_dest``), so a
        queued request's cache wins over cold experts."""
        eng = self.engine
        if eng.budget is None:
            return True
        # until the expert engine is bound to THIS session's ledger its
        # live reservation does not count here: reason from the
        # workload's expert floor, so early admissions leave room for the
        # cache's minimum working set
        pre_bind = (eng.expert is not None
                    and not eng.expert.bound_to(self.ledger))
        kw = {"expert_floor": self._expert_floor} if pre_bind else {}
        floor = eng._kv_floor(self._cache_resident + extra_cache, **kw)
        if floor <= eng.budget:
            return True
        if eng.expert is not None and not pre_bind:
            if eng.expert.release_headroom(floor - eng.budget,
                                           floor=self._expert_floor):
                floor = eng._kv_floor(self._cache_resident + extra_cache)
                return floor <= eng.budget
        return False

    # ---- paged-mode admission / growth / preemption ------------------
    def _spec_resident(self, inflight: int) -> int:
        """Speculative mode's extra resident bytes: the pinned draft plus
        one dense draft-cache row per in-flight request."""
        if not self.spec_depth:
            return 0
        return self.draft.total_bytes + inflight * self._draft_cache_bytes

    def _fits_paged(self, extra_pages: int, inflight_after: int,
                    rows: Optional[int] = None) -> bool:
        """Paged decode floor: pages actually mapped, plus the new pages,
        plus growth headroom per in-flight request (one page; a whole
        verify window of pages in speculative mode, where the pinned draft
        and ``rows`` draft-cache rows, by default one per in-flight
        request, are charged as extra residents too)."""
        eng = self.engine
        if eng.budget is None:
            return True
        cache = ((self.pool.mapped_pages + extra_pages
                  + inflight_after * self._req_headroom)
                 * self._page_bytes)
        rows = inflight_after if rows is None else rows
        return eng._kv_floor(cache, extra_resident=self._spec_resident(
            rows)) <= eng.budget

    def _admit_one_paged(self, req: Request, inflight_after: int) -> bool:
        """Map the request's prompt pages (prefix-tree hits are refcount
        bumps, charged once across the fleet); False = does not fit at
        this boundary."""
        toks = req.tokens or [int(t) for t in req.prompt]
        n_pages = pages_for(len(toks), self.page_size)
        tree = self._tree(req)      # the tenant's own namespace
        walk = tree.walk(toks) if tree is not None else None
        shared = len(walk[0]) if walk is not None else 0
        if not self._fits_paged(n_pages - shared, inflight_after):
            return False
        self.pool.detail = f"req{req.rid}"
        if tree is not None:
            pids, n_shared = tree.insert(toks, self.pool, walk=walk)
        else:
            pids, n_shared = [self.pool.alloc()
                              for _ in range(n_pages)], 0
        self.pool.detail = None
        req.table = BlockTable(pids, n_shared)
        req.tokens = toks
        if self.chunk and len(toks) > self.chunk:
            # long prompt: feed it C tokens per round as chunk jobs (its
            # pages are all mapped already; chunking spreads the COMPUTE)
            req.prefilling = True
            req.prefill_pos = 0
        if self.spec_depth:
            # the request's dense draft-cache row lives while it is in
            # flight (never blocks: _fits_paged charged it, and at a
            # boundary nothing streams)
            self.ledger.acquire(self._draft_cache_bytes,
                                owner="spec_headroom",
                                detail=f"req{req.rid}")
        return True

    def _reserve(self, req: Request, inflight_after: int) -> bool:
        """Try to reserve the request's cache at this boundary (maps pages
        / acquires the dense reservation on success)."""
        if self.page_size:
            return self._admit_one_paged(req, inflight_after)
        if not self._fits(req.cache_bytes):
            return False
        # never blocks: _fits checked the floor, and at a boundary nothing
        # is streaming
        self.ledger.acquire(req.cache_bytes, owner="kv_pages",
                            detail=f"req{req.rid}")
        self._cache_resident += req.cache_bytes
        self._cache_peak = max(self._cache_peak, self._cache_resident)
        req.tokens = req.tokens or list(map(int, req.prompt))
        return True

    def _preempt(self, victim: Request) -> None:
        """Bounce ``victim`` back to the queue, releasing its ledger bytes
        exactly (its pages in paged mode, with its draft-cache row in
        speculative mode; the whole dense reservation and its rows of the
        stacked caches otherwise); it re-prefills from its tokens so far on
        re-admission."""
        idx = self.inflight.index(victim)
        keep = [i for i in range(len(self.inflight)) if i != idx]
        if self.page_size:
            self.pool.detail = f"req{victim.rid}"
            victim.table.release_all(self.pool, self._tree(victim))
            self.pool.detail = None
            if self.spec_depth:
                self._draft_caches = self._rows_keep(self._draft_caches,
                                                     keep)
                self.ledger.release(self._draft_cache_bytes,
                                    owner="spec_headroom",
                                    detail=f"req{victim.rid}")
        else:
            self.ledger.release(victim.cache_bytes, owner="kv_pages",
                                detail=f"req{victim.rid}")
            self._cache_resident -= victim.cache_bytes
            self._caches = self._rows_keep(self._caches, keep)
        self.inflight.pop(idx)
        victim.admitted_round = -1
        victim.arrival_round = self.round
        victim.prefilling = False
        victim.prefill_pos = 0
        self.queue.append(victim)
        self._sort_queue()
        self.preemptions += 1
        now = time.perf_counter() - self._t0
        self.events.append((now, "preempt", f"req{victim.rid}"))
        self.policy_log.append(("preempt", victim.rid, self.round, now))
        self._m_preempts.inc()
        tr = _tele.get_tracer()
        if tr.enabled:
            tr.instant("preempt", rid=victim.rid, round=self.round)

    def _victim(self, below: Optional[int] = None) -> Optional[Request]:
        """The preemption victim: lowest priority first, the youngest
        admission within a class (all priorities equal: the youngest).
        ``below`` restricts it to strictly lower classes (admission
        preemption flows downhill only); growth passes None and may pick
        any request, the grower included."""
        cands = [r for r in self.inflight
                 if below is None or r.priority < below]
        if not cands:
            return None
        order = {id(r): i for i, r in enumerate(self.inflight)}
        return min(cands, key=lambda r: (r.priority, -order[id(r)]))

    def _alloc_with_preemption(self, req: Request) -> Optional[int]:
        """Map one more page for ``req``, preempting the lowest-priority
        YOUNGEST in-flight request (``_victim``), possibly ``req`` itself,
        while the floor would not clear: within a class an older request's
        progress is never sacrificed for a younger grower.  Returns None
        when ``req`` was the victim; otherwise always succeeds, since once
        ``req`` is alone, ``submit`` guaranteed its worst case fits.

        The floor counts the draft-cache rows of every request in flight,
        which the ledger holds.  The reference counts none here, so a
        speculative session whose pages grow to within those rows of the
        budget parks its loaders on ``S_stop`` for good; the port preempts
        instead."""
        while (not self._fits_paged(1, 0, rows=len(self.inflight))
               and len(self.inflight) > 1):
            victim = self._victim()
            self._preempt(victim)
            if victim is req:
                return None
        self.pool.detail = f"req{req.rid}"
        pid = self.pool.alloc()
        self.pool.detail = None
        return pid

    def _grow_pages(self):
        """Round boundary, before admission: map each in-flight decoder's
        WRITE RANGE (the page its next token lands in, or in speculative
        mode every page the verify window [pos, pos + depth] touches),
        growing across page boundaries and copy-on-writing shared pages
        before their first divergent write.  The copies land on the
        compute stream here, before the round that writes the new
        pages."""
        if not self.inflight:
            return
        ps = self.page_size
        cow: List[Tuple[Request, int, int]] = []
        for req in list(self.inflight):
            if req not in self.inflight:    # preempted by an earlier grower
                continue
            if req.prefilling:
                # every page was mapped at admission; chunk writes land in
                # the request's own prompt pages (or rewrite shared pages
                # with the bytes a sibling wrote)
                continue
            t = req.table
            lo = req.pos // ps
            hi = (req.pos + self.spec_depth) // ps
            while len(t.pages) <= hi:
                pid = self._alloc_with_preemption(req)
                if pid is None:             # req itself was the victim
                    break
                t.pages.append(pid)
            for idx in range(lo, hi + 1):
                if req not in self.inflight:
                    break
                old = t.pages[idx]
                if not self.pool.is_shared(old):
                    continue
                new = self._alloc_with_preemption(req)
                if new is None:             # req preempted: refs already
                    break                   # dropped by release_all
                cow.append((req, old, new))
                # usually the sibling keeps the old page; if the COW alloc
                # preempted that sibling, this drop is the LAST reference
                # and the node of the owner's tenant tree goes with it
                tree = self._tree(req)
                if self.pool.release(old) and tree is not None:
                    tree.forget(old)
                t.pages[idx] = new
        # drop copies whose OWNER was preempted after queuing them (its
        # freed target id may already be re-mapped by a later grower, and
        # the batched copy would write one destination twice)
        cow = [(o, n) for r, o, n in cow if r in self.inflight]
        self.pool.stats.cow_copies += len(cow)   # copies actually made
        self.pool._m_cow.inc(len(cow))
        tr = _tele.get_tracer()
        if tr.enabled and cow:
            tr.instant("page_cow", copies=len(cow), round=self.round)
        if cow:
            self._ensure_pool_arrays()      # rows for the new page ids
            dev = self.engine.device
            old = torch.as_tensor([o for o, _ in cow], device=dev)
            new = torch.as_tensor([n for _, n in cow], device=dev)
            for c in self._pools.values():
                for a in c.values():
                    a[new] = a[old]

    def _pool_like(self, rows: int) -> Dict[str, torch.Tensor]:
        """One layer's zeroed physical pages, shaped for its cache leaves
        (B, T, ...) -> (rows, page_size, ...) in the model dtype on the
        engine's device: GQA's {k, v} (rows, page_size, KV, dh), MLA's
        {c, kr}.  The ONE place the pool layout is defined."""
        return empty_cache(self.engine.cfg, rows, self.page_size,
                           device=self.engine.device)

    def _ensure_pool_arrays(self):
        """Give every layer one physical row per page id handed out so
        far, before anything writes the new ids.  Ids are reused from the
        free list before the pool hands out a fresh one, so the rows are
        the pool's mapped high-water mark: the bytes the ledger charged at
        its most pages.  Growing copies one layer's leaf at a time."""
        rows = max(self.pool.capacity, 1)
        if self._pools is None:
            self._pools = {name: self._pool_like(rows)
                           for name in self.engine.layer_names}
            return
        for pool in self._pools.values():
            for leaf, a in pool.items():
                if a.shape[0] < rows:
                    pool[leaf] = torch.cat(
                        [a, a.new_zeros((rows - a.shape[0],) + a.shape[1:])])

    def _prefill_sink(self, reqs: List[Request]):
        """A ``run_batch_round`` sink that writes each layer's captured
        prefill caches into the requests' OWNED pages as soon as the layer
        has run, one batched scatter per leaf.  The reference writes them
        after the round; nothing reads these pages before then, so the
        bytes are the same, and only one layer's dense capture is alive at
        a time.  Shared prefix pages are skipped: a sibling already wrote
        them, and a shared partial page may hold the sibling's generated
        tokens past this prompt (masked by the length, clobbered by
        nothing)."""
        ps = self.page_size
        owned = [i for i, r in enumerate(reqs)
                 if len(r.table.pages) > r.table.n_shared]
        if not owned:                   # nothing to write (or no prefill)
            return lambda name, caches: None
        pids = torch.as_tensor([pid for i in owned
                                for pid in reqs[i].table.pages[
                                    reqs[i].table.n_shared:]],
                               device=self.engine.device)

        def rows(a, t):
            lo, hi = t.n_shared * ps, len(t.pages) * ps
            return a[0, lo:hi].reshape((len(t.pages) - t.n_shared, ps)
                                       + tuple(a.shape[2:]))

        def sink(name: str, caches: List[dict]) -> None:
            for leaf, a in self._pools[name].items():
                a[pids] = torch.cat([rows(caches[i][leaf], reqs[i].table)
                                     for i in owned]).to(a.dtype)
        return sink

    def _tables(self, reqs: List[Request]) -> torch.Tensor:
        """The rows' block tables, padded with page 0, as ONE int32
        device tensor per round (every layer reads the same one)."""
        tb = np.zeros((len(reqs), self._nb), np.int32)
        for i, r in enumerate(reqs):
            tb[i, :len(r.table.pages)] = r.table.pages
        return torch.from_numpy(tb).to(self.engine.device)

    def _chunk_rounds(self, req: Request) -> int:
        """Rounds this request's prefill takes once admitted: 1 for the
        monolithic path, ``ceil(L / C)`` chunk rounds otherwise."""
        n = len(req.tokens) or len(req.prompt)
        if not (self.chunk and self.page_size and n > self.chunk):
            return 1
        return -(-n // self.chunk)

    def _shed(self, req: Request) -> bool:
        """SLO admission control: reject a queued request whose TTFT target
        is out of reach even if admitted at this boundary (its queueing
        delay plus its own prefill rounds already exceed it)."""
        if (self.slo is None or not self.slo.shed
                or self.slo.ttft_rounds is None):
            return False
        if req.first_token_round >= 0:
            # a preempted request already has its first token: its TTFT
            # is decided, so it is never shed
            return False
        best_ttft = (self.round - req.born_round) + self._chunk_rounds(req)
        if best_ttft <= self.slo.ttft_rounds:
            return False
        self.queue.remove(req)
        req.rejected = True
        req.finished_round = self.round
        self.done[req.rid] = req
        self.slo_rejections += 1
        now = time.perf_counter() - self._t0
        self.events.append((now, "reject", f"req{req.rid}"))
        self.policy_log.append(("reject", req.rid, self.round, now))
        self._m_rejects.inc()
        tr = _tele.get_tracer()
        if tr.enabled:
            tr.instant("reject", rid=req.rid, round=self.round)
        return True

    def _admit(self) -> List[Request]:
        """Priority-ordered admission at the current boundary: strict
        head-of-line within the eligible queue (sorted by class, FIFO
        inside one).  Skipping the head never helps (dense mode reserves
        one padded size for everyone; paged mode's head is also the next
        to shrink via sharing), and blocking is deadlock-free (``submit``
        rejected anything that cannot fit alone).  The head is shed first
        if its TTFT target is out of reach; a head that does not fit may
        preempt strictly-lower-priority in-flight requests (``_victim``)
        for a concurrency slot, then for cache room."""
        admitted: List[Request] = []
        while self.queue:
            eligible = [r for r in self.queue
                        if r.arrival_round <= self.round]
            if not eligible:
                break
            req = eligible[0]           # queue order: class, then FIFO
            if self._shed(req):
                continue
            if len(self.inflight) + len(admitted) >= self.max_inflight:
                victim = self._victim(below=req.priority)
                if victim is None:
                    break
                self._preempt(victim)
                continue                # the victim re-queued: look again
            ok = self._reserve(req, len(self.inflight) + len(admitted) + 1)
            while not ok:
                victim = self._victim(below=req.priority)
                if victim is None:
                    break
                self._preempt(victim)
                ok = self._reserve(req,
                                   len(self.inflight) + len(admitted) + 1)
            if not ok:
                break
            self.queue.remove(req)
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
        completes so the next boundary can re-grant them.  Paged mode
        drops one reference per page: pages shared with a live sibling
        survive until the LAST sharer retires."""
        for req in finished:
            if self.page_size:
                self.pool.detail = f"req{req.rid}"
                req.table.release_all(self.pool, self._tree(req))
                self.pool.detail = None
                if self.spec_depth:
                    self.ledger.release(self._draft_cache_bytes,
                                        owner="spec_headroom",
                                        detail=f"req{req.rid}")
            else:
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

    # ---- stacked cache rows, parallel to self.inflight: the dense KV
    # caches, and in speculative mode the draft's
    def _rows_keep(self, stack, keep: List[int]):
        """Keep rows ``keep`` of a stacked cache dict (leaves (R, T, ...)),
        layer by layer in place, so each layer's old rows are freed as
        soon as its kept rows are copied: the copy is never all layers at
        once.  None when no row is left."""
        if stack is None or not keep:
            return None
        idx = torch.as_tensor(keep, dtype=torch.long,
                              device=self.engine.device)
        for name, c in stack.items():
            stack[name] = {k: a.index_select(0, idx) for k, a in c.items()}
        return stack

    @staticmethod
    def _rows_concat(stacks):
        """Concatenate stacked cache dicts (None entries skipped) along the
        row dim, layer by layer, dropping each layer's sources once merged:
        the merge holds at most one layer's cache twice, not the whole
        reservation."""
        stacks = [s for s in stacks if s is not None]
        if len(stacks) < 2:
            return stacks[0] if stacks else None
        merged = {}
        for name in list(stacks[0]):
            merged[name] = {k: torch.cat([s[name][k] for s in stacks])
                            for k in stacks[0][name]}
            for s in stacks:
                del s[name]
        return merged

    def _draft_propose(self) -> List[List[int]]:
        tr = _tele.get_tracer()
        if not tr.enabled:
            return self._draft_propose_inner()
        with tr.span("draft_propose", rows=len(self.inflight),
                     depth=self.spec_depth):
            return self._draft_propose_inner()

    def _draft_propose_inner(self) -> List[List[int]]:
        """One stacked draft pass over every in-flight request: catch the
        draft cache up to the committed tokens, then chain ``spec_depth``
        greedy proposals per row.

        Rows may need different catch-up counts (1 after a partial accept,
        2 after a full accept: the bonus token was never drafted).  The
        batch feeds every row its last ``C = max(gap)`` committed tokens at
        their own slots: rows with a smaller gap RE-feed tokens already in
        their draft cache, rewriting those slots with the K/V of the same
        token at the same position, so one stacked step serves the ragged
        batch."""
        reqs = self.inflight
        c = max(len(r.tokens) - r.draft_pos for r in reqs)
        logits = None
        for i in range(c):
            toks = [[r.tokens[len(r.tokens) - c + i]] for r in reqs]
            pos = [len(r.tokens) - c + i for r in reqs]
            logits, self._draft_caches = self.draft.decode_batch(
                toks, self._draft_caches, pos)
        for r in reqs:
            r.draft_pos = len(r.tokens)
        props: List[List[int]] = [[] for _ in reqs]
        cur = torch.argmax(logits, -1)                          # (R,)
        for j in range(self.spec_depth):
            for i, t in enumerate(cur.tolist()):
                props[i].append(t)
            if j < self.spec_depth - 1:
                pos = [len(r.tokens) + j for r in reqs]
                logits, self._draft_caches = self.draft.decode_batch(
                    cur[:, None], self._draft_caches, pos)
                cur = torch.argmax(logits, -1)
        return props

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
        if self.page_size:
            # map every decoder's write page first (may preempt), THEN
            # admit into whatever room is left
            self._grow_pages()
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
        # round shape: DECODERS advance one token through the stacked
        # decode batch; CHUNKERS (mid chunked prefill, plus this boundary's
        # long-prompt admissions) feed one C-token window each; the other
        # admissions run the monolithic cache-capturing prefill
        decoders = [r for r in self.inflight if not r.prefilling]
        chunkers = ([r for r in self.inflight if r.prefilling]
                    + [r for r in admitted if r.prefilling])
        pre_admits = [r for r in admitted if not r.prefilling]
        # ---- the decode batch: stacked last tokens, ragged device pos;
        # speculative mode widens each row to its verify window [last
        # committed token, draft proposals...]
        dec_x = dec_pos = props = None
        if decoders:
            if self.spec_depth:
                # spec mode never chunks (the constructor enforces it), so
                # the decode rows stay parallel to self.inflight
                props = self._draft_propose()
                rows = [[r.tokens[-1]] + props[i]
                        for i, r in enumerate(decoders)]
            else:
                rows = [[r.tokens[-1]] for r in decoders]
            dec_x = fns["embed"](emb, eng.tokens(rows))
            dec_pos = eng.tokens([r.pos for r in decoders])
        # ---- the chunk batch: row i feeds C tokens at [start, start + C);
        # the FINAL chunk slides back to [L - C, L), re-feeding tokens
        # whose K/V is already paged in
        chunk_x = chunk_tables = chunk_pos = None
        chunk_meta: List[Tuple[Request, int]] = []   # (req, window_end)
        if chunkers:
            c = self.chunk
            rows, starts = [], []
            for r in chunkers:
                w0 = min(r.prefill_pos, len(r.tokens) - c)
                rows.append(r.tokens[w0:w0 + c])
                starts.append(w0)
                chunk_meta.append((r, w0 + c))
            chunk_x = fns["embed"](emb, eng.tokens(rows))
            chunk_pos = eng.tokens(starts)
            chunk_tables = self._tables(chunkers)
            self._chunk_jobs += len(chunkers)
            if tr.enabled:
                for r, end in chunk_meta:
                    tr.instant("chunk_job", rid=r.rid, round=self.round,
                               end=end)
        # ---- one prefill job per monolithic admission
        pre_xs = [fns["embed"](emb, eng.tokens([req.tokens]))
                  for req in pre_admits]

        if self.page_size:
            # rows for every page mapped at this boundary, before the
            # round (and the prefill scatter after it) writes them
            self._ensure_pool_arrays()
            paged_work = dec_x is not None or chunk_x is not None
            dec_x, _, pre_outs, _, chunk_out = eng.run_batch_round(
                self.ledger, self.events, t0, decode_x=dec_x,
                decode_pos=dec_pos, prefill_xs=pre_xs,
                prefill_total=self._nb * self.page_size,
                paged_pools=self._pools if paged_work else None,
                decode_tables=(self._tables(decoders) if decoders
                               else None),
                chunk_x=chunk_x, chunk_tables=chunk_tables,
                chunk_pos=chunk_pos,
                prefill_sink=self._prefill_sink(pre_admits))
        else:
            dec_x, caches, pre_outs, pre_caches, chunk_out = \
                eng.run_batch_round(
                    self.ledger, self.events, t0, decode_x=dec_x,
                    decode_caches=self._caches, decode_pos=dec_pos,
                    prefill_xs=pre_xs, prefill_total=self.max_total_len)
            self._caches = caches

        # ---- heads: one greedy token per request this round, or in
        # speculative mode the accepted proposal prefix plus the target's
        # bonus token (the token readbacks are the round's host round
        # trips)
        head = eng._resident["head"]
        if dec_x is not None and self.spec_depth:
            greedy = torch.argmax(fns["head_all"](head, dec_x),
                                  -1).tolist()                 # (R, W)
            self._spec_rounds += 1
            for row, req in enumerate(decoders):
                prop = props[row]
                a = 0
                while a < len(prop) and prop[a] == greedy[row][a]:
                    a += 1
                # accepted prefix + the target's token after it, clamped to
                # the request's remaining allowance (any prefix of it is
                # the exact greedy continuation)
                remaining = req.max_new_tokens - req.generated
                commit = (prop[:a] + [greedy[row][a]])[:remaining]
                old_len = len(req.tokens)
                req.tokens.extend(commit)
                req.generated += len(commit)
                # draft slots old_len..old_len+depth-2 hold the proposals'
                # K/V; they stay valid while the proposal matched
                req.draft_pos = old_len + max(
                    0, min(a, self.spec_depth - 1, len(commit)))
                # count only proposals that could commit: near
                # max_new_tokens the window's tail is clamped away
                self._draft_tokens += min(len(prop), remaining)
                self._accepted_tokens += min(a, remaining)
        elif dec_x is not None:
            nxt = torch.argmax(fns["head"](head, dec_x), -1).tolist()
            for row, req in enumerate(decoders):
                req.tokens.append(int(nxt[row]))
                req.generated += 1
        if chunk_out is not None:
            # the head reads the window's LAST column: only a FINAL chunk
            # samples; the other rows advance their chunk cursor
            nxt = torch.argmax(fns["head"](head, chunk_out), -1).tolist()
            for i, (req, end) in enumerate(chunk_meta):
                if end >= len(req.tokens):
                    req.prefilling = False
                    req.prefill_pos = len(req.tokens)
                    self._first_token(req)
                    req.tokens.append(int(nxt[i]))
                    req.generated += 1
                else:
                    req.prefill_pos = end
        for i, req in enumerate(pre_admits):
            logits = fns["head"](head, pre_outs[i])            # (1, V)
            self._first_token(req)
            req.tokens.append(int(torch.argmax(logits, -1)[0]))
            req.generated += 1           # re-prefills resume, not reset
        if self.spec_depth and admitted:
            # seed each admission's draft-cache row from its own prompt
            # prefill (the generated first token is caught up next round)
            rows = []
            for req in admitted:
                _, dc = self.draft.prefill([req.tokens[:-1]],
                                           self._draft_total)
                req.draft_pos = len(req.tokens) - 1
                rows.append(dc)
            self._draft_caches = self._rows_concat(
                [self._draft_caches] + rows)

        # ---- merge admissions, then retire finishers
        if not self.page_size:
            self._caches = self._rows_concat([self._caches] + pre_caches)
        self.inflight.extend(admitted)
        self._max_seen = max(self._max_seen, len(self.inflight))
        finished = [r for r in self.inflight if r.done]
        if finished:
            keep = [i for i, r in enumerate(self.inflight) if not r.done]
            self.inflight = [self.inflight[i] for i in keep]
            if not self.page_size:       # paged rows live in the pool
                self._caches = self._rows_keep(self._caches, keep)
            elif self.spec_depth:
                self._draft_caches = self._rows_keep(self._draft_caches,
                                                     keep)
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
        expert_kw = {}
        if self.engine.expert is not None:
            expert_kw = self.engine.expert.stats_since(self._expert_snap)
            self._expert_snap = self.engine.expert.snapshot()
        paged_kw = {}
        if self.page_size:
            paged_kw = dict(
                page_size=self.page_size,
                pages_allocated=self.pool.stats.allocs,
                page_reuses=self.pool.stats.reuses,
                prefix_hit_pages=self.tree.hits if self.tree else 0,
                cow_copies=self.pool.stats.cow_copies,
                preemptions=self.preemptions,
                pool_pages_peak=self.pool.mapped_peak)
        spec_kw = {}
        if self.spec_depth:
            spec_kw = dict(spec_depth=self.spec_depth,
                           spec_rounds=self._spec_rounds,
                           draft_tokens=self._draft_tokens,
                           accepted_tokens=self._accepted_tokens)
        # paged mode: the pool records the true mapped high-water on every
        # alloc (a boundary sample would miss pages a preemption freed)
        cache_peak = (self.pool.mapped_peak_bytes if self.page_size
                      else self._cache_peak)
        faults = _tele.counter_values("prefetch.retries",
                                      "prefetch.faults_absorbed")
        # every request retired: the request-scoped tiers must have
        # drained exactly (audit mode raises naming the leaking owner; the
        # pinned window, draft and expert reservation stay resident for
        # the session)
        self.ledger.audit_check_drained("stream", "kv_pages",
                                        "spec_headroom")
        stats = ServeStats(
            rounds=self.round, latency_s=lat, peak_bytes=self.ledger.peak,
            loads=sum(1 for e in self.events if e[1] == "load_end"),
            streamed_bytes=self.engine._streamed(self.events),
            new_tokens=sum(r.generated for r in self.done.values()),
            requests=len(self.done), max_inflight_seen=self._max_seen,
            cache_bytes_peak=cache_peak, events=self.events,
            seed=self.seed, **paged_kw, **expert_kw, **spec_kw,
            chunk_size=self.chunk,
            chunk_jobs=self._chunk_jobs,
            retries=faults[0] - self._fault_base[0],
            faults_absorbed=faults[1] - self._fault_base[1],
            peak_breakdown=dict(self.ledger.peak_breakdown),
            kernel_launches=launches,
            policy=list(self.policy_log), **self._slo_stats())
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
        if stats.expert_hits or stats.expert_misses:
            m.gauge("serve.expert_hit_rate").set(stats.expert_hit_rate)
        if stats.draft_tokens:
            m.gauge("serve.acceptance_rate").set(stats.acceptance_rate)
        if stats.page_size:
            m.gauge("serve.prefix_hit_pages").set(stats.prefix_hit_pages)

    # ---- serving-tier accounting -------------------------------------
    def _req_slo(self, req: Request
                 ) -> Tuple[Optional[float], Optional[float], bool]:
        """(ttft_rounds, tpot_rounds, meets_slo) of one finished request.
        TTFT counts from the ORIGINAL arrival (``born_round``; preemption
        moves ``arrival_round``); TPOT is the mean rounds per token after
        the first.  A shed request has neither and misses."""
        if req.rejected or req.first_token_round < 0:
            return None, None, False
        ttft = float(req.first_token_round - req.born_round + 1)
        tpot = (float(req.finished_round - req.first_token_round)
                / (req.generated - 1) if req.generated > 1 else 0.0)
        ok = True
        if self.slo is not None:
            if (self.slo.ttft_rounds is not None
                    and ttft > self.slo.ttft_rounds):
                ok = False
            if (self.slo.tpot_rounds is not None
                    and tpot > self.slo.tpot_rounds):
                ok = False
        return ttft, tpot, ok

    def _slo_stats(self) -> Dict:
        """The serving tier's ``ServeStats`` fields: round-based TTFT/TPOT
        percentiles (deterministic under a fixed trace), their wall-clock
        mirrors, goodput under the SLO, rejections and tenants."""
        reqs = list(self.done.values())
        ttfts, tpots, ttfts_s, tpots_s = [], [], [], []
        good_tokens, attained = 0, 0
        for r in reqs:
            ttft, tpot, ok = self._req_slo(r)
            if ttft is not None:
                ttfts.append(ttft)
                tpots.append(tpot)
                if r.t_first >= 0 and r.t_arrival >= 0:
                    ttfts_s.append(r.t_first - r.t_arrival)
                if r.generated > 1 and r.t_done >= 0 and r.t_first >= 0:
                    tpots_s.append((r.t_done - r.t_first)
                                   / (r.generated - 1))
            if ok:
                attained += 1
                good_tokens += r.generated

        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

        m = _tele.metrics()
        for v in ttfts_s:
            m.histogram("serve.ttft_s").observe(v)
        for v in tpots_s:
            m.histogram("serve.tpot_s").observe(v)
        return dict(tenants=len({r.tenant for r in reqs}),
                    ttft_p50_rounds=pct(ttfts, 50),
                    ttft_p99_rounds=pct(ttfts, 99),
                    tpot_p50_rounds=pct(tpots, 50),
                    tpot_p99_rounds=pct(tpots, 99),
                    ttft_p50_s=pct(ttfts_s, 50), ttft_p99_s=pct(ttfts_s, 99),
                    tpot_p50_s=pct(tpots_s, 50), tpot_p99_s=pct(tpots_s, 99),
                    slo_attained=attained / len(reqs) if reqs else 1.0,
                    goodput_tokens=good_tokens,
                    slo_rejections=self.slo_rejections)

    # ------------------------------------------------------------------
    def warmup(self, prompt_lens=()) -> "BatchScheduler":
        """Run the serving modules once at every serving shape (the prefill
        per distinct prompt length; the stacked decode, paged or dense, and
        in chunked mode the chunk window, at every batch size up to
        ``max_inflight``; in speculative mode the verify window and the
        draft's prefill and stacked decode) so kernels are built and the
        allocator is warm before the timed loop.  Paged shapes run against
        a scratch pool, never the serving one."""
        eng = self.engine
        fns = eng.fns
        emb = eng._resident.get("embed") or eng._load("embed")
        head = eng._resident.get("head") or eng._load("head")
        w0 = eng._load(eng.layer_names[0])
        T = (self._nb * self.page_size if self.page_size
             else self.max_total_len)
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.long,  # noqa
                                           device=eng.device)
        # expert-split MoE: the engine's hooks fetch through the expert
        # cache (unbound yet, so nothing is charged)
        for s in sorted(set(int(p) for p in prompt_lens)):
            px, _ = eng._layer_cache(0, w0, fns["embed"](emb, zeros(1, s)),
                                     T)
            fns["head"](head, px)
        if self.page_size:
            # the warm-up tables point every slot at page 0; speculative
            # serving decodes only through W-wide verify windows, so it
            # runs those shapes instead, and the draft's own
            pool1 = self._pool_like(1)
            w = self.spec_depth + 1
            for r in range(1, self.max_inflight + 1):
                tbr = torch.zeros((r, self._nb), dtype=torch.int32,
                                  device=eng.device)
                if self.spec_depth:
                    dr, _ = fns["layer_verify_paged"](
                        w0, fns["embed"](emb, zeros(r, w)), pool1, tbr,
                        zeros(r))
                    fns["head_all"](head, dr)
                else:
                    dr, _ = fns["layer_decode_paged"](
                        w0, fns["embed"](emb, zeros(r, 1)), pool1, tbr,
                        zeros(r))
                    fns["head"](head, dr)
                if self.chunk:
                    dc, _ = fns["layer_verify_paged"](
                        w0, fns["embed"](emb, zeros(r, self.chunk)), pool1,
                        tbr, zeros(r))
                    fns["head"](head, dc)
            del pool1
            if self.spec_depth:
                for s in sorted(set(int(p) for p in prompt_lens)):
                    self.draft.prefill(zeros(1, s), self._draft_total)
                # the stacked draft step at every row count on ONE stack of
                # cache rows, regrown leaf by leaf: no two stacks are alive
                # at once beside the pinned draft and layer 0
                _, dcr = self.draft.prefill(zeros(1, 1), self._draft_total)
                for r in range(1, self.max_inflight + 1):
                    for c in dcr.values():
                        for k, a in c.items():
                            if a.shape[0] != r:
                                c[k] = a.new_zeros((r,) + a.shape[1:])
                    self.draft.decode_batch(zeros(r, 1), dcr, zeros(r))
                del dcr
        else:
            _, c1 = eng._layer_cache(0, w0, fns["embed"](emb, zeros(1, 1)),
                                     T)
            for r in range(1, self.max_inflight + 1):
                cr = {k: torch.cat([a] * r) for k, a in c1.items()}
                dr, _ = eng._layer_decode(
                    0, w0, fns["embed"](emb, zeros(r, 1)), cr, zeros(r))
                fns["head"](head, dr)
        eng._sync()
        del w0, emb, head
        if eng.expert is not None:
            # the warm-up's fetches are not serving traffic
            self._expert_snap = eng.expert.snapshot()
        self._t0 = time.perf_counter()
        return self
