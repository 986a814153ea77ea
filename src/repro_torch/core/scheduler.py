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
  * If growth cannot clear the floor, the YOUNGEST in-flight request is
    preempted: its pages are freed and it re-queues with its tokens so
    far (re-prefilled on re-admission).  The oldest request always fits
    alone (``submit`` enforced it), so serving never deadlocks.
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

Not yet ported (they raise): speculative serving and the SLO tier
(priorities, tenants, shedding).  TTFT/TPOT percentiles are still
reported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import telemetry as _tele
from repro_torch.core.engine import PipeloadEngine, _Ledger, _not_ported
from repro_torch.core.kv_pages import (BlockTable, PagePool,
                                       PrefixNamespaces, pages_for)
from repro_torch.kernels import ops as _ops

TENANT = "default"    # the one prefix namespace (tenants are not ported)


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
    table: Optional[BlockTable] = None   # paged mode: page ids + n_shared
    # -- chunked prefill ------------------------------------------------
    prefilling: bool = False      # True while chunks are still feeding
    prefill_pos: int = 0          # tokens whose K/V is already paged in
    born_round: int = 0           # original arrival (preemption re-queues
                                  # move arrival_round; TTFT uses this)
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
    and the budget caps it further through admission control.
    ``page_size`` (default: the engine's) turns on paged KV,
    ``prefix_cache`` its prefix sharing, and ``chunk_prefill`` chunked
    prefill in paged mode."""

    def __init__(self, engine: PipeloadEngine, *, max_inflight: int = 4,
                 max_total_len: int = 128, page_size: Optional[int] = None,
                 prefix_cache: bool = True, seed: Optional[int] = None,
                 draft=None, spec_depth: int = 0, chunk_prefill: int = 0,
                 slo=None):
        if engine.mode == "baseline":
            raise ValueError("continuous batching needs a pipelined mode "
                             "(pipeload / pipeswitch)")
        if draft is not None or spec_depth:
            raise _not_ported("speculative serving")
        if slo is not None:
            raise _not_ported("the SLO serving tier")
        self.engine = engine
        self.max_inflight = max(1, max_inflight)
        self.max_total_len = max_total_len
        # paged KV: an explicit page_size wins, else the engine's (the
        # planner threads its pick through the engine); 0/None = dense
        if page_size is None:
            page_size = engine.page_size
        self.page_size = page_size if page_size and page_size > 0 else None
        # chunked prefill: prompts longer than ``chunk`` tokens prefill C
        # tokens per round through the stacked verify window
        self.chunk = 0
        if chunk_prefill and chunk_prefill > 0:
            if not self.page_size:
                raise ValueError(
                    "chunked prefill needs paged KV (chunks write K/V "
                    "through the block tables); set page_size")
            if "layer_verify_paged" not in engine.fns:
                raise ValueError(
                    "engine's model fns lack layer_verify_paged (the "
                    "chunk window); architecture unsupported for "
                    "chunked prefill")
            # page-aligned: a chunk never splits a page's writes across
            # rounds
            ps = self.page_size
            self.chunk = -(-int(chunk_prefill) // ps) * ps
        self.policy_log: List[Tuple[str, int, int, float]] = []
        self._chunk_jobs = 0
        m = _tele.metrics()
        self._m_admits = m.counter("sched.admits")
        self._m_preempts = m.counter("sched.preemptions")
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
        # ---- paged-KV state (unused in dense mode) ----
        self.pool: Optional[PagePool] = None
        self.tree: Optional[PrefixNamespaces] = None
        self._pools: Optional[Dict[str, dict]] = None  # layer -> (P, ps, ..)
        self.preemptions = 0
        self._req_headroom = 0
        if self.page_size:
            ps = self.page_size
            self._nb = pages_for(max_total_len, ps)
            self._page_bytes = (len(engine.layer_names)
                                * engine.cfg.cache_bytes(1, ps))
            self.pool = PagePool(ps, self._page_bytes, self.ledger)
            self.tree = PrefixNamespaces(ps) if prefix_cache else None
            self._req_headroom = 1      # growth headroom per request

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
        above the budget floor even with nothing else in flight (paged
        mode: every page of its final length, unshared, plus the
        admission headroom)."""
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
            # ALONE can always map its next page
            per_req = ((pages_for(len(prompt) + max_new_tokens,
                                  self.page_size) + self._req_headroom)
                       * self._page_bytes)
        else:
            per_req = self._per_req_cache
        self.engine._check_kv_budget(per_req, inflight=1)
        arrival = max(arrival_round, 0)
        req = Request(self._next_rid, prompt, max_new_tokens,
                      arrival_round=arrival, cache_bytes=per_req,
                      born_round=arrival)
        self._next_rid += 1
        self.queue.append(req)
        self._sort_queue()
        return req.rid

    def _sort_queue(self) -> None:
        """FIFO by arrival (a preempted request re-enters with
        arrival_round = now)."""
        self.queue.sort(key=lambda r: (r.arrival_round, r.rid))

    def _tree(self):
        """The prefix index (None when prefix caching is off)."""
        return self.tree.tree(TENANT) if self.tree is not None else None

    def _fits(self, extra_cache: int) -> bool:
        """Would the decode floor still clear the budget after granting
        ``extra_cache`` more cache bytes?"""
        eng = self.engine
        if eng.budget is None:
            return True
        return eng._kv_floor(self._cache_resident + extra_cache) \
            <= eng.budget

    # ---- paged-mode admission / growth / preemption ------------------
    def _fits_paged(self, extra_pages: int, inflight_after: int) -> bool:
        """Paged decode floor: pages actually mapped, plus the new pages,
        plus one page of growth headroom per in-flight request."""
        eng = self.engine
        if eng.budget is None:
            return True
        cache = ((self.pool.mapped_pages + extra_pages
                  + inflight_after * self._req_headroom)
                 * self._page_bytes)
        return eng._kv_floor(cache) <= eng.budget

    def _admit_one_paged(self, req: Request, inflight_after: int) -> bool:
        """Map the request's prompt pages (prefix-tree hits are refcount
        bumps, charged once across the fleet); False = does not fit at
        this boundary."""
        toks = req.tokens or [int(t) for t in req.prompt]
        n_pages = pages_for(len(toks), self.page_size)
        tree = self._tree()
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
        """Bounce ``victim`` (paged mode) back to the queue, releasing its
        pages exactly; it re-prefills from its tokens so far on
        re-admission."""
        self.pool.detail = f"req{victim.rid}"
        victim.table.release_all(self.pool, self._tree())
        self.pool.detail = None
        self.inflight.remove(victim)
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

    def _alloc_with_preemption(self, req: Request) -> Optional[int]:
        """Map one more page for ``req``, preempting the YOUNGEST in-flight
        request (the last admitted), possibly ``req`` itself, while the
        floor would not clear: an older request's progress is never
        sacrificed for a younger grower.  Returns None when ``req`` was
        the victim; otherwise always succeeds, since once ``req`` is
        alone, ``submit`` guaranteed its worst case fits."""
        while not self._fits_paged(1, 0) and len(self.inflight) > 1:
            victim = self.inflight[-1]
            self._preempt(victim)
            if victim is req:
                return None
        self.pool.detail = f"req{req.rid}"
        pid = self.pool.alloc()
        self.pool.detail = None
        return pid

    def _grow_pages(self):
        """Round boundary, before admission: map each in-flight decoder's
        write page (the one its next token lands in), growing across page
        boundaries and copy-on-writing a shared page before its first
        divergent write.  The copies land on the compute stream here,
        before the round that writes the new pages."""
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
            idx = req.pos // ps
            while len(t.pages) <= idx:
                pid = self._alloc_with_preemption(req)
                if pid is None:             # req itself was the victim
                    break
                t.pages.append(pid)
            if req not in self.inflight or not self.pool.is_shared(
                    t.pages[idx]):
                continue
            old = t.pages[idx]
            new = self._alloc_with_preemption(req)
            if new is None:                 # req preempted: refs already
                continue                    # dropped by release_all
            cow.append((req, old, new))
            # usually the sibling keeps the old page; if the COW alloc
            # preempted that sibling, this drop is the LAST reference and
            # the tree node goes with it
            tree = self._tree()
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
        """One layer's zeroed physical pages {k, v}: (rows, page_size, KV,
        dh) in the model dtype on the engine's device.  The ONE place the
        pool layout is defined."""
        cfg = self.engine.cfg
        shape = (rows, self.page_size, cfg.n_kv_heads, cfg.head_dim)
        return {k: torch.zeros(shape, dtype=cfg.torch_dtype,
                               device=self.engine.device)
                for k in ("k", "v")}

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

    def _admit(self) -> List[Request]:
        """FIFO head-of-line admission at the current boundary: skipping
        the head never helps (dense mode reserves one padded size for
        everyone; paged mode's head is also the next to shrink via
        sharing), and blocking is deadlock-free (``submit`` rejected
        anything that cannot fit alone)."""
        admitted: List[Request] = []
        while self.queue:
            req = self.queue[0]
            if req.arrival_round > self.round:
                break
            if len(self.inflight) + len(admitted) >= self.max_inflight:
                break
            if not self._reserve(req,
                                 len(self.inflight) + len(admitted) + 1):
                break
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
        completes so the next boundary can re-grant them.  Paged mode
        drops one reference per page: pages shared with a live sibling
        survive until the LAST sharer retires."""
        for req in finished:
            if self.page_size:
                self.pool.detail = f"req{req.rid}"
                req.table.release_all(self.pool, self._tree())
                self.pool.detail = None
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

    def _drop_rows(self, keep: List[int]):
        if self._caches is None:
            return
        if not keep:
            self._caches = None
            return
        idx = torch.as_tensor(keep, dtype=torch.long,
                              device=self.engine.device)
        # layer by layer, so each layer's old rows are freed as soon as
        # its kept rows are copied: the copy is never all layers at once
        for name, c in self._caches.items():
            self._caches[name] = {k: a.index_select(0, idx)
                                  for k, a in c.items()}

    def _append_rows(self, new_caches: List[Dict[str, dict]]):
        stacks = ([self._caches] if self._caches is not None else []) \
            + new_caches
        if not stacks:
            return
        if len(stacks) == 1:
            self._caches = stacks[0]
            return
        # layer by layer, dropping each layer's old rows and prefill
        # captures once merged: the merge holds at most one layer's cache
        # twice, not the whole KV reservation
        merged = {}
        for name in list(stacks[0]):
            merged[name] = {k: torch.cat([s[name][k] for s in stacks])
                            for k in stacks[0][name]}
            for s in stacks:
                del s[name]
        self._caches = merged

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
        # ---- the decode batch: stacked last tokens, ragged device pos
        dec_x = dec_pos = None
        if decoders:
            dec_x = fns["embed"](emb, eng.tokens([[r.tokens[-1]]
                                                  for r in decoders]))
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

        # ---- heads: one greedy token per request this round (the token
        # readbacks are the round's host round trips)
        head = eng._resident["head"]
        if dec_x is not None:
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

        # ---- merge admissions, then retire finishers
        if not self.page_size:
            self._append_rows(pre_caches)
        self.inflight.extend(admitted)
        self._max_seen = max(self._max_seen, len(self.inflight))
        finished = [r for r in self.inflight if r.done]
        if finished:
            keep = [i for i, r in enumerate(self.inflight) if not r.done]
            self.inflight = [self.inflight[i] for i in keep]
            if not self.page_size:       # paged rows live in the pool
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
        # paged mode: the pool records the true mapped high-water on every
        # alloc (a boundary sample would miss pages a preemption freed)
        cache_peak = (self.pool.mapped_peak_bytes if self.page_size
                      else self._cache_peak)
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
            cache_bytes_peak=cache_peak, events=self.events,
            seed=self.seed, **paged_kw, chunk_size=self.chunk,
            chunk_jobs=self._chunk_jobs,
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
        if stats.page_size:
            m.gauge("serve.prefix_hit_pages").set(stats.prefix_hit_pages)

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
        """Run the serving modules once at every serving shape (the prefill
        per distinct prompt length; the stacked decode, paged or dense, and
        in chunked mode the chunk window, at every batch size up to
        ``max_inflight``) so kernels are built and the allocator is warm
        before the timed loop.  Paged shapes run against a scratch pool,
        never the serving one."""
        eng = self.engine
        fns = eng.fns
        emb = eng._resident.get("embed") or eng._load("embed")
        head = eng._resident.get("head") or eng._load("head")
        w0 = eng._load(eng.layer_names[0])
        T = (self._nb * self.page_size if self.page_size
             else self.max_total_len)
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.long,  # noqa
                                           device=eng.device)
        for s in sorted(set(int(p) for p in prompt_lens)):
            px, _ = fns["layer_cache"](w0, fns["embed"](emb, zeros(1, s)), T)
            fns["head"](head, px)
        if self.page_size:
            # the warm-up tables point every slot at page 0
            pool1 = self._pool_like(1)
            for r in range(1, self.max_inflight + 1):
                tbr = torch.zeros((r, self._nb), dtype=torch.int32,
                                  device=eng.device)
                dr, _ = fns["layer_decode_paged"](
                    w0, fns["embed"](emb, zeros(r, 1)), pool1, tbr, zeros(r))
                fns["head"](head, dr)
                if self.chunk:
                    dc, _ = fns["layer_verify_paged"](
                        w0, fns["embed"](emb, zeros(r, self.chunk)), pool1,
                        tbr, zeros(r))
                    fns["head"](head, dc)
            del pool1
        else:
            _, c1 = fns["layer_cache"](w0, fns["embed"](emb, zeros(1, 1)), T)
            for r in range(1, self.max_inflight + 1):
                cr = {k: torch.cat([a] * r) for k, a in c1.items()}
                dr, _ = fns["layer_decode"](
                    w0, fns["embed"](emb, zeros(r, 1)), cr, zeros(r))
                fns["head"](head, dr)
        eng._sync()
        del w0, emb, head
        self._t0 = time.perf_counter()
        return self
