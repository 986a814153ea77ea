"""Pipeline Planner (Hermes §IV-2) + generation-aware tier (beyond-paper).

From the Layer Profiler's output it builds a PIPELOAD execution schedule:
for each memory constraint, the number of Loading Agents that minimises
latency while the predicted peak stays within budget.

Two prediction tiers, mirroring the paper's "reasonable range, then exact
pre-run":
  1. an analytic model for the feasible range of ``m``:
        T(m) ~ t_load + ceil(N/m - 1) * max(t_load, m*t_comp) + m*t_comp
        M(m) ~ (m + c) * layer_bytes + other_bytes
  2. a discrete-event simulation of the engine (the "pre-run") that
     replays the exact agent striping, in-order inference and destruction
     to get latency and true peak memory.

The generation-aware tier (``plan_generate``) plans KV-cache decode
workloads: it charges ``num_layers * cache_bytes`` of KV pages to the peak
model, amortises layer loads over ``new_tokens`` pipeline rounds, and
searches ``(num_agents, pin_window)`` JOINTLY — pinned layers trade budget
headroom (they stay resident) against reloads (they skip the disk in every
decode round).  With ``max_inflight > 1`` it also searches the
continuous-batching dimension: KV pages scale with the in-flight count
while the weight stream does not, so the optimal
``(num_agents, pin_window, inflight)`` triple changes with the budget.

Expert-split MoE profiles (``expert_split`` + per-expert byte/latency
figures from the Layer Profiler) add a third search dimension: the
**ExpertCache size**.  The round model is analytic-on-top-of-simulated:
``expected_unique_experts(n_experts, top_k, tokens)`` gives the expected
per-layer union a round demand-loads (exact under uniform independent
top-k routing: ``E * (1 - ((E-k)/E)^T)``), a first-order LRU model turns
cache bytes into a hit rate (the cached fraction of the ``L*E`` expert
pool), and the resulting expected miss-fetch time is folded into each
layer's compute time — expert fetches ride the Inference Agent's path,
after the router — before the discrete-event ``simulate`` replays the
round.  ``plan_generate`` then searches cache size jointly with
``(num_agents, pin_window, inflight, dtype)``; the winning entry's
``expert_cache_bytes`` sizes the engine's reservation.

Both ``plan`` and ``plan_generate`` also search over shard *dtype*: pass
``{"fp32": profile, "int8": profile, ...}`` (one Layer Profiler run per
quantized variant of the checkpoint — per-dtype ``t_load``/``bytes`` are
measured, not modelled) and every candidate grid is the union across
dtypes; the chosen entry's ``dtype`` field names the winner.  Quantized
shards carry ~4x/8x fewer bytes, so under tight budgets they admit more
loading agents, deeper pin windows and more in-flight requests — the
capacity-first search surfaces exactly that.  KV-cache pages keep the
model dtype (only weights are quantized), so ``cache_bytes_per_layer``
is dtype-independent.  Accuracy is the user's trade-off, not the
planner's: it never discounts a dtype for quantization error (see
docs/quantization.md for the measured tolerances).
"""
from __future__ import annotations

import copy
import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.kv_pages import pages_for


@dataclasses.dataclass
class PlanEntry:
    budget_bytes: Optional[int]
    num_agents: int
    predicted_latency_s: float
    predicted_peak_bytes: int
    feasible: bool
    dtype: Optional[str] = None       # shard dtype when searching over quant


@dataclasses.dataclass
class GenPlanEntry:
    """A generation-aware schedule: joint (num_agents, pin_window) — and,
    for serving workloads, the in-flight request count the budget
    admits (``inflight``; 1 for plain single-request generation)."""
    budget_bytes: Optional[int]
    num_agents: int
    pin_window: int
    predicted_latency_s: float        # prefill + all decode rounds
    predicted_prefill_s: float
    predicted_per_token_s: float      # one decode ROUND (all requests)
    predicted_peak_bytes: int         # weights + KV cache
    cache_bytes: int                  # total KV pages (all in-flight reqs)
    feasible: bool
    inflight: int = 1                 # concurrent requests in the batch
    predicted_throughput_tps: float = 0.0  # inflight tokens / decode round
    dtype: Optional[str] = None       # shard dtype when searching over quant
    expert_cache_bytes: int = 0       # ExpertCache size (expert-split MoE)
    page_size: int = 0                # KV page size (0 = dense reservation)
    spec_depth: int = 0               # draft tokens per verify round
    draft_bytes: int = 0              # pinned draft + per-req cache rows
    predicted_ttft_s: float = 0.0     # queue-free time-to-first-token
    predicted_tpot_s: float = 0.0     # expected time per output token
    slo_ok: bool = True               # meets the requested TTFT/TPOT SLO
    chunk_prefill: int = 0            # prefill chunk tokens (0 = monolithic)


# ---------------------------------------------------------------------------
# Tier 1: analytic model
# ---------------------------------------------------------------------------
def analytic_latency(n_layers: int, m: int, t_load: float,
                     t_comp: float) -> float:
    """Pipeline makespan with m parallel loaders, striped L_{i+jm}."""
    waves = math.ceil(n_layers / m)
    stage = max(t_load, m * t_comp)
    return t_load + max(waves - 1, 0) * stage + min(m, n_layers) * t_comp


def analytic_peak(m: int, layer_bytes: int, other_bytes: int,
                  inflight: int = 2, cache_bytes: int = 0,
                  pin_window: int = 0,
                  n_layers: Optional[int] = None) -> int:
    """~(m + c) layers resident: m loading + c awaiting destruction.

    Generation-aware extras: ``cache_bytes`` (total KV pages, resident for
    the whole run) and ``pin_window`` pinned layers (resident across
    decode rounds on top of the streaming window).  With ``n_layers`` the
    streaming term is clamped to the layers that actually stream — a
    fully-pinned stack has NO streaming window, only the pinned bytes."""
    streaming = m + inflight
    if n_layers is not None:
        streaming = min(streaming, max(n_layers - pin_window, 0))
    return ((streaming + pin_window) * layer_bytes + other_bytes
            + cache_bytes)


# ---------------------------------------------------------------------------
# Tier 2: discrete-event simulation (the planner's "pre-run")
# ---------------------------------------------------------------------------
def simulate(profile: Dict, m: int,
             budget_bytes: Optional[int] = None, *,
             pin_window: int = 0, retain_window: int = 0,
             extra_resident_bytes: int = 0,
             t_comp_key: str = "t_comp",
             batch: int = 1) -> Tuple[float, int]:
    """Event-driven replay of PIPELOAD.  Returns (latency_s, peak_bytes).

    Models: m loaders (each strictly sequential over its stripe, reserving
    ledger bytes at load START), one inference agent (in-order), destruction
    at compute completion, loaders blocked while resident + next > budget
    (the paper's S_stop), woken at the next destruction.

    Generation-aware extras (all default to the paper's single-pass
    semantics): the first ``pin_window`` layers are already resident
    (their bytes are charged up front, their loads are free, they are
    never destroyed); the first ``retain_window`` layers load normally
    but are never destroyed (the engine's PREFILL round, where the
    pinned prefix becomes resident); ``extra_resident_bytes`` models
    KV-cache pages held for the whole round; ``t_comp_key`` selects
    which per-shard compute time drives the inference agent
    (``"t_decode"`` for one-token rounds, falling back to ``t_comp``
    when a profile predates decode timing); ``batch`` is the
    continuous-batching in-flight count — the Inference Agent applies
    each streamed layer to ``batch`` stacked requests, so compute times
    scale linearly (a pessimistic bound: batched GEMMs amortise) while
    load times do NOT — exactly the asymmetry the scheduler exploits.
    """
    layers = [s for s in profile["shards"] if s["kind"] == "layer"]
    n = len(layers)
    pin = min(max(pin_window, 0), n)
    keep = max(pin, min(max(retain_window, 0), n))   # never destroyed
    t_load = [s["t_load"] for s in layers]
    t_comp = [batch * s.get(t_comp_key, s["t_comp"]) for s in layers]
    nbytes = [s["bytes"] for s in layers]
    other = profile["other_bytes"] + extra_resident_bytes

    resident = other + sum(nbytes[:pin])
    peak = resident
    streaming = list(range(pin, n))      # layers that actually hit the disk
    stripes = [streaming[i::m] for i in range(m)]
    agent_pos = [0] * m
    ready_at = [math.inf] * n
    loaded_done = [False] * n
    for k in range(pin):                 # pinned: S_comp already raised
        ready_at[k], loaded_done[k] = 0.0, True
    next_inf = 0
    inf_free_at = 0.0
    latency = 0.0
    blocked: List[int] = []           # agent ids blocked on the budget

    # event heap: (time, seq, kind, payload)
    seq = 0
    events: List[Tuple[float, int, str, int]] = []

    def push(t, kind, payload):
        nonlocal seq
        heapq.heappush(events, (t, seq, kind, payload))
        seq += 1

    def try_start_load(a: int, now: float):
        nonlocal resident, peak
        if agent_pos[a] >= len(stripes[a]):
            return
        k = stripes[a][agent_pos[a]]
        if budget_bytes is not None and resident + nbytes[k] > budget_bytes \
                and resident > other:
            if a not in blocked:
                blocked.append(a)     # S_stop: wait for a destruction
            return
        resident += nbytes[k]         # ledger reserve at load start
        peak = max(peak, resident)
        agent_pos[a] += 1
        push(now + t_load[k], "load_done", (a << 20) | k)

    def advance_inference(now: float):
        nonlocal next_inf, inf_free_at
        while next_inf < n and loaded_done[next_inf]:
            start = max(ready_at[next_inf], inf_free_at)
            inf_free_at = start + t_comp[next_inf]
            push(inf_free_at, "inf_done", next_inf)
            next_inf += 1

    for a in range(m):
        try_start_load(a, 0.0)
    advance_inference(0.0)            # pinned prefix computes immediately
    if not events and n > 0:
        return math.inf, peak         # budget below a single layer

    guard = 0
    while events and guard < 20 * n + 100:
        guard += 1
        now, _, kind, payload = heapq.heappop(events)
        if kind == "load_done":
            a, k = payload >> 20, payload & ((1 << 20) - 1)
            ready_at[k] = now
            loaded_done[k] = True
            try_start_load(a, now)    # next stripe item (may block)
            # inference agent: start any now-unblocked in-order layers
            advance_inference(now)
        else:  # inf_done -> destruction (daemon) frees bytes, wakes loaders
            k = payload
            latency = max(latency, now)
            if k >= keep:             # pinned/retained: never destroyed
                resident -= nbytes[k]
                waiting, blocked[:] = list(blocked), []
                for a in waiting:
                    try_start_load(a, now)  # re-appends itself if blocked
    if next_inf < n:
        return math.inf, peak         # could not finish (budget deadlock)
    return latency, peak


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------
def _as_profiles(profile) -> List[Tuple[Optional[str], Dict]]:
    """Normalise the planner input: a single Layer Profiler output, or a
    ``{dtype_label: profile}`` dict to search shard dtype jointly."""
    if isinstance(profile, dict) and "shards" not in profile:
        return list(profile.items())
    return [(profile.get("quant"), profile)]


def _better(cand, best) -> bool:
    """Feasible beats infeasible; ties break on predicted latency."""
    return best is None or (cand.feasible and not best.feasible) or (
        cand.feasible == best.feasible
        and cand.predicted_latency_s < best.predicted_latency_s)


def _gen_better(cand: "GenPlanEntry", best: Optional["GenPlanEntry"]
                ) -> bool:
    """Generation-tier comparator: feasibility, then SLO attainment,
    then latency — but a LATENCY TIE goes to the deeper pin window.  When loads overlap
    compute completely (fast disk, warm page cache) the simulator
    predicts identical round latency for every pin that hides the first
    load, yet each unpinned layer still costs a real disk read per
    decode round; the simulator's objective is blind to that traffic, so
    the tie-break is where "stream as few bytes as possible" lives.  A
    remaining tie goes to the bigger expert cache — same argument, for
    demand-loaded expert shards."""
    if best is None:
        return True
    if cand.feasible != best.feasible:
        return cand.feasible
    if cand.slo_ok != best.slo_ok:
        return cand.slo_ok
    a, b = cand.predicted_latency_s, best.predicted_latency_s
    if not (math.isfinite(a) and math.isfinite(b)):
        return a < b
    tol = 1e-6 * max(a, b, 1e-12)
    if abs(a - b) > tol:
        return a < b
    if cand.pin_window != best.pin_window:
        return cand.pin_window > best.pin_window
    if cand.expert_cache_bytes != best.expert_cache_bytes:
        return cand.expert_cache_bytes > best.expert_cache_bytes
    # same latency, same pins: prefer the schedule holding FEWER cache
    # bytes — paged reservations with prefix sharing free real headroom
    # the simulator's objective is blind to
    return cand.cache_bytes < best.cache_bytes


def plan(profile, budgets: List[Optional[int]],
         max_agents: Optional[int] = None) -> List[PlanEntry]:
    """Single-pass schedule per budget.  ``profile`` may be one Layer
    Profiler output or ``{dtype: profile}`` (candidates union over
    dtypes; the winning entry's ``dtype`` names the shard precision)."""
    profiles = _as_profiles(profile)

    entries: List[PlanEntry] = []
    for budget in budgets:
        best: Optional[PlanEntry] = None
        for label, prof in profiles:
            n = prof["num_layers"]
            lb = prof["layer_bytes"]
            other = prof["other_bytes"]
            max_m = max_agents or min(n, 12)
            # tier 1: feasible range
            feasible_ms = [m for m in range(1, max_m + 1)
                           if budget is None
                           or analytic_peak(m, lb, other) <= budget]
            if not feasible_ms:
                feasible_ms = [1]
            # tier 2: exact pre-run on the feasible range
            for m in feasible_ms:
                lat, peak = simulate(prof, m, budget)
                ok = math.isfinite(lat) and (budget is None
                                             or peak <= budget)
                cand = PlanEntry(budget, m, lat, int(peak), ok,
                                 dtype=label)
                if _better(cand, best):
                    best = cand
        entries.append(best)
    return entries


# ---------------------------------------------------------------------------
# Expert-streaming round model (expert-split MoE profiles)
# ---------------------------------------------------------------------------
def expected_unique_experts(n_experts: int, top_k: int,
                            tokens: int) -> float:
    """Expected per-layer count of DISTINCT experts a round's batch
    activates.  Exact under uniform independent routing: each token
    picks a top-k set uniformly, so P(expert untouched by one token) =
    (E-k)/E and E[unique] = E * (1 - ((E-k)/E)^T)."""
    if n_experts <= 0 or top_k <= 0 or tokens <= 0:
        return 0.0
    return n_experts * (1.0 - ((n_experts - top_k) / n_experts) ** tokens)


def expert_hit_rate_model(cache_bytes: int, expert_bytes: int,
                          n_layers: int, n_experts: int) -> float:
    """First-order LRU hit model: under near-uniform routing the chance
    a needed expert is resident ≈ the cached fraction of the L*E expert
    pool (saturating at 1 when everything fits)."""
    pool = n_layers * n_experts * expert_bytes
    if pool <= 0 or cache_bytes <= 0:
        return 0.0
    return min(1.0, cache_bytes / pool)


def _slim_profile(prof: Dict) -> Dict:
    """Copy without the per-expert shard rows (simulate only reads layer
    rows; the expert aggregates stay at the top level)."""
    out = {k: v for k, v in prof.items() if k != "shards"}
    out["shards"] = [dict(s) for s in prof["shards"]
                     if s["kind"] != "expert"]
    return out


def _moe_stream_profile(slim: Dict, *, tokens: int, cache_bytes: int,
                        m: int, batch: int, key: str) -> Dict:
    """Derive a profile whose per-layer ``key`` time includes the round's
    expected expert demand-loads: ``unique * miss_rate`` shards fetched
    on ``m`` parallel workers, on the Inference Agent's path (after the
    router).  ``simulate`` scales compute by ``batch``, and the union is
    already a whole-round quantity, so the extra is pre-divided."""
    e, k = slim["n_experts"], slim["top_k"]
    u = expected_unique_experts(e, k, tokens)
    hit = expert_hit_rate_model(cache_bytes, slim["expert_bytes"],
                                slim["num_layers"], e)
    extra = (u * (1.0 - hit) * slim["expert_t_load"]
             / max(m, 1) / max(batch, 1))
    out = copy.deepcopy(slim)
    for s in out["shards"]:
        if s["kind"] == "layer":
            s[key] = s.get(key, s["t_comp"]) + extra
    return out


def _expert_cache_grid(slim: Dict, batch: int, seq: int) -> List[int]:
    """Candidate ExpertCache sizes: the worst-case per-layer union (the
    smallest cache a round can run with — prefill may touch every expert
    of a layer at once), doublings of it, and the whole expert pool."""
    e, k = slim["n_experts"], slim["top_k"]
    eb = slim["expert_bytes"]
    total = slim["num_layers"] * e * eb
    c = min(e, max(batch * seq, 1) * k) * eb
    grid = []
    while c < total:
        grid.append(int(c))
        c *= 2
    grid.append(int(total))
    return grid


# ---------------------------------------------------------------------------
# Generation-aware planner (KV-cache decode workloads)
# ---------------------------------------------------------------------------
def _with_decode_times(profile: Dict) -> Dict:
    """Fill per-shard ``t_decode`` when the profile predates decode timing:
    one-token compute scales ~linearly down from the profiled prefill seq."""
    if all("t_decode" in s for s in profile["shards"]
           if s["kind"] == "layer"):
        return profile
    prof = copy.deepcopy(profile)
    seq = max(int(prof.get("seq", 1)), 1)
    for s in prof["shards"]:
        if s["kind"] == "layer":
            s.setdefault("t_decode", s["t_comp"] / seq)
    return prof


def plan_generate(profile, budgets: List[Optional[int]], *,
                  new_tokens: int, cache_bytes_per_layer: int,
                  max_agents: Optional[int] = None,
                  max_pin: Optional[int] = None,
                  max_inflight: int = 1,
                  page_sizes: Tuple[int, ...] = (),
                  total_len: Optional[int] = None,
                  shared_prefix_len: int = 0,
                  spec_depths: Tuple[int, ...] = (),
                  spec_draft: Optional[Dict] = None,
                  slo_ttft_s: Optional[float] = None,
                  slo_tpot_s: Optional[float] = None,
                  chunk_prefill: int = 0
                  ) -> List[GenPlanEntry]:
    """Joint (num_agents, pin_window, inflight) schedule for KV-cache
    generation and continuous-batching serving — over one profile, or
    ``{dtype: profile}`` to search shard dtype jointly (module docs).

    Total latency model: one cache-capturing prefill round (full-sequence
    compute, every layer loaded) + ``new_tokens - 1`` decode rounds
    (one-token compute, only NON-pinned layers reloaded).  Loads amortise
    over rounds exactly as the engine replays them; KV pages are extra
    resident bytes in every round.  Feasibility = finite latency and peak
    (weights + cache) within budget in BOTH round shapes.

    The batch dimension (``max_inflight > 1``) models the scheduler:
    cache bytes scale linearly with the in-flight count and per-layer
    compute scales with the stacked batch, but the weight stream does
    NOT — one round serves everyone.  The search is CAPACITY-FIRST: it
    picks the largest in-flight count the budget admits (serving as many
    concurrent users as memory allows is the primary objective; per-round
    latency barely moves with batch in the load-bound regime, so the
    largest feasible batch is also throughput-optimal), then optimises
    ``(num_agents, pin_window)`` for round latency at that count.
    Capacity-first also makes the planner MONOTONE: a larger budget never
    shrinks ``inflight``, because feasibility of a count only ever grows
    with budget.

    The **page dimension** (``page_sizes`` non-empty, needs
    ``total_len``): each candidate page size charges the paged
    scheduler's admission model instead of the dense ``r x total_len``
    reservation — ``ceil(total_len / ps)`` pages per request, of which
    the ``shared_prefix_len // ps`` full pages under the workload's
    common prompt prefix are charged ONCE across all ``r`` requests (the
    expected prefix-hit bytes), plus one page of growth headroom per
    request.  Page size 0 (always searched) is the dense reservation, so
    paging wins only where sharing/rounding actually frees bytes; the
    winning entry's ``page_size`` feeds the engine and scheduler.

    The **speculative dimension** (``spec_depths`` non-empty, needs
    ``spec_draft`` and ``page_sizes``): each candidate depth ``k`` plays
    the scheduler's draft-and-verify protocol — a pinned draft
    (``spec_draft["bytes"]`` resident, plus one
    ``spec_draft["cache_bytes"]`` dense cache row per in-flight request)
    proposes ``k`` tokens per round and one stacked verify round scores
    the whole window, so a round commits
    ``E(k, a) = (1 - a^(k+1)) / (1 - a)`` tokens in expectation at
    acceptance rate ``a = spec_draft["acceptance"]``.  The verify round's
    compute scales by the window width (the weight stream does NOT — the
    same asymmetry continuous batching exploits, amortised ``E``-fold),
    the draft's serial chain adds ``k * spec_draft["t_token"]``, and the
    KV charge grows by the window-overhang pages.  Depth 0 (always
    searched) is plain decoding, so speculation wins only where the
    acceptance rate actually buys rounds; the winning entry's
    ``spec_depth``/``draft_bytes`` feed the scheduler.

    The **SLO dimension** (``slo_ttft_s`` / ``slo_tpot_s``): every
    candidate carries a queue-free TTFT prediction (the prefill-round
    latency — or, with ``chunk_prefill > 0``, ``ceil(prompt / chunk)``
    chunk-joined decode rounds, each simulated with the chunk's tokens
    stacked onto the decode batch) and a TPOT prediction (round latency
    over expected committed tokens).  ``slo_ok`` marks candidates whose
    predictions meet both targets; the comparator prefers SLO-meeting
    schedules right after feasibility, and the capacity-first loop
    breaks only on a feasible AND SLO-meeting count — admitting fewer
    concurrent requests to protect latency targets.  When NO feasible
    candidate attains the SLO at any count, the planner falls back to
    the best feasible schedule (serve degraded rather than not at all)
    with ``slo_ok=False`` so callers can surface the miss.
    """
    profiles = [(label, _with_decode_times(p))
                for label, p in _as_profiles(profile)]
    rounds = max(new_tokens - 1, 0)
    if page_sizes and not total_len:
        raise ValueError("page_sizes search requires total_len")
    if spec_depths and spec_draft is None:
        raise ValueError("spec_depths search requires spec_draft "
                         "(draft bytes / cache_bytes / acceptance)")
    if spec_depths and not page_sizes:
        raise ValueError("spec_depths search requires page_sizes (the "
                         "verify window rides the paged KV block tables)")
    if chunk_prefill and spec_depths:
        raise ValueError("chunk_prefill is incompatible with spec_depths "
                         "(the scheduler forbids chunked prefill in "
                         "speculative mode)")
    ps_grid = [0] + [int(p) for p in page_sizes if p and p > 0]
    depth_grid = [0] + [int(d) for d in spec_depths if d and d > 0]
    chunk = max(int(chunk_prefill), 0)
    if chunk:
        # chunked prefill writes through the paged KV kernel, so the
        # dense candidate cannot serve it — the paged grid is the grid
        if len(ps_grid) < 2:
            raise ValueError("chunk_prefill requires page_sizes")
        ps_grid = ps_grid[1:]
    accept = (min(max(float(spec_draft.get("acceptance", 0.8)), 0.0), 1.0)
              if spec_draft else 0.0)
    draft_t = float(spec_draft.get("t_token", 0.0)) if spec_draft else 0.0

    def kv_bytes(n_layers: int, r: int, ps: int, depth: int = 0) -> int:
        """Total KV reservation the scheduler will charge for ``r``
        in-flight requests at page size ``ps`` (0 = dense) and verify
        depth ``depth`` (window-overhang pages + per-request window
        growth headroom)."""
        if ps == 0:
            return n_layers * cache_bytes_per_layer * r
        tok = cache_bytes_per_layer // total_len      # exact: linear in S
        pages_per_req = pages_for(total_len + depth, ps)
        shared = min(shared_prefix_len // ps, pages_per_req)
        pages = (shared + r * (pages_per_req - shared)
                 + r * pages_for(depth + 1, ps))      # + headroom
        return n_layers * tok * ps * pages

    def expected_commit(depth: int) -> float:
        """Tokens one verify round commits in expectation: accepted
        prefix + the target's bonus token."""
        if depth == 0:
            return 1.0
        if accept >= 1.0:
            return depth + 1.0
        return (1.0 - accept ** (depth + 1)) / (1.0 - accept)

    def best_at(label, prof, budget, r: int) -> Optional[GenPlanEntry]:
        """Best (m, pin[, expert cache][, page size]) candidate with
        ``r`` requests in flight."""
        n = prof["num_layers"]
        lb = prof["layer_bytes"]
        other = prof["other_bytes"]
        max_m = max_agents or min(n, 12)
        pin_cap = n if max_pin is None else min(max_pin, n)
        moe = bool(prof.get("expert_split"))
        seq = max(int(prof.get("seq", 1)), 1)
        slim = _slim_profile(prof) if moe else prof
        cache_opts = (_expert_cache_grid(slim, r, seq) if moe else [0])
        # paged serving does not support expert-split MoE (the scheduler
        # rejects the combination), so MoE profiles search dense only;
        # speculative depths need the paged verify window, so depth > 0
        # pairs only with ps > 0
        pss = [0] if moe else ps_grid
        best: Optional[GenPlanEntry] = None
        grid = [(p, c, d) for p in pss for c in cache_opts
                for d in (depth_grid if p else [0])]
        for ps, cbytes, depth in grid:
            cache_total = kv_bytes(n, r, ps, depth)
            dbytes = ((spec_draft["bytes"]
                       + r * spec_draft["cache_bytes"]) if depth else 0)
            resident = cache_total + cbytes + dbytes
            derived = {}   # (pre_prof, dec_prof) per m — pin-independent
            for pin in range(pin_cap + 1):
                # tier 1: analytic feasibility prunes the (m, pin) grid
                ms = [m for m in range(1, max_m + 1)
                      if budget is None
                      or analytic_peak(m, lb, other, cache_bytes=resident,
                                       pin_window=pin, n_layers=n)
                      <= budget]
                if not ms:
                    # keep one fallback candidate per page size: the
                    # analytic peak overestimates (simulate's in-order
                    # grants are tighter), and page sizes differ in
                    # cache bytes, so pruning all of them here would
                    # hide feasible paged schedules
                    ms = ([1] if pin == 0 and cbytes == cache_opts[0]
                          else [])
                for m in ms:
                    # tier 2: pre-run both round shapes.  The prefill
                    # round loads every layer but RETAINS the pinned
                    # prefix (the engine never destroys it), so it is
                    # pin-dependent too.  Expert-split MoE rounds fold
                    # the expected demand-load time into compute —
                    # prefill runs cold (cache_bytes=0), decode at the
                    # candidate cache's modelled hit rate.
                    if moe:
                        if m not in derived:
                            derived[m] = (
                                _moe_stream_profile(
                                    slim, tokens=r * seq, cache_bytes=0,
                                    m=m, batch=r, key="t_comp"),
                                _moe_stream_profile(
                                    slim, tokens=r, cache_bytes=cbytes,
                                    m=m, batch=r, key="t_decode"))
                        pre_prof, dec_prof = derived[m]
                    else:
                        pre_prof = dec_prof = prof
                    pre_lat, pre_peak = simulate(
                        pre_prof, m, budget, retain_window=pin,
                        extra_resident_bytes=resident, batch=r)
                    # a verify round applies each streamed layer to the
                    # whole (depth + 1)-token window — compute scales,
                    # the weight stream does not
                    dec_lat, dec_peak = simulate(
                        dec_prof, m, budget, pin_window=pin,
                        extra_resident_bytes=resident,
                        t_comp_key="t_decode", batch=r * (depth + 1))
                    exp = expected_commit(depth)
                    n_rounds = math.ceil(rounds / exp) if rounds else 0
                    round_lat = dec_lat + depth * draft_t
                    prompt_len = (max(total_len - new_tokens, 1)
                                  if total_len else seq)
                    if chunk and prompt_len > chunk and ps:
                        # chunked prefill replaces the monolithic
                        # cache-capture round with ceil(Lp/C) decode-shaped
                        # rounds, each stacking C chunk tokens onto the
                        # decode batch — the weight stream is unchanged,
                        # compute scales with the joined width
                        n_chunks = math.ceil(prompt_len / chunk)
                        ch_lat, ch_peak = simulate(
                            dec_prof, m, budget, pin_window=pin,
                            extra_resident_bytes=resident,
                            t_comp_key="t_decode", batch=r + chunk)
                        ttft = n_chunks * ch_lat
                        total = ttft + n_rounds * round_lat
                        peak = max(ch_peak, dec_peak)
                        pre_lat = ttft
                    else:
                        ttft = pre_lat
                        total = pre_lat + n_rounds * round_lat
                        peak = max(pre_peak, dec_peak)
                    tpot = (round_lat / exp
                            if (round_lat and math.isfinite(round_lat))
                            else math.inf)
                    ok = math.isfinite(total) and (budget is None
                                                   or peak <= budget)
                    slo = ((slo_ttft_s is None
                            or (math.isfinite(ttft)
                                and ttft <= slo_ttft_s))
                           and (slo_tpot_s is None
                                or (math.isfinite(tpot)
                                    and tpot <= slo_tpot_s)))
                    tput = r * exp / round_lat \
                        if (round_lat and math.isfinite(round_lat)) \
                        else 0.0
                    cand = GenPlanEntry(budget, m, pin, total, pre_lat,
                                        round_lat, int(peak), cache_total,
                                        ok, inflight=r,
                                        predicted_throughput_tps=tput,
                                        dtype=label,
                                        expert_cache_bytes=cbytes,
                                        page_size=ps,
                                        spec_depth=depth,
                                        draft_bytes=dbytes,
                                        predicted_ttft_s=ttft,
                                        predicted_tpot_s=tpot,
                                        slo_ok=slo,
                                        chunk_prefill=(
                                            chunk if ps else 0))
                    if _gen_better(cand, best):
                        best = cand
        return best

    entries: List[GenPlanEntry] = []
    for budget in budgets:
        chosen: Optional[GenPlanEntry] = None
        fallback: Optional[GenPlanEntry] = None   # best feasible, SLO-miss
        for r in range(max(max_inflight, 1), 0, -1):   # capacity-first
            # candidates union over dtype: a dtype whose shards admit
            # this in-flight count wins over one that must shed requests
            cand: Optional[GenPlanEntry] = None
            for label, prof in profiles:
                c = best_at(label, prof, budget, r)
                if c is not None and _gen_better(c, cand):
                    cand = c
            if cand is not None and cand.feasible:
                if cand.slo_ok:        # feasible AND meets the SLO: done
                    chosen = cand
                    break
                if fallback is None:   # largest feasible count, kept in
                    fallback = cand    # case no count attains the SLO
            if r == 1 and chosen is None:
                # no feasible SLO-meeting schedule at any count: serve
                # degraded (best feasible, slo_ok=False) — or report the
                # least infeasible single-request schedule
                chosen = fallback if fallback is not None else cand
        entries.append(chosen)
    return entries
