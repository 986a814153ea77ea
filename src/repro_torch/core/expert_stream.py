"""Expert-streaming PIPELOAD: routing-aware MoE shard loading, PyTorch port.

Port of ``repro/core/expert_stream.py``.  Hermes streams whole layers
because a dense layer is all-or-nothing.  An MoE FFN is not: with
``top_k`` of ``n_experts`` experts active per token, only about
``top_k / n_experts`` of the FFN bytes matter to a round.  An expert-split
checkpoint (``checkpoint/partition.py``, ``expert_split=True``) holds a
per-layer attention+router shard plus one shard per expert; the Loading
Agents stream the attention+router shards as before, and the experts are
fetched on demand: after the router runs, the engine loads only the union
of top-k experts the round's batch activated.

  * ``ExpertCache``: LRU residency of fetched experts, so repeat
    activations across rounds are hits that skip the disk.  Its bytes
    are charged to the engine's ledger (owner ``expert_cache``): a
    budgeted run reserves the cache's capacity up front (the KV-page
    protocol: the Inference Agent raises ``S_dest`` and must never park on
    ``S_stop`` itself), and under admission pressure the scheduler shrinks
    the reservation (``release_headroom``), evicting LRU experts.  An
    unbudgeted run charges each expert as it is fetched and released.
  * ``ExpertStreamEngine``: what the Inference Agent calls per MoE layer:
    the attention+router module, a host readback of the batch's top-k
    ids, the fetch of their union (hits from the cache; misses loaded in
    parallel on the prefetch runtime's demand pool, through the engine's
    device loader: disk, pinned host memory, then a copy on the loader's
    own CUDA stream, published once that stream has finished), then the
    combine module over the streamed experts.

Streamed outputs equal the in-memory ``models/moe.py`` oracle's: the
router, capacity dispatch and combine are the same functions, evaluated
over only the experts that received tokens.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import telemetry as _tele
from repro_torch.core.prefetch import PrefetchRuntime
from repro_torch.models.config import ModelConfig

_Key = Tuple[str, int]   # (layer shard name, expert index)


class ExpertCache:
    """LRU map of (layer, expert) -> device weights, with byte accounting.

    Pure residency bookkeeping: the ledger lives in
    ``ExpertStreamEngine``."""

    def __init__(self):
        self._entries: "OrderedDict[_Key, Tuple[dict, int]]" = OrderedDict()
        self.resident = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: _Key) -> bool:
        return key in self._entries

    def get(self, key: _Key) -> Optional[dict]:
        """Hit -> weights (the entry becomes most recently used); miss ->
        None."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry[0]

    def peek(self, key: _Key) -> Optional[dict]:
        """Lookup without touching the counters or the LRU order."""
        entry = self._entries.get(key)
        return None if entry is None else entry[0]

    def put(self, key: _Key, weights: dict, nbytes: int):
        old = self._entries.get(key)
        if old is not None:
            self.resident -= old[1]     # a replaced entry counts once
        self._entries[key] = (weights, int(nbytes))
        self._entries.move_to_end(key)
        self.resident += int(nbytes)

    def evict_lru(self, exclude: frozenset = frozenset()
                  ) -> Optional[Tuple[_Key, int]]:
        """Drop the least recently used entry not in ``exclude``; returns
        (key, freed bytes), or None if nothing is evictable."""
        for key in self._entries:
            if key not in exclude:
                _, nbytes = self._entries.pop(key)
                self.resident -= nbytes
                self.evictions += 1
                return key, nbytes
        return None


class ExpertStreamEngine:
    """Demand loading of per-expert shards for one partitioned checkpoint.

    Owned by ``PipeloadEngine`` when the manifest says ``expert_split``:
    the engine's per-layer steps route MoE layers through ``layer`` /
    ``layer_cache`` / ``layer_decode`` here.  ``load(name)`` is the
    engine's device loader (a shard's weights on the device, its copy
    complete), and misses load on ``runtime``'s demand pool, which never
    queues behind Loading Agents parked on ``S_stop``."""

    def __init__(self, manifest: dict, cfg: ModelConfig, fns,
                 load: Callable[[str], dict], runtime: PrefetchRuntime):
        self.cfg = cfg
        self.fns = fns
        self._load = load
        by_index = {s["index"]: s["name"] for s in manifest["shards"]
                    if s["kind"] == "layer"}
        self.rows: Dict[str, Dict[int, dict]] = {}
        for s in manifest["shards"]:
            if s["kind"] == "expert":
                self.rows.setdefault(by_index[s["index"]],
                                     {})[s["expert"]] = s
        if not self.rows:
            raise ValueError("the manifest is tagged expert_split but "
                             "holds no kind='expert' shards")
        all_rows = [r for per in self.rows.values() for r in per.values()]
        self.total_bytes = int(sum(r["bytes"] for r in all_rows))
        self.max_expert_bytes = int(max(r["bytes"] for r in all_rows))
        # the smallest cache that cannot wedge a single-token round: one
        # layer's top_k experts co-resident
        self.min_ws = self.working_set_bytes(1)
        self.cache = ExpertCache()
        self.reserved = 0            # the cache's byte allotment
        self._reserved_mode = False  # True: capacity charged up front
        self._ledger = None
        self._events: List = []
        self._t0 = 0.0
        self._lock = threading.Lock()
        self._runtime = runtime
        self._rounds = 0
        self._unique_total = 0
        self._round_seen: set = set()

    def working_set_bytes(self, tokens: int) -> int:
        """Bytes of the widest fetch a round of ``tokens`` batch tokens
        can lock: min(E, tokens * top_k) experts co-resident."""
        u = min(self.cfg.n_experts, max(int(tokens), 1) * self.cfg.top_k)
        return u * self.max_expert_bytes

    # -- ledger binding ------------------------------------------------
    @property
    def bound(self) -> bool:
        return self._ledger is not None

    def bound_to(self, ledger) -> bool:
        return self._ledger is ledger

    def reserve(self, ledger, capacity: int, events, t0: float):
        """Bind this run's ledger and charge the cache's capacity to it (a
        budgeted ledger up front).  Binding the same ledger again is a
        no-op, so a serving session reserves once."""
        if ledger is self._ledger:
            return
        capacity = int(min(capacity, self.total_bytes))
        with self._lock:
            # a tighter run than the last: shed residency first (the old
            # ledger went with its run)
            while self.cache.resident > capacity:
                self.cache.evict_lru()
            self._ledger = ledger
            self._events = events
            self._t0 = t0
            self._reserved_mode = ledger.budget is not None
            if self._reserved_mode:
                self.reserved = max(capacity, self.cache.resident)
                ledger.acquire(self.reserved, owner="expert_cache")
            else:
                self.reserved = capacity
                if self.cache.resident:
                    ledger.acquire(self.cache.resident, owner="expert_cache")
            events.append((time.perf_counter() - t0, "expert_reserve",
                           str(self.reserved)))

    def release_headroom(self, nbytes: int,
                         floor: Optional[int] = None) -> int:
        """Shrink the budgeted reservation by up to ``nbytes``, never
        below ``floor`` (the workload's working set; at least ``min_ws``),
        evicting LRU experts and releasing their ledger bytes: the cache's
        ``S_dest``, pulled by the scheduler's admission control."""
        if not self._reserved_mode or self._ledger is None:
            return 0
        with self._lock:
            target = max(self.min_ws, floor or 0,
                         self.reserved - int(nbytes))
            if target >= self.reserved:
                return 0
            while self.cache.resident > target:
                evicted = self.cache.evict_lru()
                if evicted is None:
                    break
                self._event("expert_evict",
                            f"{evicted[0][0]}#{evicted[0][1]}")
            target = max(target, self.cache.resident)
            freed = self.reserved - target
            self.reserved = target
        if freed:
            self._ledger.release(freed, owner="expert_cache")
        return freed

    def clear(self):
        """Drop every cached expert (releasing per-expert charges when
        unreserved).  The profiler calls it between layers, so residency
        stays one layer's union."""
        with self._lock:
            while True:
                evicted = self.cache.evict_lru()
                if evicted is None:
                    return
                if self._ledger is not None and not self._reserved_mode:
                    self._ledger.release(evicted[1], owner="expert_cache")

    # -- round bookkeeping ---------------------------------------------
    def begin_round(self):
        self._rounds += 1
        self._round_seen = set()

    def _event(self, kind: str, payload: str):
        self._events.append((time.perf_counter() - self._t0, kind, payload))

    def snapshot(self) -> dict:
        c = self.cache
        return {"hits": c.hits, "misses": c.misses,
                "evictions": c.evictions, "rounds": self._rounds,
                "unique": self._unique_total}

    def stats_since(self, snap: dict) -> dict:
        """RunStats / ServeStats field values accumulated since
        ``snap``."""
        now = self.snapshot()
        rounds = max(now["rounds"] - snap["rounds"], 1)
        return {
            "expert_hits": now["hits"] - snap["hits"],
            "expert_misses": now["misses"] - snap["misses"],
            "expert_evictions": now["evictions"] - snap["evictions"],
            "expert_cache_bytes": (self.reserved if self._reserved_mode
                                   else self.cache.resident),
            "unique_experts_per_round":
                (now["unique"] - snap["unique"]) / rounds,
        }

    # -- demand loading -------------------------------------------------
    def _load_one(self, row: dict) -> dict:
        name = row["name"]
        t = time.perf_counter() - self._t0
        w = self._load(name)
        self._events.append((t, "load_start", name))
        self._event("load_end", name)
        return w

    def fetch(self, layer_name: str, ids: Sequence[int]) -> List[dict]:
        """Resolve the round's activated experts for one layer: hits from
        the cache, misses loaded in parallel.  Returns weight dicts
        aligned with ``ids``."""
        tr = _tele.get_tracer()
        rows = self.rows[layer_name]
        locked = frozenset((layer_name, int(e)) for e in ids)
        out: Dict[int, dict] = {}
        missing: List[int] = []
        with self._lock:
            for e in ids:
                w = self.cache.get((layer_name, e))
                if w is None:
                    missing.append(e)
                else:
                    out[e] = w
            if missing:
                self._make_room(sum(rows[e]["bytes"] for e in missing),
                                locked)
        m = _tele.metrics()
        m.counter("expert.hits").inc(len(ids) - len(missing))
        m.counter("expert.misses").inc(len(missing))
        if missing and tr.enabled:
            with tr.span("expert_fetch", layer=layer_name,
                         misses=len(missing)):
                self._fetch_missing(layer_name, rows, missing, out)
        elif missing:
            self._fetch_missing(layer_name, rows, missing, out)
        if self._rounds:
            self._unique_total += len(locked - self._round_seen)
            self._round_seen |= locked
        return [out[int(e)] for e in ids]

    def _fetch_missing(self, layer_name: str, rows, missing: List[int],
                       out: Dict[int, dict]) -> None:
        futures = [(e, self._runtime.submit(self._load_one, rows[e]))
                   for e in missing]
        for e, fut in futures:
            w = fut.result()
            nbytes = rows[e]["bytes"]
            charge = self._ledger is not None and not self._reserved_mode
            if charge:
                # an unreserved acquire never parks (no budget gate)
                self._ledger.acquire(nbytes, owner="expert_cache")
            with self._lock:
                # a concurrent fetch that missed on the same expert may
                # have put it meanwhile: keep its copy, drop this charge
                cached = self.cache.peek((layer_name, e))
                duplicate = cached is not None
                if duplicate:
                    out[e] = cached
                else:
                    self.cache.put((layer_name, e), w, nbytes)
                    out[e] = w
            if duplicate and charge:
                self._ledger.release(nbytes, owner="expert_cache")
            del w

    def _make_room(self, need: int, locked: frozenset):
        """Evict LRU entries until ``need`` more bytes fit the cache's
        allotment (an unbound engine, e.g. the profiler's, is uncapped)."""
        if self._ledger is None:
            return
        cap = self.reserved
        while self.cache.resident + need > cap:
            evicted = self.cache.evict_lru(exclude=locked)
            if evicted is None:
                raise ValueError(
                    f"expert cache too small for this round's working set "
                    f"on {next(iter(locked))[0]}: needs "
                    f"{self.cache.resident + need} bytes co-resident but "
                    f"the cache reservation is {cap}; raise the budget / "
                    f"expert_cache_bytes, or let the generation-aware "
                    f"planner size the cache")
            key, nbytes = evicted
            if not self._reserved_mode:
                self._ledger.release(nbytes, owner="expert_cache")
            self._event("expert_evict", f"{key[0]}#{key[1]}")
            _tele.metrics().counter("expert.evictions").inc()

    # -- per-layer steps (the Inference Agent's) -------------------------
    def _experts(self, layer_name: str, top_ids: torch.Tensor):
        """The union of the round's top-k ids (ascending; the host
        readback) and their weights."""
        ids = torch.unique(top_ids).tolist()
        return self.fetch(layer_name, ids), ids

    def layer(self, layer_name: str, weights, x):
        xa, hf, top_w, top_ids = self.fns["moe_router"](weights, x)
        experts, ids = self._experts(layer_name, top_ids)
        return self.fns["moe_combine"](experts, ids, xa, hf, top_w, top_ids)

    def layer_cache(self, layer_name: str, weights, x, total_len: int):
        xa, cache, hf, top_w, top_ids = self.fns["moe_router_cache"](
            weights, x, total_len)
        experts, ids = self._experts(layer_name, top_ids)
        return self.fns["moe_combine"](experts, ids, xa, hf, top_w,
                                       top_ids), cache

    def layer_decode(self, layer_name: str, weights, x, cache, pos):
        xa, cache, hf, top_w, top_ids = self.fns["moe_router_decode"](
            weights, x, cache, pos)
        experts, ids = self._experts(layer_name, top_ids)
        return self.fns["moe_combine"](experts, ids, xa, hf, top_w,
                                       top_ids), cache
