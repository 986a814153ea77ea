"""Deterministic multi-tenant serving traces (the serve-SLO harness),
the port's copy of ``repro/data/traces.py`` (numpy only; the same seeds
make the same traces in both packages).

A trace is the *input* half of a serving experiment: who arrives when,
with which prompt, wanting how many tokens, at what priority, for which
tenant.  Scheduler policy work lives or dies on replayability — a p99
that moves because the workload moved is noise, not signal — so the
generator here is fully seeded and shared by the tests
(``tests/test_torch_serve_slo.py``, which holds it against the
reference's), the golden-trace replay, and the CLI
(``repro_torch.launch.serve --trace/--tenants``).

Workload shape (the usual serving mix, all seeded):

* **Poisson arrivals** on the scheduler's ROUND clock: exponential
  inter-arrival gaps at ``arrival_rate`` requests per round, cumulated
  and floored to integer round numbers.
* **Heavy-tailed prompt lengths**: lognormal, clipped to
  ``[4, max_prompt]`` — most prompts are short, the tail is what
  chunked prefill exists for.
* **Geometric output lengths** clipped to ``[1, max_new]``.
* **Tenant mix**: Zipf-weighted across ``tenants`` ids (tenant 0 is
  the heavy hitter), each tenant owning a deterministic system-prompt
  prefix that a ``share_prefix`` fraction of its requests reuse —
  exercising the per-tenant prefix namespaces without ever sharing
  tokens across tenants.
* **Priority classes** 0..2 drawn ``(70%, 20%, 10%)`` — rare
  high-priority arrivals are what preemption exists for.

Traces serialise to plain JSON (``save_trace``/``load_trace``) so a
golden file diff stays human-readable.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from pathlib import Path
from typing import Dict, List

import numpy as np

PRIORITY_MIX = (0.7, 0.2, 0.1)       # P(priority == 0, 1, 2)


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival in a serving trace (tokens are plain ints)."""
    rid: int
    arrival_round: int
    tenant: str
    priority: int
    prompt: List[int]
    new_tokens: int


def tenant_prefix(tenant: str, length: int, vocab: int,
                  seed: int = 0) -> List[int]:
    """The tenant's deterministic "system prompt": same tokens for every
    request of that tenant (per seed), different across tenants.  Keyed
    by a stable digest (NOT ``hash()``, which is salted per process)."""
    digest = zlib.crc32(tenant.encode("utf-8"))
    h = np.random.default_rng([seed, digest])
    return [int(t) for t in h.integers(0, vocab, (length,))]


def make_trace(n_requests: int, *, tenants: int = 2, seed: int = 0,
               vocab: int = 1000, arrival_rate: float = 1.0,
               prompt_mean: int = 16, max_prompt: int = 48,
               new_mean: int = 6, max_new: int = 12,
               prefix_len: int = 0, share_prefix: float = 0.5
               ) -> List[TraceRequest]:
    """Seeded heavy-tailed multi-tenant Poisson trace (module docs).

    ``prefix_len`` > 0 prepends each tenant's system prompt to a
    ``share_prefix`` fraction of its requests (clipped so prompts stay
    within ``max_prompt``)."""
    rng = np.random.default_rng(seed)
    # Poisson arrivals on the round clock
    gaps = rng.exponential(1.0 / max(arrival_rate, 1e-9), n_requests)
    rounds = np.floor(np.cumsum(gaps)).astype(int)
    # Zipf tenant mix: tenant 0 is the heavy hitter
    w = 1.0 / np.arange(1, tenants + 1, dtype=np.float64)
    w /= w.sum()
    tids = rng.choice(tenants, size=n_requests, p=w)
    prios = rng.choice(len(PRIORITY_MIX), size=n_requests, p=PRIORITY_MIX)
    # heavy-tailed prompt lengths (lognormal), geometric output lengths
    plens = np.clip(rng.lognormal(np.log(max(prompt_mean, 4)), 0.6,
                                  n_requests).astype(int), 4, max_prompt)
    nnews = np.clip(rng.geometric(1.0 / max(new_mean, 1), n_requests),
                    1, max_new)
    prefixes = {t: tenant_prefix(f"t{t}", prefix_len, vocab, seed)
                for t in range(tenants)} if prefix_len else {}
    share = rng.random(n_requests) < share_prefix

    out: List[TraceRequest] = []
    for i in range(n_requests):
        body = [int(t) for t in rng.integers(0, vocab, (int(plens[i]),))]
        if prefix_len and share[i]:
            body = (prefixes[int(tids[i])] + body)[:max_prompt]
        out.append(TraceRequest(
            rid=i, arrival_round=int(rounds[i]), tenant=f"t{int(tids[i])}",
            priority=int(prios[i]), prompt=body,
            new_tokens=int(nnews[i])))
    return out


def trace_max_len(trace: List[TraceRequest]) -> int:
    """Smallest ``max_total_len`` that fits every request."""
    return max(len(r.prompt) + r.new_tokens for r in trace)


def save_trace(trace: List[TraceRequest], path) -> Path:
    path = Path(path)
    path.write_text(json.dumps([dataclasses.asdict(r) for r in trace],
                               indent=1))
    return path


def load_trace(path) -> List[TraceRequest]:
    rows = json.loads(Path(path).read_text())
    return [TraceRequest(**r) for r in rows]


def submit_trace(sched, trace: List[TraceRequest],
                 priorities: bool = True) -> Dict[int, int]:
    """Feed a trace into a ``BatchScheduler``; returns
    ``{trace rid -> scheduler rid}``.  ``priorities=False`` flattens
    every request to priority 0 (the FIFO baseline arm)."""
    return {r.rid: sched.submit(np.asarray(r.prompt, np.int32),
                                r.new_tokens,
                                arrival_round=r.arrival_round,
                                priority=(r.priority if priorities else 0),
                                tenant=r.tenant)
            for r in trace}
