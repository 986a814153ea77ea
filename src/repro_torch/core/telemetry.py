"""Unified telemetry: span tracing, metrics registry, trace exporters.

Every subsystem that moves bytes or makes a policy decision emits
through this module — the PrefetchRuntime's acquire→load→publish→destroy
shard lifecycle, the engine's stream rounds and per-layer compute steps,
the scheduler's admit/preempt/retire/shed decisions and chunk-prefill
jobs, ExpertStreamEngine fetches, PagePool mapping and the spec-decode
draft/verify/rollback loop.  Three pieces:

  * **Span tracer** — ``get_tracer().span("shard_load", key=k, bytes=n)``
    context managers record ``(name, thread, t_start, t_end, args)``
    tuples; ``instant()`` records point events (policy decisions) and
    ``counter()`` records sampled time series (ledger resident bytes,
    mapped KV pages).  Process-wide and thread-safe: workers, the
    destroy drainer and the Inference Agent all write the same buffer,
    and the Chrome-trace exporter lays each thread out as its own track.
  * **Metrics registry** — named counters / gauges / histograms with a
    ``snapshot()`` dict.  Always on (an increment is an int add — there
    is nothing to disable); ``RunStats``/``ServeStats`` wire their
    ``retries``/``faults_absorbed`` fields from counter deltas.
  * **Exporters** — ``export_chrome_trace`` writes Chrome trace-event
    JSON (loadable in ``chrome://tracing`` / https://ui.perfetto.dev:
    one track per worker thread, "C" counter tracks, "i" policy
    instants) and ``summary_table`` renders a plain-text metric table.

Zero-cost when disabled: the module-level tracer defaults to
``NULL_TRACER``, whose ``span()`` returns the shared ``NULL_SPAN``
singleton — no span object, no buffer append.  Hot paths (per-layer
compute, every ledger acquire/release, page allocs) additionally guard
on ``tracer.enabled`` so the disabled path builds no argument dicts at
all; per-round and per-job call sites go through the no-op singleton
unconditionally.  Span names and argument keys are platform-stable
(like ``policy_log``), so the golden structural test can pin the trace
shape while timestamps stay free.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN",
    "get_tracer", "enable", "disable",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics",
    "counter_values", "export_chrome_trace", "summary_table",
    "Telemetry", "telemetry",
]


# ===========================================================================
# Span tracer
# ===========================================================================
class _Span:
    """Live span: records on ``__exit__`` so nested spans order by end."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._record_span(self._name, self._t0,
                                  time.perf_counter(), self._args)


class _NullSpan:
    """The do-nothing span: one shared instance, handed out for every
    ``NULL_TRACER.span()`` call (identity-checkable — the overhead-guard
    unit test asserts disabled tracing allocates nothing)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracing: every method is a no-op and ``span()`` returns
    the shared ``NULL_SPAN`` singleton."""

    enabled = False

    def span(self, name: str, **args) -> _NullSpan:
        return NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, value) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer: thread-safe append-only buffers.

    Spans carry the recording thread's name so the exporter can lay one
    track per worker (``pipeload-worker_0``, ``pipeload-drainer``, the
    Inference Agent's ``MainThread``); counters form their own "C"
    tracks keyed by counter name.
    """

    enabled = True

    def __init__(self, t0: Optional[float] = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self._lock = threading.Lock()
        # (name, thread, t_start, t_end, args)
        self.spans: List[Tuple[str, str, float, float, dict]] = []
        # (name, thread, t, args)
        self.instants: List[Tuple[str, str, float, dict]] = []
        # (name, t, value)
        self.counters: List[Tuple[str, float, float]] = []

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def _record_span(self, name: str, t_start: float, t_end: float,
                     args: dict) -> None:
        tname = threading.current_thread().name
        with self._lock:
            self.spans.append((name, tname, t_start, t_end, args))

    def instant(self, name: str, **args) -> None:
        tname = threading.current_thread().name
        t = time.perf_counter()
        with self._lock:
            self.instants.append((name, tname, t, args))

    def counter(self, name: str, value) -> None:
        t = time.perf_counter()
        with self._lock:
            self.counters.append((name, t, float(value)))

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.instants.clear()
            self.counters.clear()


_active: object = NULL_TRACER


def get_tracer():
    """The process-wide tracer (``NULL_TRACER`` unless ``enable()``d)."""
    return _active


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) a recording tracer as the process-wide one."""
    global _active
    _active = tracer if tracer is not None else Tracer()
    return _active


def disable() -> None:
    """Restore the no-op singleton (recorded events are dropped with the
    old tracer unless the caller kept a reference)."""
    global _active
    _active = NULL_TRACER


# ===========================================================================
# Metrics registry
# ===========================================================================
class Counter:
    """Monotonic counter (thread-safe increment)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def _reset(self) -> None:
        with self._lock:
            self.value = 0


class Gauge:
    """Sampled last-value gauge with min/max/sample-count bookkeeping.
    ``set`` is lock-free (single attribute stores under the GIL) — it
    sits on the ledger acquire/release path."""

    __slots__ = ("last", "min", "max", "n")

    def __init__(self):
        self.last = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.n = 0

    def set(self, value) -> None:
        v = float(value)
        self.last = v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.n += 1

    def _reset(self) -> None:
        self.last, self.min, self.max, self.n = 0.0, float("inf"), \
            float("-inf"), 0

    def as_dict(self) -> dict:
        if not self.n:
            return {"last": 0.0, "min": 0.0, "max": 0.0, "n": 0}
        return {"last": self.last, "min": self.min, "max": self.max,
                "n": self.n}


class Histogram:
    """Value-recording histogram; snapshot reports count/mean/p50/p99/max."""

    __slots__ = ("_lock", "values")

    def __init__(self):
        self._lock = threading.Lock()
        self.values: List[float] = []

    def observe(self, value) -> None:
        with self._lock:
            self.values.append(float(value))

    def _reset(self) -> None:
        with self._lock:
            self.values.clear()

    def as_dict(self) -> dict:
        with self._lock:
            vals = list(self.values)
        if not vals:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0,
                    "max": 0.0}
        arr = np.asarray(vals)
        return {"count": len(vals), "mean": float(arr.mean()),
                "p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)),
                "max": float(arr.max())}


class MetricsRegistry:
    """Named instruments, created on first touch.  ``reset()`` zeroes
    instruments IN PLACE, so call sites that cached a Counter/Gauge at
    construction time (the ledger, the prefetch runtime) stay wired
    across serve runs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    def reset(self) -> None:
        with self._lock:
            for c in self._counters.values():
                c._reset()
            for g in self._gauges.values():
                g._reset()
            for h in self._hists.values():
                h._reset()

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.as_dict() for k, g in sorted(gauges.items())},
            "histograms": {k: h.as_dict()
                           for k, h in sorted(hists.items())},
        }


_metrics = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-wide metrics registry (always on)."""
    return _metrics


def counter_values(*names: str) -> Tuple[int, ...]:
    """Current values of the named counters (delta-snapshot helper for
    RunStats/ServeStats wiring)."""
    return tuple(_metrics.counter(n).value for n in names)


# ===========================================================================
# Exporters
# ===========================================================================
def _usec(t: float, t0: float) -> float:
    return max(t - t0, 0.0) * 1e6


def export_chrome_trace(path, tracer: Optional[Tracer] = None) -> dict:
    """Write the tracer's buffers as Chrome trace-event JSON.

    Layout: pid 1, one tid per recording thread ("M" thread_name
    metadata rows name the tracks), "X" complete events for spans, "i"
    thread-scoped instants for policy decisions, and "C" counter events
    (their own implicit tracks, keyed by counter name) for the sampled
    series.  Returns the trace dict (also written to ``path``)."""
    tracer = tracer if tracer is not None else get_tracer()
    if not getattr(tracer, "enabled", False):
        raise ValueError("no active tracer: call telemetry.enable() "
                         "before the run you want to export")
    t0 = tracer.t0
    with tracer._lock:
        spans = list(tracer.spans)
        instants = list(tracer.instants)
        counters = list(tracer.counters)
    events: List[dict] = []
    tids: Dict[str, int] = {}

    def tid(tname: str) -> int:
        t = tids.get(tname)
        if t is None:
            t = tids[tname] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": t, "args": {"name": tname}})
        return t

    for name, tname, ts, te, args in spans:
        events.append({"ph": "X", "cat": "span", "name": name, "pid": 1,
                       "tid": tid(tname), "ts": _usec(ts, t0),
                       "dur": max(te - ts, 0.0) * 1e6, "args": args})
    for name, tname, ts, args in instants:
        events.append({"ph": "i", "cat": "instant", "name": name,
                       "pid": 1, "tid": tid(tname), "s": "t",
                       "ts": _usec(ts, t0), "args": args})
    for name, ts, value in counters:
        events.append({"ph": "C", "cat": "counter", "name": name,
                       "pid": 1, "tid": 0, "ts": _usec(ts, t0),
                       "args": {"value": value}})
    # metadata rows first, then everything else in timestamp order —
    # Perfetto tolerates any order, but a stable layout diffs cleanly
    meta = [e for e in events if e["ph"] == "M"]
    rest = sorted((e for e in events if e["ph"] != "M"),
                  key=lambda e: (e["ts"], e["ph"], e["name"]))
    trace = {"traceEvents": meta + rest, "displayTimeUnit": "ms"}
    if path is not None:
        Path(path).write_text(json.dumps(trace, indent=1))
    return trace


def summary_table(rows: Mapping[str, object], title: str = "metrics"
                  ) -> str:
    """Render ``{name: value}`` as an aligned two-column text table."""
    if not rows:
        return f"{title}: (empty)"
    width = max(len(str(k)) for k in rows)
    lines = [f"{title}:"]
    for k, v in rows.items():
        lines.append(f"  {str(k):<{width}}  {v}")
    return "\n".join(lines)


# ===========================================================================
# Facade handle (Hermes.telemetry())
# ===========================================================================
class Telemetry:
    """Thin handle over the process-wide tracer + registry — what
    ``Hermes.telemetry()`` returns."""

    @property
    def tracer(self):
        return get_tracer()

    @property
    def metrics(self) -> MetricsRegistry:
        return metrics()

    def enable(self, tracer: Optional[Tracer] = None) -> Tracer:
        return enable(tracer)

    def disable(self) -> None:
        disable()

    def export_chrome_trace(self, path) -> dict:
        return export_chrome_trace(path)

    def snapshot(self) -> dict:
        return metrics().snapshot()

    def summary(self, title: str = "metrics") -> str:
        snap = metrics().snapshot()
        rows: Dict[str, object] = {}
        rows.update(snap["counters"])
        rows.update({k: v["last"] for k, v in snap["gauges"].items()})
        rows.update({f"{k}.p50": v["p50"]
                     for k, v in snap["histograms"].items() if v["count"]})
        return summary_table(rows, title=title)


_HANDLE = Telemetry()


def telemetry() -> Telemetry:
    return _HANDLE
