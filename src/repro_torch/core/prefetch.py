"""Unified async prefetch runtime (the shared I/O engine under PIPELOAD).

Every byte-moving subsystem in the repo used to run its own hand-rolled
prefetch loop: the per-round Loading Agent threads in ``core/engine.py``,
the expert-fetch ``ThreadPoolExecutor`` in ``core/expert_stream.py`` and
the profiler's synchronous load-timing loops.  This module replaces all
three with ONE runtime — a bounded worker pool plus a destroy drainer —
and one explicit shard lifecycle::

    acquire ──> load ──> publish ──> consume ──┬─> destroy
      (S_stop)   (disk)    (S_comp)            └─> keep
         │          │          │
         └──────────┴──────────┴──── any failure / cancellation
                                      └─> release (ledger drains exact)

The load-bearing invariant: **bytes charged to a ``_Ledger`` are released
on every exit path** — load exceptions, consumer exceptions, round
cancellation, weights published but never consumed, weights consumed but
never destroyed.  A serving session shares one ledger across every round,
so any leaked charge permanently eats streaming headroom; ``PrefetchStream``
tracks a per-job charge flag and its ``close()`` sweeps whatever the happy
path did not hand off.

In-order grant policy (kept from the original inline thread code, now a
runtime policy): budgeted runs grant ledger bytes in JOB order.  Without
this, a worker loading shard k+1 can win the race for the last slot of
headroom while shard k's worker parks on S_stop — the in-order consumer
then never computes k, nothing is destroyed, and the pipeline deadlocks
even above the budget floor.  Granting in order makes the lowest unloaded
shard the next byte consumer, so the floor (other + cache + pinned + one
streaming shard) really does guarantee progress.

Fault injection (CI's prefetch-fault-smoke): ``REPRO_PREFETCH_FAULT_RATE``
makes stream loads raise a deterministic ``PrefetchFault`` with that
probability and ``REPRO_PREFETCH_RETRIES`` retries transient failures, so
a serve run with an artificially flaky loader still completes — and the
fault-injection tests assert the ledger stays byte-exact either way.
"""
from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core import telemetry as _tele

FAULT_RATE_ENV = "REPRO_PREFETCH_FAULT_RATE"
FAULT_SEED_ENV = "REPRO_PREFETCH_FAULT_SEED"
RETRIES_ENV = "REPRO_PREFETCH_RETRIES"

# job lifecycle states
PENDING = "pending"        # submitted, nothing charged yet
CHARGED = "charged"        # ledger bytes acquired, load in flight
READY = "ready"            # published, waiting for the consumer (S_comp)
CONSUMED = "consumed"      # handed to the consumer, still charged
KEPT = "kept"              # ownership left the stream (pin / pipeswitch)
DESTROYED = "destroyed"    # freed by the drainer, bytes released (S_dest)
RELEASED = "released"      # failure path: charge returned, weights dropped
SKIPPED = "skipped"        # already resident: published without a charge


class PrefetchFault(IOError):
    """Injected transient load failure (fault-injection hooks)."""


class _Job:
    __slots__ = ("index", "key", "nbytes", "state", "charged")

    def __init__(self, index: int, key: str, nbytes: int):
        self.index = index
        self.key = key
        self.nbytes = int(nbytes)
        self.state = PENDING
        self.charged = False


class PrefetchStream:
    """One round's ordered shard loads, lifecycle-managed.

    Built by ``PrefetchRuntime.stream``; the consumer drives it strictly
    in order — ``wait(k)`` blocks on S_comp, then either ``destroy(k, w)``
    (queue the bytes for the drainer, the S_dest path) or ``keep(k)``
    (ownership transfers out: pinned windows and pipeswitch passes, where
    the caller owns the eventual release).  Always ``close()`` (or use as
    a context manager): close aborts outstanding work, drains queued
    destroys, and releases every charge the consumer did not take over.
    """

    def __init__(self, runtime: "PrefetchRuntime", keys: Sequence[str],
                 sizes: Sequence[int], load_fn: Callable[[str], dict], *,
                 ledger=None, preloaded: Optional[Dict[int, dict]] = None,
                 events: Optional[list] = None, t0: float = 0.0,
                 retries: Optional[int] = None, owner: str = "stream"):
        assert len(keys) == len(sizes)
        self._runtime = runtime
        self._load_fn = load_fn
        self._ledger = ledger
        self._owner = owner
        self._events = events
        self._t0 = t0
        self._retries = runtime.retries if retries is None else int(retries)
        self._jobs = [_Job(i, k, b) for i, (k, b) in
                      enumerate(zip(keys, sizes))]
        self._ready: Dict[int, dict] = {}
        self._cond = threading.Condition()        # carries S_comp signals
        self._done = threading.Event()
        self._err: List[BaseException] = []
        # in-order grant policy state (see module docstring): the order
        # is the non-preloaded jobs, lowest index first
        preloaded = preloaded or {}
        self._order = [j.index for j in self._jobs
                       if j.index not in preloaded]
        self._grant = {"pos": 0}
        self._grant_cond = threading.Condition()
        # destroys queued on the runtime drainer but not yet finalized
        self._pending_destroy = 0
        self._destroy_cond = threading.Condition()
        self._futures: List[Future] = []
        for idx, w in preloaded.items():
            job = self._jobs[idx]
            job.state = SKIPPED
            self._ready[idx] = w                  # uncharged publish
        for job in self._jobs:
            if job.state is not SKIPPED:
                self._futures.append(runtime._submit_stream(self._work, job))

    # -- lifecycle: acquire ------------------------------------------------
    def _acquire(self, job: _Job) -> bool:
        """Reserve ``job.nbytes`` under the in-order grant policy; False =
        round aborted (nothing left charged)."""
        if self._ledger is None:
            return not self._done.is_set()
        if self._ledger.budget is not None:
            with self._grant_cond:
                while (not self._done.is_set()
                       and self._grant["pos"] < len(self._order)
                       and self._order[self._grant["pos"]] != job.index):
                    self._grant_cond.wait(timeout=0.1)
            if self._done.is_set():
                return False
        self._ledger.acquire(job.nbytes, self._done.is_set,  # may park: S_stop
                             owner=self._owner, detail=job.key)
        job.charged = True
        job.state = CHARGED
        if self._ledger.budget is not None:
            with self._grant_cond:
                self._grant["pos"] += 1
                self._grant_cond.notify_all()
        if self._done.is_set():
            self._release_job(job)
            return False
        return True

    def _release_job(self, job: _Job):
        """Return a job's charge to the ledger exactly once."""
        with self._cond:
            charged, job.charged = job.charged, False
            job.state = RELEASED
        if charged and self._ledger is not None:
            self._ledger.release(job.nbytes, owner=self._owner,
                                 detail=job.key)

    def _fail(self, e: BaseException):
        self._err.append(e)
        self._done.set()
        with self._cond:
            self._cond.notify_all()
        with self._grant_cond:
            self._grant_cond.notify_all()

    def _event(self, kind: str, key: str, t: float):
        if self._events is not None:
            self._events.append((t - self._t0, kind, key))

    # -- lifecycle: load + publish (worker side) ---------------------------
    def _work(self, job: _Job):
        tr = _tele.get_tracer()
        try:
            if self._done.is_set():
                return
            if tr.enabled:
                with tr.span("shard_acquire", key=job.key,
                             bytes=job.nbytes):
                    ok = self._acquire(job)
            else:
                ok = self._acquire(job)
            if not ok:
                return
            w = None
            t_start = time.perf_counter()
            absorbed = 0
            for attempt in range(self._retries + 1):
                try:
                    self._runtime._maybe_fault(job.key)
                    t_start = time.perf_counter()
                    if tr.enabled:
                        with tr.span("shard_load", key=job.key,
                                     bytes=job.nbytes):
                            w = self._load_fn(job.key)
                    else:
                        w = self._load_fn(job.key)
                    break
                except Exception as e:  # noqa: BLE001 — transient I/O retry
                    if attempt < self._retries and not self._done.is_set():
                        absorbed += 1
                        self._runtime._m_retries.inc()
                        continue
                    self._release_job(job)
                    self._fail(e)
                    return
            if absorbed:
                self._runtime._m_faults.inc(absorbed)
            self._event("load_start", job.key, t_start)
            self._event("load_end", job.key, time.perf_counter())
            if tr.enabled:
                tr.instant("shard_publish", key=job.key, bytes=job.nbytes)
            with self._cond:
                if self._done.is_set():
                    abort = True
                else:
                    abort = False
                    job.state = READY
                    self._ready[job.index] = w
                    self._cond.notify_all()              # S_comp(k)
            if abort:
                self._release_job(job)
        except BaseException as e:  # noqa: BLE001 — never die silently
            self._release_job(job)
            self._fail(e)

    # -- lifecycle: consume ------------------------------------------------
    def wait(self, k: int) -> dict:
        """Block until job ``k`` is published; raises the first worker
        error if the round failed.  The returned weights stay charged —
        finish the lifecycle with ``destroy`` or ``keep``."""
        with self._cond:
            while k not in self._ready and not self._err:
                self._cond.wait(timeout=0.1)
            if self._err:
                raise self._err[0]
            w = self._ready.pop(k)
            job = self._jobs[k]
            if job.state is READY:
                job.state = CONSUMED
        return w

    # -- lifecycle: destroy / keep -----------------------------------------
    def destroy(self, k: int, weights):
        """Queue job ``k``'s weights for the drainer (S_dest): the bytes
        are released off the consumer's critical path."""
        with self._destroy_cond:
            self._pending_destroy += 1
        self._runtime._enqueue_destroy(self, self._jobs[k], weights)

    def keep(self, k: int, owner: Optional[str] = None):
        """Transfer ownership out of the stream: the caller now owns the
        weights AND the ledger charge (pinned windows keep both; the
        pipeswitch pass releases at end-of-pass).  ``owner`` re-attributes
        the charge to that tier (pinned layers become ``pin`` bytes);
        None leaves it on the stream's own tag."""
        with self._cond:
            job = self._jobs[k]
            job.state = KEPT
            charged = job.charged
        if (owner is not None and owner != self._owner and charged
                and self._ledger is not None):
            self._ledger.transfer(job.nbytes, self._owner, owner,
                                  detail=job.key)

    def _finalize_destroy(self, job: _Job, weights):
        """Drainer-side: free the weights and return the charge."""
        tr = _tele.get_tracer()
        if tr.enabled:
            with tr.span("shard_destroy", key=job.key, bytes=job.nbytes):
                self._finalize_destroy_inner(job, weights)
        else:
            self._finalize_destroy_inner(job, weights)

    def _finalize_destroy_inner(self, job: _Job, weights):
        del weights                                  # free device memory
        with self._cond:
            charged, job.charged = job.charged, False
            job.state = DESTROYED
        if charged and self._ledger is not None:
            self._ledger.release(job.nbytes, owner=self._owner,
                                 detail=job.key)
        self._event("destroy", job.key, time.perf_counter())
        with self._destroy_cond:
            self._pending_destroy -= 1
            self._destroy_cond.notify_all()

    # -- lifecycle: close --------------------------------------------------
    def close(self):
        """Abort outstanding work and sweep every remaining charge.

        Safe on every path: workers that already handed off (READY /
        CONSUMED) are swept here; workers still in flight observe
        ``done`` and release their own charge on the way out; queued
        destroys are drained before the sweep so nothing is counted
        twice."""
        self._done.set()
        with self._cond:
            self._cond.notify_all()
        with self._grant_cond:
            self._grant_cond.notify_all()
        deadline = time.monotonic() + 10.0
        for f in self._futures:
            f.cancel()
            try:
                f.result(timeout=max(0.1, deadline - time.monotonic()))
            except BaseException:  # noqa: BLE001 — errors already in _err
                pass
        with self._destroy_cond:
            while self._pending_destroy > 0:
                self._destroy_cond.wait(timeout=0.1)
        for job in self._jobs:
            if job.charged and job.state in (READY, CONSUMED):
                self._ready.pop(job.index, None)
                with self._cond:
                    charged, job.charged = job.charged, False
                if charged and self._ledger is not None:
                    self._ledger.release(job.nbytes, owner=self._owner,
                                         detail=job.key)

    def __enter__(self) -> "PrefetchStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def error(self) -> Optional[BaseException]:
        return self._err[0] if self._err else None


class PrefetchRuntime:
    """Bounded worker pool + destroy drainer shared by every prefetch
    call site (PIPELOAD shard streams, expert demand-loads, profiler
    load timing).  Threads are created lazily on first use; ``close()``
    joins them (fixing the leaked expert-loader threads the old
    per-engine executor left behind)."""

    def __init__(self, workers: int = 4, *, name: str = "prefetch",
                 fault_rate: Optional[float] = None,
                 fault_seed: Optional[int] = None,
                 retries: Optional[int] = None):
        self.workers = max(1, int(workers))
        self.name = name
        self.fault_rate = (float(os.environ.get(FAULT_RATE_ENV, "0") or 0)
                           if fault_rate is None else float(fault_rate))
        seed = (os.environ.get(FAULT_SEED_ENV)
                if fault_seed is None else fault_seed)
        self._fault_rng = random.Random(int(seed) if seed is not None else 0)
        self.retries = (int(os.environ.get(RETRIES_ENV, "0") or 0)
                        if retries is None else int(retries))
        # registry instruments, cached once (reset() zeroes them in place,
        # so these stay wired across serve runs)
        m = _tele.metrics()
        self._m_retries = m.counter("prefetch.retries")
        self._m_faults = m.counter("prefetch.faults_absorbed")
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._demand: Optional[ThreadPoolExecutor] = None
        self._destroy_q: "deque" = deque()
        self._destroy_cond = threading.Condition()
        self._drainer: Optional[threading.Thread] = None
        self._shutdown = False

    # -- worker pools ------------------------------------------------------
    # Two pools, not one: stream workers can PARK — a budgeted loader
    # blocks on S_stop until the consumer destroys a layer.  Demand loads
    # (expert fetches, profiler timing) are issued BY that consumer
    # mid-layer, so queueing them behind parked stream workers would
    # deadlock the round: the parked loader waits for the consumer, the
    # consumer waits for its demand load, the demand load waits for the
    # parked loader's pool slot.
    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._shutdown:
                raise RuntimeError(f"PrefetchRuntime '{self.name}' is closed")
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix=f"{self.name}-worker")
            return self._pool

    def _ensure_demand(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._shutdown:
                raise RuntimeError(f"PrefetchRuntime '{self.name}' is closed")
            if self._demand is None:
                self._demand = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix=f"{self.name}-demand")
            return self._demand

    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        """Demand-pool access (the expert-fetch Loading Agents): never
        queues behind stream workers parked on S_stop."""
        return self._ensure_demand().submit(fn, *args, **kwargs)

    def timed_load(self, fn: Callable, *args):
        """Run ``fn(*args)`` on a demand-pool worker and time it there
        (queueing excluded) — the profiler's load-timing path.  Returns
        ``(result, seconds)``."""
        def _run():
            t0 = time.perf_counter()
            out = fn(*args)
            return out, time.perf_counter() - t0
        return self._ensure_demand().submit(_run).result()

    def _submit_stream(self, fn: Callable, *args) -> Future:
        """Stream-pool access (PrefetchStream's per-job workers)."""
        return self._ensure_pool().submit(fn, *args)

    # -- fault injection ---------------------------------------------------
    def _maybe_fault(self, key: str):
        if self.fault_rate > 0:
            with self._lock:
                hit = self._fault_rng.random() < self.fault_rate
            if hit:
                raise PrefetchFault(f"injected load fault: {key}")

    # -- destroy drainer (the Daemon Agent) --------------------------------
    def _ensure_drainer(self):
        with self._lock:
            if self._drainer is None and not self._shutdown:
                self._drainer = threading.Thread(
                    target=self._drain_loop, daemon=True,
                    name=f"{self.name}-drainer")
                self._drainer.start()

    def _enqueue_destroy(self, stream: PrefetchStream, job: _Job, weights):
        self._ensure_drainer()
        with self._destroy_cond:
            self._destroy_q.append((stream, job, weights))
            self._destroy_cond.notify_all()          # S_dest(k)

    def _drain_loop(self):
        while True:
            with self._destroy_cond:
                while not self._destroy_q and not self._shutdown:
                    self._destroy_cond.wait(timeout=0.05)
                if not self._destroy_q:
                    if self._shutdown:
                        return
                    continue
                stream, job, weights = self._destroy_q.popleft()
            stream._finalize_destroy(job, weights)
            del weights

    # -- stream construction -----------------------------------------------
    def stream(self, keys: Sequence[str], sizes: Sequence[int],
               load_fn: Callable[[str], dict], *, ledger=None,
               preloaded: Optional[Dict[int, dict]] = None,
               events: Optional[list] = None, t0: float = 0.0,
               retries: Optional[int] = None,
               owner: str = "stream") -> PrefetchStream:
        """One round's ordered prefetch over ``keys`` (``preloaded`` maps
        already-resident indices to their weights: published immediately,
        never charged).  ``owner`` tags every ledger charge the stream
        makes (see the reference's engine.LEDGER_OWNERS)."""
        return PrefetchStream(self, keys, sizes, load_fn, ledger=ledger,
                              preloaded=preloaded, events=events, t0=t0,
                              retries=retries, owner=owner)

    # -- teardown ----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._shutdown

    def close(self, wait: bool = True):
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            pool, self._pool = self._pool, None
            demand, self._demand = self._demand, None
            drainer, self._drainer = self._drainer, None
        with self._destroy_cond:
            self._destroy_cond.notify_all()
        if pool is not None:
            pool.shutdown(wait=wait)
        if demand is not None:
            demand.shutdown(wait=wait)
        if drainer is not None and wait:
            drainer.join(timeout=5)

    def __enter__(self) -> "PrefetchRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort: don't leak pool threads
        try:
            self.close(wait=False)
        except BaseException:  # noqa: BLE001 — interpreter teardown
            pass
