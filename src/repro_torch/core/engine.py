"""PIPELOAD Execution Engine (Hermes paper §III), PyTorch port.

Port of ``repro/core/engine.py`` for the dense serving path.  Three worker
roles communicate through an explicit signalling mechanism:

  * ``m`` **Loading Agents** (threads of the ``PrefetchRuntime``): agent
    *i* loads shard stripe ``L_{i+jm}`` from the layer-partitioned
    checkpoint — disk -> pinned host memory -> device on the agent's own
    CUDA stream — then raises ``S_comp(k)``.  A shard is published only
    once its copy has completed on the side stream.
  * one **Inference Agent** (caller thread): layer *k* computes only after
    *k-1*, on the device's compute stream, and raises ``S_dest(k)`` once
    the stream has finished with it (every reference ``block_until_ready``
    is a compute-stream synchronise here).
  * one **Daemon Agent** (the runtime's drainer): keeps the resident-bytes
    ledger, frees destroyed layers and enforces the memory budget: a loader
    asking to exceed it blocks (``S_stop``) until enough is freed.

Engine modes: ``baseline`` (load all, then infer), ``pipeswitch`` (one
loading agent, no destruction) and ``pipeload`` (the paper's mechanism).
``pin_window > 0`` keeps the first layers resident across rounds.

The ledger counts manifest bytes, so its peaks equal the reference's to
the byte at equal schedules; the device allocator's own peak
(``torch.cuda.max_memory_allocated``) is a separate, measured number.

Quantized checkpoints (int8/int4 shards, ``checkpoint/quant.py``) flow
through unchanged: manifest bytes are the quantized sizes, so the ledger,
``S_stop``, the KV decode floor and ``streamed_bytes`` all shrink, and
``QuantizedTensor`` leaves move disk -> pinned host -> device like any
other leaf and stay quantized on the device.

``page_size`` charges the single-request KV cache page by page as decode
reaches new positions (``core/kv_pages.py``), and ``run_batch_round``
serves the scheduler's paged pools and chunked-prefill windows.

Not yet ported (they raise): speculative decoding (``DraftModel``,
``SpecConfig``) and expert streaming.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.partition import (load_manifest, load_shard,
                                              tree_map)
from repro_torch.checkpoint.quant import as_tensor
from repro_torch.core import telemetry as _tele
from repro_torch.core.kv_pages import pages_for
from repro_torch.core.modules import build_module_fns
from repro_torch.core.prefetch import PrefetchRuntime
from repro_torch.models.config import ModelConfig

MODES = ("baseline", "pipeswitch", "pipeload")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported in repro_torch")


def resolve_device(device) -> torch.device:
    """A ``torch.device`` for an entry point's ``device`` argument.  Asking
    for CUDA on a machine without one raises: the port never quietly runs
    on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's current (compute) stream: the port's
    ``block_until_ready``.  No-op on the CPU, where ops run eagerly."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclasses.dataclass
class RunStats:
    mode: str
    num_agents: int
    latency_s: float
    peak_bytes: int
    events: List[Tuple[float, str, str]]
    loads: int = 0
    streamed_bytes: int = 0   # disk bytes read (quantized shards shrink it)
    # generation extras (0 for single-pass runs)
    new_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    cache_bytes: int = 0
    kv_cache: bool = False
    # prefetch fault-injection outcomes (REPRO_PREFETCH_FAULT_RATE)
    retries: int = 0
    faults_absorbed: int = 0
    # per-owner byte shares at the ledger peak (sums exactly to peak_bytes)
    peak_breakdown: Dict[str, int] = dataclasses.field(default_factory=dict)

    def event_log(self, kinds=None):
        return [e for e in self.events if kinds is None or e[1] in kinds]

    @property
    def per_token_s(self) -> float:
        """Mean latency per generated token (whole run / tokens)."""
        return self.latency_s / self.new_tokens if self.new_tokens else 0.0


_AUDIT_ENV = "REPRO_LEDGER_AUDIT"


class LedgerAuditError(AssertionError):
    """A memory-accounting invariant broke under ``REPRO_LEDGER_AUDIT=1``:
    a per-owner balance went negative (double release / wrong owner tag)
    or an owner held bytes at a drain point (leak).  The message names
    the owner and the call sites involved."""


def _caller_site(depth: int) -> str:
    """``file.py:line`` of the frame ``depth`` levels up (audit only)."""
    try:
        f = sys._getframe(depth)
        return f"{Path(f.f_code.co_filename).name}:{f.f_lineno}"
    except ValueError:  # pragma: no cover - stack shallower than depth
        return "<unknown>"


class _LedgerAudit:
    """Event recorder behind a ``_Ledger`` when ``REPRO_LEDGER_AUDIT=1``:
    the full event log, a per-owner stack of outstanding acquires with
    their call sites, and per-``(owner, detail)`` balances.  All methods
    are called with the ledger's cond lock held."""

    def __init__(self):
        self.events: List[Tuple[str, str, Optional[str], int, str]] = []
        self.open: Dict[str, List[Tuple[int, str]]] = {}
        self.balance: Dict[Tuple[str, Optional[str]], int] = {}

    def charge(self, owner, detail, nbytes, depth=3):
        site = _caller_site(depth)
        self.events.append(("acquire", owner, detail, nbytes, site))
        self.open.setdefault(owner, []).append((nbytes, site))
        key = (owner, detail)
        self.balance[key] = self.balance.get(key, 0) + nbytes

    def _unwind(self, owner, nbytes):
        # releases may split or merge acquires byte-wise; only the byte
        # totals must match
        left = nbytes
        stack = self.open.get(owner, [])
        while left > 0 and stack:
            got, site0 = stack.pop()
            if got > left:
                stack.append((got - left, site0))
                left = 0
            else:
                left -= got

    def credit(self, owner, detail, nbytes, owner_resident, depth=3):
        site = _caller_site(depth)
        self.events.append(("release", owner, detail, nbytes, site))
        if owner_resident < 0:
            stack = self.open.get(owner, [])
            last = stack[-1][1] if stack else "<no outstanding acquires>"
            raise LedgerAuditError(
                f"ledger audit: owner '{owner}' balance went negative "
                f"({owner_resident} bytes) releasing {nbytes} at {site} "
                f"— double release or wrong owner tag; last outstanding "
                f"acquire: {last}")
        key = (owner, detail)
        self.balance[key] = self.balance.get(key, 0) - nbytes
        self._unwind(owner, nbytes)

    def move(self, src, dst, nbytes, src_resident, detail, depth=3):
        site = _caller_site(depth)
        self.events.append(("transfer", f"{src}->{dst}", detail, nbytes,
                            site))
        if src_resident < 0:
            raise LedgerAuditError(
                f"ledger audit: transfer of {nbytes} bytes from '{src}' "
                f"to '{dst}' at {site} drove '{src}' negative "
                f"({src_resident} bytes)")
        self._unwind(src, nbytes)
        self.open.setdefault(dst, []).append((nbytes, site))

    def check_drained(self, by_owner, owners):
        bad = []
        for o in owners:
            resid = by_owner.get(o, 0)
            if resid:
                sites = [s for _, s in self.open.get(o, [])]
                where = ", ".join(sites[-3:]) if sites else "<unknown site>"
                bad.append(f"owner '{o}' holds {resid} bytes "
                           f"(outstanding acquires: {where})")
        if bad:
            raise LedgerAuditError(
                "ledger audit: non-zero residue at drain point: "
                + "; ".join(bad))


class _Ledger:
    """Resident-bytes accounting + budget gate (Daemon Agent state).

    Every ``acquire``/``release`` carries an ``owner`` tag so the total
    decomposes into per-tier balances; at every new peak the breakdown is
    snapshotted under the same lock, so ``peak_breakdown`` sums exactly to
    ``peak``.  ``transfer`` re-attributes bytes between owners.  Telemetry
    gauges and (when tracing) counter tracks follow the resident total.
    Audit mode (``REPRO_LEDGER_AUDIT=1``) records every event with its
    call site and raises ``LedgerAuditError`` on a negative balance or on
    residue at an ``audit_check_drained`` point."""

    def __init__(self, budget: Optional[int]):
        self.budget = budget
        self.resident = 0
        self.peak = 0
        self.by_owner: Dict[str, int] = {}
        self.peak_breakdown: Dict[str, int] = {}
        self.cond = threading.Condition()
        self._gauge = _tele.metrics().gauge("ledger.resident_bytes")
        self._owner_gauges: Dict[str, object] = {}
        self.audit = (_LedgerAudit()
                      if os.environ.get(_AUDIT_ENV) == "1" else None)

    def _sample(self, owner: str):
        self._gauge.set(self.resident)
        og = self._owner_gauges.get(owner)
        if og is None:
            og = self._owner_gauges[owner] = _tele.metrics().gauge(
                f"ledger.{owner}.resident_bytes")
        og.set(self.by_owner.get(owner, 0))
        tr = _tele.get_tracer()
        if tr.enabled:
            tr.counter("ledger_resident_bytes", self.resident)
            tr.counter(f"ledger_resident_bytes.{owner}",
                       self.by_owner.get(owner, 0))

    def acquire(self, nbytes: int, stop_flag=None, *,
                owner: str = "untagged", detail: Optional[str] = None):
        """Loader-side: blocks while the budget would be exceeded (the
        paper's S_stop)."""
        with self.cond:
            if self.budget is not None:
                while (self.resident + nbytes > self.budget
                       and self.resident > 0
                       and not (stop_flag() if stop_flag else False)):
                    self.cond.wait(timeout=0.1)
            self.resident += nbytes
            self.by_owner[owner] = self.by_owner.get(owner, 0) + nbytes
            if self.resident > self.peak:
                self.peak = self.resident
                self.peak_breakdown = {o: b for o, b in
                                       self.by_owner.items() if b}
            if self.audit is not None:
                self.audit.charge(owner, detail, nbytes)
            self._sample(owner)

    def release(self, nbytes: int, *, owner: str = "untagged",
                detail: Optional[str] = None):
        with self.cond:
            self.resident -= nbytes
            self.by_owner[owner] = self.by_owner.get(owner, 0) - nbytes
            if self.audit is not None:
                self.audit.credit(owner, detail, nbytes,
                                  self.by_owner[owner])
            self._sample(owner)
            self.cond.notify_all()

    def transfer(self, nbytes: int, src: str, dst: str, *,
                 detail: Optional[str] = None):
        """Re-attribute resident bytes from ``src`` to ``dst``."""
        with self.cond:
            self.by_owner[src] = self.by_owner.get(src, 0) - nbytes
            self.by_owner[dst] = self.by_owner.get(dst, 0) + nbytes
            if self.audit is not None:
                self.audit.move(src, dst, nbytes, self.by_owner[src],
                                detail)
            self._sample(src)
            self._sample(dst)

    def audit_check_drained(self, *owners: str):
        """Raise ``LedgerAuditError`` if any named owner still holds
        bytes (no-op when audit mode is off)."""
        if self.audit is None:
            return
        with self.cond:
            self.audit.check_drained(self.by_owner, owners)

    def audit_residue(self, owner: str, detail: Optional[str] = None):
        """Outstanding bytes for ``(owner, detail)`` — audit mode only."""
        if self.audit is None:
            return None
        with self.cond:
            return self.audit.balance.get((owner, detail), 0)


def _fault_snap() -> Tuple[int, ...]:
    return _tele.counter_values("prefetch.retries",
                                "prefetch.faults_absorbed")


def _fault_delta(snap: Tuple[int, ...]) -> dict:
    now = _fault_snap()
    return {"retries": now[0] - snap[0], "faults_absorbed": now[1] - snap[1]}


class PipeloadEngine:
    def __init__(self, ckpt_dir, cfg: ModelConfig, *,
                 mode: str = "pipeload", num_agents: int = 4,
                 budget_bytes: Optional[int] = None, pin_window: int = 0,
                 attn_impl: Optional[str] = "auto",
                 page_size: Optional[int] = None, device="cuda"):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
        self.device = resolve_device(device)
        self.dir = Path(ckpt_dir)
        self.cfg = cfg
        self.mode = mode
        self.m = max(1, num_agents) if mode == "pipeload" else 1
        self.budget = budget_bytes
        self.pin = pin_window if mode == "pipeload" else 0
        # paged KV: the cache's ledger bytes are charged in page_size-token
        # pages as positions are reached (None = one dense reservation)
        self.page_size = page_size if page_size and page_size > 0 else None
        self.manifest = load_manifest(ckpt_dir)
        self.fns = build_module_fns(cfg, attn_impl=attn_impl,
                                    device=self.device)
        self.shards = {s["name"]: s for s in self.manifest["shards"]}
        self.layer_names = [s["name"] for s in self.manifest["shards"]
                            if s["kind"] == "layer"]
        self._resident: Dict[str, dict] = {}
        self.runtime = PrefetchRuntime(workers=self.m, name="pipeload")
        # Loading Agents copy on their own CUDA streams; the Inference
        # Agent computes on this one
        self._compute_stream = (torch.cuda.current_stream(self.device)
                                if self.device.type == "cuda" else None)
        self._tls = threading.local()

    def close(self):
        """Tear down the prefetch runtime (joins worker + drainer
        threads).  Idempotent."""
        self.runtime.close()

    def __enter__(self) -> "PipeloadEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _sync(self):
        synchronize(self.device)

    def tokens(self, tokens) -> torch.Tensor:
        """Token ids (array-like) as a long tensor on the engine's device."""
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    # ------------------------------------------------------------------
    def warmup(self, batch: int, seq: int):
        """Run each module once at the serving shapes ahead of the timed
        run: it builds the CUDA kernels and warms the allocator and the
        library handles, so the first timed layer does not stall the
        Inference Agent while the Loading Agents race ahead."""
        tokens = torch.zeros((batch, seq), dtype=torch.long,
                             device=self.device)
        emb = self._resident.get("embed") or self._load("embed")
        head = self._resident.get("head") or self._load("head")
        w0 = self._load(self.layer_names[0])
        x = self._apply_layer(w0, self.fns["embed"](emb, tokens))
        self.fns["head"](head, x)
        self._sync()
        del w0, emb, head
        return self

    # ------------------------------------------------------------------
    def _side_stream(self) -> "torch.cuda.Stream":
        st = getattr(self._tls, "stream", None)
        if st is None:
            st = self._tls.stream = torch.cuda.Stream(self.device)
        return st

    def _load(self, name: str) -> dict:
        """Disk -> host -> device ("memory" tier).  On CUDA the copy runs
        from pinned memory on this loader thread's own stream and is
        complete before the shard is returned (and so published).
        QuantizedTensor leaves move their payload and scales the same
        way."""
        host = tree_map(as_tensor, load_shard(self.dir, name))
        if self.device.type != "cuda":
            return host
        stream = self._side_stream()
        with torch.cuda.stream(stream):
            dev = tree_map(lambda a: a.pin_memory().to(
                self.device, non_blocking=True), host)
        stream.synchronize()
        # allocated on the side stream, read on the compute stream: the
        # allocator must not hand the block out while the compute stream
        # may still use it
        tree_map(lambda t: t.record_stream(self._compute_stream), dev)
        return dev

    def _apply_layer(self, weights, x):
        y = self.fns["layer"](weights, x)
        self._sync()
        return y

    def _streamed(self, events) -> int:
        """Total shard bytes read from disk this run (manifest sizes)."""
        return sum(self.shards[e[2]]["bytes"] for e in events
                   if e[1] == "load_end")

    # ------------------------------------------------------------------
    def _run_pipeline(self, x, ledger: _Ledger, events, t0,
                      destroy: bool, apply_fn: Optional[Callable] = None):
        """One pipelined pass over the layer stack (PIPELOAD §III-B).
        ``apply_fn(k, weights, x) -> x`` is the Inference Agent's
        per-layer step (it ends in a compute-stream sync); the default is
        the full-sequence forward."""
        names = self.layer_names
        n = len(names)
        if apply_fn is None:
            apply_fn = lambda k, w, h: self._apply_layer(w, h)  # noqa: E731
        preloaded = {k: self._resident[names[k]] for k in range(n)
                     if names[k] in self._resident}
        stream = self.runtime.stream(
            names, [self.shards[nm]["bytes"] for nm in names], self._load,
            ledger=ledger, preloaded=preloaded, events=events, t0=t0)

        tr = _tele.get_tracer()
        with stream, tr.span("stream_round", layers=n):
            for k in range(n):
                w = stream.wait(k)                   # S_comp(k)
                t = time.perf_counter()
                if tr.enabled:
                    with tr.span("compute", layer=names[k]):
                        x = apply_fn(k, w, x)
                else:
                    x = apply_fn(k, w, x)
                events.append((t - t0, "comp_start", names[k]))
                events.append((time.perf_counter() - t0, "comp_end",
                               names[k]))
                name = names[k]
                pinned = k < self.pin
                if pinned and name not in self._resident:
                    self._resident[name] = w
                if destroy and not pinned:
                    stream.destroy(k, w)             # S_dest(k)
                else:
                    stream.keep(k, owner="pin" if pinned else None)
                del w
        if not destroy:
            # pipeswitch: the whole model was resident for the pass; it is
            # swapped out when the pass ends
            for k in range(n):
                if names[k] not in self._resident:
                    ledger.release(self.shards[names[k]]["bytes"],
                                   owner="stream")
        return x

    # ------------------------------------------------------------------
    def _ensure_aux(self, ledger: _Ledger, events, t0):
        """embed + head: loaded up front, resident for the whole run."""
        for aux in ("embed", "head"):
            if aux not in self._resident:
                ledger.acquire(self.shards[aux]["bytes"],
                               owner="pin", detail=aux)
                self._resident[aux] = self._load(aux)
                events.append((time.perf_counter() - t0, "load_end", aux))

    def _forward_once(self, tokens, ledger, events, t0) -> torch.Tensor:
        """embed -> pipelined layers -> head."""
        self._ensure_aux(ledger, events, t0)
        x = self.fns["embed"](self._resident["embed"], tokens)
        if self.mode == "baseline":
            weights = {}
            for name in self.layer_names:
                ledger.acquire(self.shards[name]["bytes"],
                               owner="pin", detail=name)
                weights[name] = self._load(name)
                events.append((time.perf_counter() - t0, "load_end", name))
            for name in self.layer_names:
                x = self._apply_layer(weights[name], x)
            self._baseline_weights = weights     # resident (no destruction)
        else:
            x = self._run_pipeline(x, ledger, events, t0,
                                   self.mode == "pipeload")
        return self.fns["head"](self._resident["head"], x)

    def _stats(self, ledger, events, lat, fsnap, **kw) -> RunStats:
        return RunStats(self.mode, self.m, lat, ledger.peak, events,
                        loads=sum(1 for e in events if e[1] == "load_end"),
                        streamed_bytes=self._streamed(events),
                        peak_breakdown=dict(ledger.peak_breakdown),
                        **_fault_delta(fsnap), **kw)

    def run_single(self, tokens) -> Tuple[torch.Tensor, RunStats]:
        """Single-pass inference."""
        events: List[Tuple[float, str, str]] = []
        ledger = _Ledger(self.budget)
        fsnap = _fault_snap()
        t0 = time.perf_counter()
        logits = self._forward_once(self.tokens(tokens), ledger, events, t0)
        self._sync()
        return logits, self._stats(ledger, events, time.perf_counter() - t0,
                                   fsnap)

    def run_generate(self, tokens, new_tokens: int, *,
                     kv_cache: bool = False, speculative=None
                     ) -> Tuple[torch.Tensor, RunStats]:
        """GPT-style greedy generation: ``kv_cache=False`` re-runs the
        full load+prefix pipeline for every token (§V-B2); ``True``
        prefills once, then decodes token by token against per-layer KV
        caches."""
        if speculative is not None:
            raise _not_ported("speculative decoding")
        if kv_cache:
            return self._generate_kv(tokens, new_tokens)
        events: List[Tuple[float, str, str]] = []
        ledger = _Ledger(self.budget)
        fsnap = _fault_snap()
        toks = self.tokens(tokens)
        t0 = time.perf_counter()
        prefill_s = 0.0
        for step in range(new_tokens):
            if self.mode == "baseline" and step > 0:
                # baseline keeps the model resident: only re-infer
                x = self.fns["embed"](self._resident["embed"], toks)
                for name in self.layer_names:
                    x = self._apply_layer(self._baseline_weights[name], x)
                logits = self.fns["head"](self._resident["head"], x)
            else:
                logits = self._forward_once(toks, ledger, events, t0)
            nxt = torch.argmax(logits, -1)[:, None]
            toks = torch.cat([toks, nxt], dim=1)
            if step == 0:
                self._sync()
                prefill_s = time.perf_counter() - t0
        self._sync()
        lat = time.perf_counter() - t0
        return toks, self._stats(ledger, events, lat, fsnap,
                                 new_tokens=new_tokens, prefill_s=prefill_s,
                                 decode_s=lat - prefill_s)

    # ------------------------------------------------------------------
    def _generate_kv(self, tokens, new_tokens: int
                     ) -> Tuple[torch.Tensor, RunStats]:
        """One cache-capturing prefill, then ``new_tokens - 1``
        single-token passes over the same pipeline."""
        if new_tokens <= 0:
            return self.tokens(tokens), RunStats(self.mode, self.m, 0.0, 0,
                                                 [], kv_cache=True)
        events: List[Tuple[float, str, str]] = []
        ledger = _Ledger(self.budget)
        fsnap = _fault_snap()
        toks = self.tokens(tokens)
        b, s0 = toks.shape
        total = s0 + new_tokens
        names = self.layer_names
        n = len(names)
        # paged accounting: the feasibility check covers the final page
        # count (a single request cannot be preempted mid-generation)
        ps = self.page_size
        if ps:
            cache_total = pages_for(total, ps) * n * self.cfg.cache_bytes(b,
                                                                           ps)
        else:
            cache_total = n * self.cfg.cache_bytes(b, total)
        self._check_kv_budget(cache_total)

        caches: Dict[str, dict] = {}
        t0 = time.perf_counter()
        self._ensure_aux(ledger, events, t0)
        # reserve the cache bytes the NEXT round needs before its pipeline
        # starts: the Inference Agent raises S_dest, so it must never park
        # on S_stop.  Dense runs take everything here, paged runs grow
        # page by page.
        mapped = {"bytes": 0}

        def ensure_slots(slots: int):
            need = (pages_for(slots, ps) * n * self.cfg.cache_bytes(b, ps)
                    if ps else cache_total)
            if need > mapped["bytes"]:
                ledger.acquire(need - mapped["bytes"], owner="kv_pages")
                events.append((time.perf_counter() - t0, "cache_reserve",
                               str(need - mapped["bytes"])))
                mapped["bytes"] = need

        ensure_slots(s0 if ps else total)
        x = self.fns["embed"](self._resident["embed"], toks)

        def prefill_apply(k, w, h):
            h, caches[names[k]] = self.fns["layer_cache"](w, h, total)
            self._sync()
            events.append((time.perf_counter() - t0, "cache_alloc",
                           names[k]))
            return h

        if self.mode == "baseline":
            weights = getattr(self, "_baseline_weights", None)
            if weights is None:
                weights = {}
                for name in names:
                    ledger.acquire(self.shards[name]["bytes"],
                                   owner="pin", detail=name)
                    weights[name] = self._load(name)
                    events.append((time.perf_counter() - t0, "load_end",
                                   name))
                self._baseline_weights = weights
            else:
                for name in names:   # already resident from an earlier run
                    ledger.acquire(self.shards[name]["bytes"],
                                   owner="pin", detail=name)
            for k, name in enumerate(names):
                x = prefill_apply(k, weights[name], x)
        else:
            x = self._run_pipeline(x, ledger, events, t0,
                                   self.mode == "pipeload",
                                   apply_fn=prefill_apply)
        logits = self.fns["head"](self._resident["head"], x)
        toks = torch.cat([toks, torch.argmax(logits, -1)[:, None]], dim=1)
        self._sync()
        prefill_s = time.perf_counter() - t0

        def decode_apply(pos):
            def apply(k, w, h):
                h, caches[names[k]] = self.fns["layer_decode"](
                    w, h, caches[names[k]], pos)
                self._sync()
                return h
            return apply

        for step in range(1, new_tokens):
            pos = s0 + step - 1          # cache slot of the token we feed
            ensure_slots(pos + 1)        # paged: map the write page
            events.append((time.perf_counter() - t0, "token", str(step)))
            x = self.fns["embed"](self._resident["embed"], toks[:, -1:])
            if self.mode == "baseline":
                for k, name in enumerate(names):
                    x = decode_apply(pos)(k, self._baseline_weights[name], x)
            else:
                x = self._run_pipeline(x, ledger, events, t0,
                                       self.mode == "pipeload",
                                       apply_fn=decode_apply(pos))
            logits = self.fns["head"](self._resident["head"], x)
            toks = torch.cat([toks, torch.argmax(logits, -1)[:, None]],
                             dim=1)

        self._sync()
        lat = time.perf_counter() - t0
        caches.clear()
        ledger.release(mapped["bytes"], owner="kv_pages")
        ledger.audit_check_drained("stream", "kv_pages")
        return toks, self._stats(ledger, events, lat, fsnap,
                                 new_tokens=new_tokens, prefill_s=prefill_s,
                                 decode_s=lat - prefill_s,
                                 cache_bytes=mapped["bytes"], kv_cache=True)

    # ------------------------------------------------------------------
    # Continuous-batching rounds (core/scheduler.py drives these)
    # ------------------------------------------------------------------
    def run_batch_round(self, ledger: _Ledger, events, t0, *,
                        decode_x=None, decode_caches: Optional[Dict] = None,
                        decode_pos=None, prefill_xs=(),
                        prefill_total: int = 0,
                        paged_pools: Optional[Dict] = None,
                        decode_tables=None, chunk_x=None, chunk_tables=None,
                        chunk_pos=None, prefill_sink=None):
        """ONE pipeline round shared by every in-flight request: layer
        ``k`` streams through memory once and is applied to

          * the stacked single-token states of all decoding requests
            (``decode_x`` (R, 1, D), RAGGED device ``decode_pos`` (R,)),
            against per-layer dense caches with leading row dim R
            (``decode_caches``) or, in paged mode, against ``paged_pools``
            (per layer {k, v} with (P, page, KV, dh) leaves) through the
            device block tables ``decode_tables`` (R, NB) int32;
          * chunked-prefill windows (``chunk_x`` (Bc, C, D) at
            ``chunk_pos`` (Bc,) through ``chunk_tables``), which write
            their K/V into their requests' pages as they go;
          * each joining request's cache-capturing prefill (``prefill_xs``,
            caches padded to ``prefill_total``),

        then destroyed.  Paged pools are written IN PLACE.  Returns
        ``(decode_x', caches, prefill_outs, prefill_caches, chunk_x')``:
        ``caches`` is ``paged_pools`` in paged mode, else the advanced
        ``decode_caches``; ``chunk_x'`` is None when no chunks ran.  With
        ``prefill_sink``, each layer's captured caches (one per prefill
        job) go to ``prefill_sink(layer_name, caches)`` as soon as the
        layer has run, and ``prefill_caches`` comes back empty: a paged
        scheduler writes them into pages then, so no more than one
        layer's dense capture is alive at a time."""
        if self.mode == "baseline":
            raise ValueError(
                "run_batch_round needs a pipelined mode (pipeload / "
                "pipeswitch); baseline keeps the model resident and has "
                "no round to amortise")
        if decode_x is not None and decode_x.shape[1] > 1:
            raise _not_ported("stacked multi-token (speculative verify) "
                              "decode")
        if chunk_x is not None and paged_pools is None:
            raise ValueError(
                "chunked prefill needs paged pools (chunks write K/V "
                "through the block tables)")
        names = self.layer_names
        prefill_caches: List[Dict[str, dict]] = [{} for _ in prefill_xs]

        def apply_fn(k, w, state):
            dx, cx, pxs = state
            if dx is not None and paged_pools is not None:
                dx, paged_pools[names[k]] = self.fns["layer_decode_paged"](
                    w, dx, paged_pools[names[k]], decode_tables, decode_pos)
            elif dx is not None:
                dx, decode_caches[names[k]] = self.fns["layer_decode"](
                    w, dx, decode_caches[names[k]], decode_pos)
            if cx is not None:
                # chunk windows write their prompt slots into their own
                # pages (a shared page gets the bytes a sibling wrote)
                cx, paged_pools[names[k]] = self.fns["layer_verify_paged"](
                    w, cx, paged_pools[names[k]], chunk_tables, chunk_pos)
            nxt, captured = [], []
            for px in pxs:
                px, c = self.fns["layer_cache"](w, px, prefill_total)
                nxt.append(px)
                captured.append(c)
            if prefill_sink is not None and captured:
                prefill_sink(names[k], captured)
            else:
                for i, c in enumerate(captured):
                    prefill_caches[i][names[k]] = c
            self._sync()
            return dx, cx, nxt

        self._ensure_aux(ledger, events, t0)
        dx, cx, pxs = self._run_pipeline((decode_x, chunk_x, list(prefill_xs)),
                                         ledger, events, t0,
                                         destroy=self.mode == "pipeload",
                                         apply_fn=apply_fn)
        caches = paged_pools if paged_pools is not None else decode_caches
        return dx, caches, pxs, prefill_caches, cx

    def _kv_floor(self, cache_total: int) -> int:
        """Smallest budget that cannot deadlock a KV decode round holding
        ``cache_total`` bytes of cache: other layers + all cache + the
        pinned window + one streaming layer (the whole model for the
        non-destroying modes)."""
        other = sum(s["bytes"] for s in self.shards.values()
                    if s["kind"] != "layer")
        layer_sizes = [self.shards[nm]["bytes"] for nm in self.layer_names]
        if self.mode == "pipeload":
            pinned = sum(layer_sizes[:self.pin])
            streaming = max(layer_sizes[self.pin:], default=0)
        else:
            pinned, streaming = sum(layer_sizes), 0
        return other + cache_total + pinned + streaming

    def _check_kv_budget(self, cache_total: int, *, inflight: int = 1):
        """Raise unless the budget clears the decode floor for the full
        multi-request reservation; below it the pipeline deadlocks with
        every loader parked on S_stop."""
        if self.budget is None:
            return
        floor = self._kv_floor(cache_total)
        if self.budget < floor:
            per_req = cache_total // max(inflight, 1)
            raise ValueError(
                f"budget {self.budget} below the KV decode floor {floor} "
                f"for {inflight} in-flight request(s) "
                f"(cache={cache_total} = {inflight} x {per_req} "
                f"cache-page bytes, plus other layers, the pinned window "
                f"and one streaming layer); use the generation-aware "
                f"planner (Hermes.plan_generate) to pick a feasible "
                f"(num_agents, pin_window, max_inflight), or let the "
                f"scheduler queue the request until pages free up")
