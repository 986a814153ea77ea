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
serves the scheduler's paged pools, chunked-prefill windows and
speculative verify windows.

Speculative decoding (``run_generate(speculative=SpecConfig(...))``): a
``DraftModel`` pinned whole on the device proposes ``depth`` tokens, and
ONE pipelined round scores the window through the paged verify kernel;
the longest agreeing prefix plus the target's own next token commit.

Expert-split MoE checkpoints (manifest ``expert_split``,
``core/expert_stream.py``) change what a pipeline stage is, not how it
flows: the Loading Agents stream the per-layer attention+router shards as
above, and the Inference Agent's per-layer step runs the attention+router
module, reads back the batch's top-k expert ids, fetches that union (LRU
``ExpertCache`` hits skip the disk; misses load on the runtime's demand
pool through ``_load``) and runs the combine module over the streamed
experts.  A budgeted run reserves the cache's capacity on the ledger up
front (``_bind_expert``); the scheduler shrinks it under admission
pressure.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
import weakref
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.partition import (load_manifest, load_shard,
                                              tree_map)
from repro_torch.checkpoint.quant import QuantizedTensor, as_tensor
from repro_torch.core import telemetry as _tele
from repro_torch.core.expert_stream import ExpertStreamEngine
from repro_torch.core.kv_pages import BlockTable, PagePool, pages_for
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


_LEAF_ALIGN = 256    # bytes: each leaf's offset in a shard's device buffer


def _packed(host: dict, device: torch.device, stream=None):
    """A shard's tree of host tensors -> (the same tree on ``device``, the
    one buffer its leaves view).  The leaves are packed at
    ``_LEAF_ALIGN``-byte offsets into one host buffer (pinned for a CUDA
    device), copied by one copy on ``stream`` (synchronised before
    returning) into one allocation.  One block per shard keeps the
    caching allocator from rounding each weight up on its own: it does
    not split a cached block when 1 MiB or less would remain, so 1.5 MiB
    int8 expert weights, 13 to a 20 MiB segment, would each take up to
    2 MiB."""
    parts: List[torch.Tensor] = []
    tree_map(lambda a: parts.extend((a.q, a.scale) if isinstance(
        a, QuantizedTensor) else (a,)), host)
    offsets, total = [], 0
    for t in parts:
        offsets.append(total)
        total += -(-t.numel() * t.element_size() // _LEAF_ALIGN) * _LEAF_ALIGN
    staged = torch.empty(total, dtype=torch.uint8,
                         pin_memory=device.type == "cuda")
    for t, off in zip(parts, offsets):
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        staged[off:off + flat.numel()].copy_(flat)
    if stream is None:
        buf = staged.to(device)
    else:
        with torch.cuda.stream(stream):
            buf = staged.to(device, non_blocking=True)
        stream.synchronize()
    views = iter([buf[off:off + t.numel() * t.element_size()]
                  .view(t.dtype).view(t.shape)
                  for t, off in zip(parts, offsets)])

    def place(a):
        if isinstance(a, QuantizedTensor):
            return QuantizedTensor(next(views), next(views), a.bits,
                                   a.shape, a.dtype)
        return next(views)
    return tree_map(place, host), buf


def blas_workspace_bytes(device: torch.device) -> int:
    """Device bytes PyTorch's BLAS holds beside the ledger: the cuBLAS
    workspace of the compute stream (cuBLASLt shares it), taken at the
    process's first matmul and kept for its lifetime.  0 on the CPU.
    Where PyTorch does not report the size, its rule: the
    ``CUBLAS_WORKSPACE_CONFIG`` pairs ``:KiB:count``, by default 32 MiB
    on compute capability 9 and above, else 4096 KiB x 2 + 16 KiB x 8."""
    if device.type != "cuda":
        return 0
    get = getattr(torch._C, "_cuda_getCublasWorkspaceSize", None)
    if get is not None:
        return int(get())
    config = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if config:
        vals = [int(v) for v in config.split(":")[1:]]
        return sum(kib * 1024 * n for kib, n in zip(vals[::2], vals[1::2]))
    if torch.cuda.get_device_capability(device)[0] >= 9:
        return 32 * 2**20
    return (4096 * 2 + 16 * 8) * 1024


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
    # speculative-decoding extras (0 for non-speculative runs)
    spec_depth: int = 0
    spec_rounds: int = 0           # draft-propose / verify rounds run
    draft_tokens: int = 0          # tokens the draft proposed
    accepted_tokens: int = 0       # proposals the target confirmed
    # expert-streaming extras (0 for dense / whole-layer MoE runs)
    expert_hits: int = 0
    expert_misses: int = 0
    expert_evictions: int = 0
    expert_cache_bytes: int = 0
    unique_experts_per_round: float = 0.0
    # prefetch fault-injection outcomes (REPRO_PREFETCH_FAULT_RATE)
    retries: int = 0
    faults_absorbed: int = 0
    # per-owner byte shares at the ledger peak (sums exactly to peak_bytes)
    peak_breakdown: Dict[str, int] = dataclasses.field(default_factory=dict)

    def event_log(self, kinds=None):
        return [e for e in self.events if kinds is None or e[1] in kinds]

    @property
    def expert_hit_rate(self) -> float:
        """Fraction of expert activations served from the ExpertCache."""
        total = self.expert_hits + self.expert_misses
        return self.expert_hits / total if total else 0.0

    @property
    def per_token_s(self) -> float:
        """Mean latency per generated token (whole run / tokens)."""
        return self.latency_s / self.new_tokens if self.new_tokens else 0.0

    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft proposals the target accepted."""
        return (self.accepted_tokens / self.draft_tokens
                if self.draft_tokens else 0.0)


#: Resident-tier owners every acquire/release names (advisory, not an
#: enum): pin (pinned window, embed/head, baseline weights), stream
#: (in-flight streamed shards), expert_cache, kv_pages (KV reservations
#: and mapped pages), draft (the pinned speculative draft's weights) and
#: spec_headroom (per-request draft dense-cache rows).
LEDGER_OWNERS = ("pin", "stream", "expert_cache", "kv_pages", "draft",
                 "spec_headroom")

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


class DraftModel:
    """A small model pinned WHOLE on the device for speculative drafting.

    Unlike the target, whose layers stream through the Loading Agents,
    the draft lives resident under the budget, like the pin window:
    ``pin`` copies every shard to the device and charges the ledger
    (``owner="draft"``); proposals then run the module fns with no disk
    traffic.  Its KV cache is an ordinary dense one (``total_len`` slots
    per row, charged by the caller as extra resident bytes): prefill
    through the flash-attention kernel, decode through flash decoding.

    Pins are counted: one draft may serve several sessions at once, each
    pinning it against its own ledger.  The last ``unpin`` frees the
    device copies, so no draft tensor outlives every ledger charge on the
    device; the shards stay cached on the host for the next ``pin``."""

    def __init__(self, ckpt_dir, cfg: ModelConfig, *,
                 attn_impl: Optional[str] = "auto", device="cuda"):
        self.dir = Path(ckpt_dir)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.manifest = load_manifest(self.dir)
        if self.manifest.get("expert_split"):
            raise ValueError("expert-split checkpoints cannot be draft "
                             "models (the draft must pin whole)")
        self.fns = build_module_fns(cfg, attn_impl=attn_impl,
                                    device=self.device)
        self.shards = {s["name"]: s for s in self.manifest["shards"]}
        self.layer_names = [s["name"] for s in self.manifest["shards"]
                            if s["kind"] == "layer"]
        self.total_bytes = sum(s["bytes"] for s in self.shards.values())
        self._host: Optional[Dict[str, dict]] = None
        self.weights: Optional[Dict[str, dict]] = None
        self._pins = 0

    def cache_bytes(self, batch: int, total_len: int) -> int:
        return (len(self.layer_names)
                * self.cfg.cache_bytes(batch, total_len))

    def pin(self, ledger: Optional[_Ledger] = None):
        """Copy every shard to the device (once, for all pins); charges
        ``ledger`` for the lot."""
        if ledger is not None:
            ledger.acquire(self.total_bytes, owner="draft")
        self._pins += 1
        if self.weights is None:
            if self._host is None:
                self._host = {name: tree_map(as_tensor,
                                             load_shard(self.dir, name))
                              for name in self.shards}
            self.weights = {name: tree_map(lambda a: a.to(self.device), h)
                            for name, h in self._host.items()}
        return self

    def unpin(self, ledger: Optional[_Ledger] = None):
        """Return the draft's bytes to ``ledger``; the last pin's release
        frees the device copies (the host copies stay for the next
        ``pin``)."""
        if ledger is not None:
            ledger.release(self.total_bytes, owner="draft")
        self._pins = max(0, self._pins - 1)
        if self._pins == 0:
            self.weights = None

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def prefill(self, tokens, total_len: int):
        """Prompt pass; returns (last-token logits (B, V), caches)."""
        assert self.weights is not None, "pin() the draft first"
        fns, w = self.fns, self.weights
        x = fns["embed"](w["embed"], self._tokens(tokens))
        caches: Dict[str, dict] = {}
        for name in self.layer_names:
            x, caches[name] = fns["layer_cache"](w[name], x, total_len)
        return fns["head"](w["head"], x), caches

    def decode(self, token: int, caches, pos: int):
        """Feed ``token`` at cache slot ``pos``; returns (logits (1, V),
        caches): the draft's prediction for slot ``pos + 1``."""
        return self.decode_batch([[int(token)]], caches, int(pos))

    def decode_batch(self, tokens, caches, pos):
        """Stacked draft step for the serving scheduler: ``tokens`` (R, 1)
        fed at per-row slots ``pos`` (an int, or (R,) ragged); returns
        (logits (R, V), caches with leading row dim R).  The caches are
        written in place."""
        fns, w = self.fns, self.weights
        x = fns["embed"](w["embed"], self._tokens(tokens))
        if not isinstance(pos, int):
            pos = self._tokens(pos)
        for name in self.layer_names:
            x, caches[name] = fns["layer_decode"](w[name], x, caches[name],
                                                  pos)
        return fns["head"](w["head"], x), caches


@dataclasses.dataclass
class SpecConfig:
    """Speculative-decoding knobs for ``run_generate(speculative=...)``:
    ``depth`` draft tokens are proposed per round (the planner's
    ``spec_depth``); the draft checkpoint must fit resident next to the
    pinned window, and the budget check charges it as extra resident
    bytes."""
    draft_dir: str
    draft_cfg: ModelConfig
    depth: int = 4


class PipeloadEngine:
    def __init__(self, ckpt_dir, cfg: ModelConfig, *,
                 mode: str = "pipeload", num_agents: int = 4,
                 budget_bytes: Optional[int] = None, pin_window: int = 0,
                 attn_impl: Optional[str] = "auto",
                 expert_cache_bytes: Optional[int] = None,
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
        self.attn_impl = attn_impl
        self.fns = build_module_fns(cfg, attn_impl=attn_impl,
                                    device=self.device)
        self.shards = {s["name"]: s for s in self.manifest["shards"]}
        self.layer_names = [s["name"] for s in self.manifest["shards"]
                            if s["kind"] == "layer"]
        self._resident: Dict[str, dict] = {}
        self._drafts: Dict[str, DraftModel] = {}
        self.runtime = PrefetchRuntime(workers=self.m, name="pipeload")
        # Loading Agents copy on their own CUDA streams; the Inference
        # Agent computes on this one
        self._compute_stream = (torch.cuda.current_stream(self.device)
                                if self.device.type == "cuda" else None)
        self._tls = threading.local()
        # expert-split MoE checkpoints demand-load experts after the router,
        # on this runtime's demand pool and through this engine's loader
        self.expert: Optional[ExpertStreamEngine] = None
        self.expert_cache_bytes = expert_cache_bytes
        if self.manifest.get("expert_split"):
            # the loader by weak reference: a cycle engine -> expert engine
            # -> bound method -> engine would keep both, and every weight
            # they hold on the device, alive until the garbage collector
            # ran, past the engine's last use
            load = weakref.WeakMethod(self._load)
            self.expert = ExpertStreamEngine(
                self.manifest, cfg, self.fns, lambda name: load()(name),
                self.runtime)

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
        x = self._apply_layer(w0, self.fns["embed"](emb, tokens), k=0)
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
        """Disk -> host -> device ("memory" tier).  On CUDA the shard's
        leaves (a QuantizedTensor's payload and scales among them) are
        packed into one pinned buffer and copied by one copy on this
        loader thread's own stream into one device allocation, which the
        leaves view (``_packed``); the copy is complete before the shard
        is returned (and so published)."""
        host = tree_map(as_tensor, load_shard(self.dir, name))
        if self.device.type != "cuda":
            return host
        dev, buf = _packed(host, self.device, self._side_stream())
        # allocated on the side stream, read on the compute stream: the
        # allocator must not hand the block out while the compute stream
        # may still use it
        buf.record_stream(self._compute_stream)
        return dev

    # Per-layer steps.  Expert-split MoE layers go through the
    # ExpertStreamEngine (router -> demand-load the union -> combine);
    # everything else runs the whole-layer module fns.
    def _apply_layer(self, weights, x, k: int = 0):
        if self.expert is not None:
            y = self.expert.layer(self.layer_names[k], weights, x)
        else:
            y = self.fns["layer"](weights, x)
        self._sync()
        return y

    def _layer_cache(self, k: int, weights, x, total_len: int):
        if self.expert is not None:
            return self.expert.layer_cache(self.layer_names[k], weights, x,
                                           total_len)
        return self.fns["layer_cache"](weights, x, total_len)

    def _layer_decode(self, k: int, weights, x, cache, pos):
        if self.expert is not None:
            return self.expert.layer_decode(self.layer_names[k], weights, x,
                                            cache, pos)
        return self.fns["layer_decode"](weights, x, cache, pos)

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
        if self.expert is not None:
            self.expert.begin_round()
        if apply_fn is None:
            apply_fn = lambda k, w, h: self._apply_layer(w, h, k=k)  # noqa: E731,E501
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

    def _bind_expert(self, ledger: _Ledger, events, t0, *,
                     round_tokens: int = 1):
        """Reserve the ExpertCache's capacity on this run's ledger (a no-op
        once bound to it).  Called after the run's fixed reservations (aux
        shards, KV), so the automatic capacity is the headroom the pinned
        window and one streaming layer leave.  ``round_tokens`` is the
        widest batch a round of this run feeds the router: the cache must
        hold that round's working set, or the run would wedge with every
        fetched expert locked."""
        if self.expert is None or self.expert.bound_to(ledger):
            return
        cap = self.expert_cache_bytes
        need = self.expert.working_set_bytes(round_tokens)
        if self.budget is not None:
            sizes = [self.shards[nm]["bytes"] for nm in self.layer_names]
            pinned = sum(sizes[:self.pin])
            streaming = max(sizes[self.pin:], default=0)
            head = self.budget - ledger.resident - pinned - streaming
            if cap is None:
                cap = head
            elif min(cap, self.expert.total_bytes) > head:
                # reserving past the headroom would park the Inference
                # Agent on S_stop for good
                raise ValueError(
                    f"expert_cache_bytes={cap} does not fit budget "
                    f"{self.budget}: only {head} bytes of headroom remain "
                    f"after other shards, KV pages, the pinned window and "
                    f"one streaming layer")
        elif cap is None:
            cap = self.expert.total_bytes
        if min(cap, self.expert.total_bytes) < need:
            raise ValueError(
                f"expert cache too small for this workload: "
                f"{min(cap, self.expert.total_bytes)} bytes available but "
                f"a {round_tokens}-token round can lock {need} bytes of "
                f"experts (min(n_experts, tokens*top_k) co-resident); "
                f"raise the budget / expert_cache_bytes, or let the "
                f"generation-aware planner size the schedule")
        self.expert.reserve(ledger, cap, events, t0)

    def _forward_once(self, tokens, ledger, events, t0) -> torch.Tensor:
        """embed -> pipelined layers -> head."""
        self._ensure_aux(ledger, events, t0)
        self._bind_expert(ledger, events, t0,
                          round_tokens=tokens.shape[0] * tokens.shape[1])
        x = self.fns["embed"](self._resident["embed"], tokens)
        if self.mode == "baseline":
            if self.expert is not None:
                self.expert.begin_round()
            weights = {}
            for name in self.layer_names:
                ledger.acquire(self.shards[name]["bytes"],
                               owner="pin", detail=name)
                weights[name] = self._load(name)
                events.append((time.perf_counter() - t0, "load_end", name))
            for k, name in enumerate(self.layer_names):
                x = self._apply_layer(weights[name], x, k=k)
            self._baseline_weights = weights     # resident (no destruction)
        else:
            x = self._run_pipeline(x, ledger, events, t0,
                                   self.mode == "pipeload")
        return self.fns["head"](self._resident["head"], x)

    def _expert_snap(self) -> Optional[dict]:
        return self.expert.snapshot() if self.expert is not None else None

    def _expert_stats(self, snap: Optional[dict]) -> dict:
        """RunStats expert-streaming fields accumulated since ``snap``."""
        if self.expert is None:
            return {}
        return self.expert.stats_since(snap)

    def _stats(self, ledger, events, lat, fsnap, snap=None,
               **kw) -> RunStats:
        return RunStats(self.mode, self.m, lat, ledger.peak, events,
                        loads=sum(1 for e in events if e[1] == "load_end"),
                        streamed_bytes=self._streamed(events),
                        peak_breakdown=dict(ledger.peak_breakdown),
                        **self._expert_stats(snap), **_fault_delta(fsnap),
                        **kw)

    def run_single(self, tokens) -> Tuple[torch.Tensor, RunStats]:
        """Single-pass inference."""
        events: List[Tuple[float, str, str]] = []
        ledger = _Ledger(self.budget)
        snap = self._expert_snap()
        fsnap = _fault_snap()
        t0 = time.perf_counter()
        logits = self._forward_once(self.tokens(tokens), ledger, events, t0)
        self._sync()
        return logits, self._stats(ledger, events, time.perf_counter() - t0,
                                   fsnap, snap)

    def run_generate(self, tokens, new_tokens: int, *,
                     kv_cache: bool = False,
                     speculative: Optional[SpecConfig] = None
                     ) -> Tuple[torch.Tensor, RunStats]:
        """GPT-style greedy generation: ``kv_cache=False`` re-runs the
        full load+prefix pipeline for every token (§V-B2); ``True``
        prefills once, then decodes token by token against per-layer KV
        caches; ``speculative`` (a ``SpecConfig``; needs ``page_size``)
        runs the draft/verify loop, greedy-token-identical to the
        non-speculative paths."""
        if speculative is not None:
            return self._generate_spec(tokens, new_tokens, speculative)
        if kv_cache:
            return self._generate_kv(tokens, new_tokens)
        events: List[Tuple[float, str, str]] = []
        ledger = _Ledger(self.budget)
        snap = self._expert_snap()
        fsnap = _fault_snap()
        toks = self.tokens(tokens)
        t0 = time.perf_counter()
        prefill_s = 0.0
        if self.expert is not None:
            # re-prefill rounds GROW with every token: bind the expert cache
            # against the widest (last) round up front, so an infeasible
            # budget fails here and not mid-generation
            b, s0 = toks.shape
            self._ensure_aux(ledger, events, t0)
            self._bind_expert(ledger, events, t0,
                              round_tokens=b * (s0 + new_tokens - 1))
        for step in range(new_tokens):
            if self.mode == "baseline" and step > 0:
                # baseline keeps the model resident: only re-infer
                if self.expert is not None:
                    self.expert.begin_round()
                x = self.fns["embed"](self._resident["embed"], toks)
                for k, name in enumerate(self.layer_names):
                    x = self._apply_layer(self._baseline_weights[name], x,
                                          k=k)
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
        return toks, self._stats(ledger, events, lat, fsnap, snap,
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
        snap = self._expert_snap()
        fsnap = _fault_snap()
        toks = self.tokens(tokens)
        b, s0 = toks.shape
        total = s0 + new_tokens
        names = self.layer_names
        n = len(names)
        expert_floor = (self.expert.working_set_bytes(b * s0)
                        if self.expert is not None else None)
        # paged accounting: the feasibility check covers the final page
        # count (a single request cannot be preempted mid-generation).
        # Expert-split MoE keeps the dense reservation: _bind_expert sizes
        # the cache from the headroom at bind time, so pages mapped later
        # would find their bytes handed to the cache and park on S_stop.
        ps = self.page_size if self.expert is None else None
        if ps:
            cache_total = pages_for(total, ps) * n * self.cfg.cache_bytes(b,
                                                                           ps)
        else:
            cache_total = n * self.cfg.cache_bytes(b, total)
        self._check_kv_budget(cache_total, expert_floor=expert_floor)

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
        self._bind_expert(ledger, events, t0, round_tokens=b * s0)
        x = self.fns["embed"](self._resident["embed"], toks)

        def prefill_apply(k, w, h):
            h, caches[names[k]] = self._layer_cache(k, w, h, total)
            self._sync()
            events.append((time.perf_counter() - t0, "cache_alloc",
                           names[k]))
            return h

        if self.mode == "baseline":
            if self.expert is not None:
                self.expert.begin_round()
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
                h, caches[names[k]] = self._layer_decode(
                    k, w, h, caches[names[k]], pos)
                self._sync()
                return h
            return apply

        for step in range(1, new_tokens):
            pos = s0 + step - 1          # cache slot of the token we feed
            ensure_slots(pos + 1)        # paged: map the write page
            events.append((time.perf_counter() - t0, "token", str(step)))
            x = self.fns["embed"](self._resident["embed"], toks[:, -1:])
            if self.mode == "baseline":
                if self.expert is not None:
                    self.expert.begin_round()
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
        return toks, self._stats(ledger, events, lat, fsnap, snap,
                                 new_tokens=new_tokens, prefill_s=prefill_s,
                                 decode_s=lat - prefill_s,
                                 cache_bytes=mapped["bytes"], kv_cache=True)

    # ------------------------------------------------------------------
    def _draft_model(self, spec: SpecConfig) -> DraftModel:
        """One DraftModel per checkpoint dir, cached across runs (on the
        engine's device, with its kernels), so a repeat run does not read
        the draft from disk again."""
        key = str(spec.draft_dir)
        if key not in self._drafts:
            self._drafts[key] = DraftModel(spec.draft_dir, spec.draft_cfg,
                                           attn_impl=self.attn_impl,
                                           device=self.device)
        return self._drafts[key]

    def _generate_spec(self, tokens, new_tokens: int, spec: SpecConfig
                       ) -> Tuple[torch.Tensor, RunStats]:
        """Speculative draft/verify generation over the PAGED cache.

        Each round: the pinned draft proposes up to ``spec.depth`` tokens
        (resident decodes, no weight stream); the target scores the whole
        window, the last committed token and every proposal, in ONE
        pipelined round (``layer_verify_paged``); the longest agreeing
        prefix plus the target's own next pick commits.  The window writes
        go to a copy-on-write BRANCH of the block table, so a rejected
        suffix rolls back by dropping page references (never a copy).
        Every committed token is the argmax of target logits over the
        committed context, whatever the draft proposed."""
        if not self.page_size:
            raise ValueError("speculative decoding needs the paged KV "
                             "cache: construct the engine with page_size")
        if self.expert is not None:
            raise ValueError("speculative decoding is not supported with "
                             "expert-split MoE checkpoints (the verify "
                             "window runs whole-layer module fns)")
        if "layer_verify_paged" not in self.fns:
            raise ValueError(
                "speculative decoding needs the stacked GQA verify path; "
                f"config {self.cfg.name} (attention={self.cfg.attention}, "
                f"sliding_window={self.cfg.sliding_window}) only supports "
                "the generic gather path")
        if new_tokens <= 0:
            return self.tokens(tokens), RunStats(self.mode, self.m, 0.0, 0,
                                                 [], kv_cache=True)
        toks_in = self.tokens(tokens)
        b, s0 = toks_in.shape
        if b != 1:
            raise ValueError("run_generate(speculative=...) is the "
                             "single-request path; use the scheduler's "
                             "spec_depth for batched serving")
        if self.mode == "baseline":
            raise ValueError("speculative decoding needs a pipelined mode")
        depth = max(1, int(spec.depth))
        w_max = depth + 1
        ps = self.page_size
        names = self.layer_names
        n = len(names)
        total = s0 + new_tokens
        nb = pages_for(total, ps)
        page_bytes = n * self.cfg.cache_bytes(1, ps)
        draft = self._draft_model(spec)
        draft_cache_bytes = draft.cache_bytes(1, total)
        # feasibility at the WORST mapped-page count: the full-length table
        # plus the window's fresh pages and one COW copy of its write page
        cache_total = (nb + pages_for(w_max, ps) + 1) * page_bytes
        self._check_kv_budget(cache_total, extra_resident=(
            draft.total_bytes + draft_cache_bytes))

        events: List[Tuple[float, str, str]] = []
        ledger = _Ledger(self.budget)
        fsnap = _fault_snap()
        t0 = time.perf_counter()
        self._ensure_aux(ledger, events, t0)
        draft.pin(ledger)
        events.append((time.perf_counter() - t0, "draft_pin",
                       str(draft.total_bytes)))
        ledger.acquire(draft_cache_bytes, owner="spec_headroom")

        toks: List[int] = toks_in.reshape(-1).tolist()
        pool = PagePool(ps, page_bytes, ledger)
        pool_rows = nb + pages_for(w_max, ps) + 2
        table = BlockTable([pool.alloc() for _ in range(pages_for(s0, ps))])

        # ---- draft prefill (resident and cheap)
        _, dcaches = draft.prefill(toks_in, total)
        draft_pos = s0                   # draft-cache slots that match toks

        # ---- target prefill: pipelined cache capture, padded to the page
        # boundary and written into this request's pages layer by layer
        pad_len = pages_for(s0, ps) * ps
        pids = torch.as_tensor(table.pages, device=self.device)
        cfg = self.cfg
        pools: Dict[str, dict] = {}

        def prefill_apply(k, w, h):
            h, cache = self.fns["layer_cache"](w, h, pad_len)
            pools[names[k]] = {}
            for leaf, a in cache.items():
                # (rows, page, *leaf.shape[2:]): GQA's {k, v}, MLA's {c, kr}
                p = torch.zeros((pool_rows, ps) + tuple(a.shape[2:]),
                                dtype=cfg.torch_dtype, device=self.device)
                p[pids] = a[0].reshape((len(table.pages), ps)
                                       + tuple(a.shape[2:])).to(p.dtype)
                pools[names[k]][leaf] = p
            self._sync()
            events.append((time.perf_counter() - t0, "cache_alloc",
                           names[k]))
            return h

        x = self.fns["embed"](self._resident["embed"], toks_in)
        x = self._run_pipeline(x, ledger, events, t0,
                               self.mode == "pipeload",
                               apply_fn=prefill_apply)
        logits = self.fns["head"](self._resident["head"], x)
        toks.append(int(torch.argmax(logits, -1)[0]))
        generated = 1
        prefill_s = time.perf_counter() - t0

        # ---- draft/verify rounds
        tr = _tele.get_tracer()
        spec_rounds = draft_tokens = accepted = 0
        while generated < new_tokens:
            k_prop = min(depth, new_tokens - generated - 1)
            # 1. the draft catches up on committed tokens it has not seen
            # (<= 2 after the first round), then chains k_prop proposals
            logits_d = None
            props: List[int] = []
            with tr.span("draft_propose", depth=k_prop):
                for t in toks[draft_pos:]:
                    logits_d, dcaches = draft.decode(t, dcaches, draft_pos)
                    draft_pos += 1
                for j in range(k_prop):
                    nxt = int(torch.argmax(logits_d, -1)[0])
                    props.append(nxt)
                    if j < k_prop - 1:
                        logits_d, dcaches = draft.decode(nxt, dcaches,
                                                         draft_pos)
                        draft_pos += 1
            # 2. branch the block table copy-on-write and map the verify
            # window's write range [pos0, pos0 + w_r)
            pos0 = len(toks) - 1         # slot of the last committed token
            w_r = k_prop + 1
            br = table.branch(pool)
            while len(br.pages) < pages_for(pos0 + w_r, ps):
                br.pages.append(pool.alloc())
            cow: List[Tuple[int, int]] = []
            for pidx in range(pos0 // ps, pages_for(pos0 + w_r, ps)):
                swap = br.cow(pidx, pool)
                if swap is not None:
                    cow.append(swap)
            if cow:
                old = torch.as_tensor([o for o, _ in cow], device=self.device)
                new = torch.as_tensor([nn for _, nn in cow],
                                      device=self.device)
                for c in pools.values():
                    for a in c.values():
                        a[new] = a[old]
            # 3. ONE stacked weight-stream round scores the window
            tab = torch.zeros((1, nb), dtype=torch.int32)
            tab[0, :len(br.pages)] = torch.as_tensor(br.pages)
            tab = tab.to(self.device)
            pos_t = self.tokens([pos0])
            x = self.fns["embed"](self._resident["embed"],
                                  self.tokens([[toks[-1]] + props]))

            def verify_apply(k, w, h):
                h, pools[names[k]] = self.fns["layer_verify_paged"](
                    w, h, pools[names[k]], tab, pos_t)
                self._sync()
                return h

            events.append((time.perf_counter() - t0, "spec_round",
                           f"w={w_r}"))
            if tr.enabled:
                tr.instant("spec_verify", window=w_r)
            x = self._run_pipeline(x, ledger, events, t0,
                                   self.mode == "pipeload",
                                   apply_fn=verify_apply)
            logits = self.fns["head_all"](self._resident["head"], x)
            greedy = torch.argmax(logits[0], -1).tolist()      # (w_r,)
            # 4. accept the longest agreeing prefix + the target's own next
            # pick (the "bonus" token: its context is fully committed)
            a = 0
            while a < k_prop and props[a] == greedy[a]:
                a += 1
            old_len = len(toks)
            toks.extend(props[:a])
            toks.append(greedy[a])
            generated += a + 1
            # 5. rollback: drop references past the committed length, then
            # commit the branch as the new table
            br.rollback(pool, pages_for(pos0 + a + 1, ps))
            if tr.enabled:
                tr.instant("spec_rollback", accepted=a, proposed=k_prop)
            table.release_all(pool)
            table = br
            # draft-cache slots still agreeing with toks: all it had, minus
            # proposals past the accepted prefix
            draft_pos = old_len + max(0, min(a, k_prop - 1))
            spec_rounds += 1
            draft_tokens += k_prop
            accepted += a

        out = torch.as_tensor([toks], dtype=toks_in.dtype, device=self.device)
        self._sync()
        lat = time.perf_counter() - t0
        table.release_all(pool)
        pools.clear()
        dcaches.clear()
        ledger.release(draft_cache_bytes, owner="spec_headroom")
        draft.unpin(ledger)
        ledger.audit_check_drained("stream", "kv_pages", "draft",
                                   "spec_headroom")
        return out, self._stats(ledger, events, lat, fsnap,
                                new_tokens=new_tokens, prefill_s=prefill_s,
                                decode_s=lat - prefill_s,
                                cache_bytes=pool.mapped_peak_bytes,
                                kv_cache=True, spec_depth=depth,
                                spec_rounds=spec_rounds,
                                draft_tokens=draft_tokens,
                                accepted_tokens=accepted)

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
        if paged_pools is not None and self.expert is not None:
            raise ValueError(
                "paged KV serving is not supported with expert-split "
                "MoE checkpoints yet; repartition whole-layer or drop "
                "page_size")
        if (decode_x is not None and decode_x.shape[1] > 1
                and paged_pools is None):
            raise ValueError(
                "stacked multi-token decode (speculative verify) needs "
                "paged pools; dense decode_caches take one token per "
                "round")
        if chunk_x is not None and paged_pools is None:
            raise ValueError(
                "chunked prefill needs paged pools (chunks write K/V "
                "through the block tables)")
        names = self.layer_names
        prefill_caches: List[Dict[str, dict]] = [{} for _ in prefill_xs]

        def apply_fn(k, w, state):
            dx, cx, pxs = state
            if dx is not None and paged_pools is not None:
                # W>1 stacked states = a speculative verify round: each
                # request's window [pos, pos+W) scores in one pass
                fn = (self.fns["layer_verify_paged"] if dx.shape[1] > 1
                      else self.fns["layer_decode_paged"])
                dx, paged_pools[names[k]] = fn(
                    w, dx, paged_pools[names[k]], decode_tables, decode_pos)
            elif dx is not None:
                dx, decode_caches[names[k]] = self._layer_decode(
                    k, w, dx, decode_caches[names[k]], decode_pos)
            if cx is not None:
                # chunk windows write their prompt slots into their own
                # pages (a shared page gets the bytes a sibling wrote)
                cx, paged_pools[names[k]] = self.fns["layer_verify_paged"](
                    w, cx, paged_pools[names[k]], chunk_tables, chunk_pos)
            nxt, captured = [], []
            for px in pxs:
                px, c = self._layer_cache(k, w, px, prefill_total)
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
        widest = [px.shape[0] * px.shape[1] for px in prefill_xs]
        if decode_x is not None:
            widest.append(decode_x.shape[0])
        if chunk_x is not None:
            widest.append(chunk_x.shape[0] * chunk_x.shape[1])
        self._bind_expert(ledger, events, t0,
                          round_tokens=max(widest, default=1))
        dx, cx, pxs = self._run_pipeline((decode_x, chunk_x, list(prefill_xs)),
                                         ledger, events, t0,
                                         destroy=self.mode == "pipeload",
                                         apply_fn=apply_fn)
        caches = paged_pools if paged_pools is not None else decode_caches
        return dx, caches, pxs, prefill_caches, cx

    def _kv_floor(self, cache_total: int, *,
                  expert_floor: Optional[int] = None,
                  extra_resident: int = 0) -> int:
        """Smallest budget that cannot deadlock a KV decode round holding
        ``cache_total`` bytes of cache: other layers + all cache + the
        pinned window + one streaming layer (the whole model for the
        non-destroying modes) + for expert-split MoE the expert cache.
        ``expert_floor`` sets that term to the workload's shrinkable
        minimum (the scheduler's checks pass it); otherwise a bound
        session counts its live reservation and a pre-run check the
        smallest cache a single-token round runs with.  ``extra_resident``
        adds run-scoped residents outside those tiers: the speculative
        path's pinned draft and its dense cache."""
        other = sum(s["bytes"] for s in self.shards.values()
                    if s["kind"] not in ("layer", "expert"))
        layer_sizes = [self.shards[nm]["bytes"] for nm in self.layer_names]
        if self.mode == "pipeload":
            pinned = sum(layer_sizes[:self.pin])
            streaming = max(layer_sizes[self.pin:], default=0)
        else:
            pinned, streaming = sum(layer_sizes), 0
        expert = 0
        if self.expert is not None:
            if expert_floor is not None:
                expert = expert_floor
            else:
                expert = (self.expert.reserved if self.expert.bound
                          else self.expert.min_ws)
        return (other + cache_total + pinned + streaming + expert
                + extra_resident)

    def _check_kv_budget(self, cache_total: int, *, inflight: int = 1,
                         expert_floor: Optional[int] = None,
                         extra_resident: int = 0):
        """Raise unless the budget clears the decode floor for the full
        multi-request reservation; below it the pipeline deadlocks with
        every loader parked on S_stop.  ``expert_floor`` sets the expert
        cache's term (``_kv_floor``); ``extra_resident`` adds the
        speculative draft's pinned bytes."""
        if self.budget is None:
            return
        floor = self._kv_floor(cache_total, expert_floor=expert_floor,
                               extra_resident=extra_resident)
        if self.budget < floor:
            per_req = cache_total // max(inflight, 1)
            raise ValueError(
                f"budget {self.budget} below the KV decode floor {floor} "
                f"for {inflight} in-flight request(s) "
                f"(cache={cache_total} = {inflight} x {per_req} "
                f"cache-page bytes, plus other layers, the pinned window, "
                f"one streaming layer and, for expert-split MoE, the "
                f"expert cache); use the generation-aware "
                f"planner (Hermes.plan_generate) to pick a feasible "
                f"(num_agents, pin_window, max_inflight), or let the "
                f"scheduler queue the request until pages free up")
