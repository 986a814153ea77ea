"""Paged KV-cache subsystem: PagePool + radix-tree prefix sharing.

The dense KV path reserves one contiguous ``max_total_len`` cache block
per request for its whole lifetime, so the decode floor scales with
``inflight x max_seq`` even when requests share long system prompts or
retire early.  This module brings PIPELOAD's "memory as a budgeted,
dynamically managed resource" discipline to the KV side:

  * ``PagePool`` carves the ledger's KV reservation into fixed-size
    pages of ``page_size`` token slots (page size chosen by the Pipeline
    Planner).  A page's bytes are charged to the engine's ``_Ledger``
    exactly once, when the page is first mapped, and released the moment
    its last reference drops — the cache analogue of ``S_dest``.  Freed
    page ids go on a free list and are reused before the pool grows, so
    the physical pool plateaus at its high-water mark instead of growing
    with cumulative traffic.

  * ``PrefixTree`` is a radix tree over token ids at page granularity:
    requests whose prompts share a prefix map the SAME physical pages
    (refcounted), so a fleet of requests behind one system prompt
    charges its pages once.  Full pages are shared on a per-chunk match;
    the trailing partial page is shared only on an exact match (its
    remaining slots will be written by decode, so it must be
    copy-on-write — see below).  Nodes are pruned when their page's last
    reference drops, which keeps the drain-to-zero ledger invariant: no
    page outlives the requests that reference it.

  * Copy-on-write append: writes into a shared page (refcount > 1) must
    first copy it to a fresh private page and swap the request's block
    table entry — ``PagePool.is_shared`` + ``alloc``/``release`` give
    the scheduler the primitives; the row copy happens at the round
    boundary where the tables are rebuilt.

Physical storage is owned by the caller (the scheduler keeps one
``(num_pages, page_size, ...)`` tensor per layer per cache leaf);
this module is the bookkeeping layer — page ids, refcounts, ledger
bytes, and the prefix index.  ``kernels/paged_decode.py`` is the compute
side: CUDA kernels that gather K/V tiles through the block table.

PyTorch port of ``repro/core/kv_pages.py`` (the same code: it holds no
arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import telemetry as _tele


def pages_for(tokens: int, page_size: int) -> int:
    """Number of pages covering ``tokens`` token slots."""
    if tokens <= 0:
        return 0
    return -(-tokens // page_size)


@dataclasses.dataclass
class PoolStats:
    allocs: int = 0            # pages handed out (fresh + reused)
    reuses: int = 0            # allocs served from the free list
    shares: int = 0            # refcount bumps (prefix hits)
    frees: int = 0             # pages whose last reference dropped
    cow_copies: int = 0        # copy-on-write page swaps


class PagePool:
    """Fixed-size KV pages charged against a byte ledger.

    ``page_bytes`` is what ONE page costs across every layer (the
    scheduler computes it as ``num_layers * cache_bytes(1, page_size)``);
    ``ledger`` (an engine ``_Ledger`` or None) is charged on first map
    and credited when the last reference drops.  ``alloc`` never blocks:
    callers check the decode floor first (the admission protocol), so
    the acquire is a plain reservation.
    """

    def __init__(self, page_size: int, page_bytes: int, ledger=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.page_bytes = page_bytes
        self.ledger = ledger
        # ledger attribution: every page charge is `kv_pages`; `detail`
        # is an audit-only sub-key the scheduler sets around
        # request-scoped alloc/release batches (e.g. the request id)
        self.detail: Optional[str] = None
        self._ref: Dict[int, int] = {}      # live page id -> refcount
        self._free: List[int] = []          # recycled ids, LIFO
        self.capacity = 0                   # high-water page count
        self.mapped_peak = 0                # high-water LIVE page count
        self.stats = PoolStats()
        # registry counters cached once (reset() zeroes them in place)
        m = _tele.metrics()
        self._m_allocs = m.counter("pages.allocs")
        self._m_frees = m.counter("pages.frees")
        self._m_cow = m.counter("pages.cow_copies")

    def _sample(self) -> None:
        """Mapped-pages counter track (only when tracing is enabled)."""
        tr = _tele.get_tracer()
        if tr.enabled:
            tr.counter("kv_mapped_pages", len(self._ref))

    # -- introspection ---------------------------------------------------
    @property
    def mapped_pages(self) -> int:
        return len(self._ref)

    @property
    def mapped_bytes(self) -> int:
        return len(self._ref) * self.page_bytes

    @property
    def mapped_peak_bytes(self) -> int:
        return self.mapped_peak * self.page_bytes

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def is_shared(self, pid: int) -> bool:
        return self._ref.get(pid, 0) > 1

    # -- lifecycle -------------------------------------------------------
    def alloc(self) -> int:
        """Map a fresh private page (refcount 1); charges the ledger."""
        if self._free:
            pid = self._free.pop()
            self.stats.reuses += 1
        else:
            pid = self.capacity
            self.capacity += 1
        self._ref[pid] = 1
        self.stats.allocs += 1
        self._m_allocs.inc()
        self.mapped_peak = max(self.mapped_peak, len(self._ref))
        self._sample()
        if self.ledger is not None:
            self.ledger.acquire(self.page_bytes, owner="kv_pages",
                                detail=self.detail)
        return pid

    def share(self, pid: int) -> int:
        """Add a reference to an already-mapped page (no new bytes)."""
        if pid not in self._ref:
            raise KeyError(f"page {pid} is not mapped")
        self._ref[pid] += 1
        self.stats.shares += 1
        return pid

    def release(self, pid: int) -> bool:
        """Drop one reference; True when the page was actually freed
        (last reference — its bytes return to the ledger and the id to
        the free list)."""
        refs = self._ref.get(pid)
        if refs is None:
            raise KeyError(f"page {pid} is not mapped")
        if refs > 1:
            self._ref[pid] = refs - 1
            return False
        del self._ref[pid]
        self._free.append(pid)
        self.stats.frees += 1
        self._m_frees.inc()
        self._sample()
        if self.ledger is not None:
            self.ledger.release(self.page_bytes, owner="kv_pages",
                                detail=self.detail)
        return True


# ===========================================================================
# Radix-tree prefix index (page-granular)
# ===========================================================================
class _Node:
    __slots__ = ("pid", "children")

    def __init__(self, pid: int):
        self.pid = pid
        self.children: Dict[Tuple[int, ...], "_Node"] = {}


class PrefixTree:
    """Radix tree over token ids, one node per mapped prompt page.

    Children are keyed by the page's token tuple: a full ``page_size``
    chunk matches any request whose prompt continues with those exact
    tokens; a trailing PARTIAL chunk (the prompt's last, not-full page)
    is keyed by its shorter tuple, so it is shared only between prompts
    that end identically — the slots beyond it belong to each request's
    own generation and the scheduler copy-on-writes the page before the
    first divergent write.

    The tree only indexes LIVE pages: ``forget(pid)`` (called when a
    page's last reference drops) prunes the node, so sharing happens
    among concurrently-resident requests and the pool still drains to
    zero when everything retires.  A freed parent implies freed children
    (prefix refcounts are monotone down the path), so pruning a node
    never orphans a live descendant.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _Node(-1)
        self._where: Dict[int, Tuple[_Node, Tuple[int, ...]]] = {}
        self.hits = 0               # pages served by sharing
        self.misses = 0             # pages that had to be allocated

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        toks = [int(t) for t in tokens]
        return [tuple(toks[i:i + ps]) for i in range(0, len(toks), ps)]

    def walk(self, tokens: Sequence[int]
             ) -> Tuple[List[_Node], List[Tuple[int, ...]]]:
        """One radix descent (no mutation): the matched node path for
        the longest shareable prefix, plus ALL page chunks of the
        prompt — reusable by ``insert`` so an admission attempt walks
        the tree once, not twice."""
        chunks = self._chunks(tokens)
        node, path = self.root, []
        for key in chunks:
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        return path, chunks

    def match(self, tokens: Sequence[int]) -> int:
        """Longest shareable prefix, in PAGES (no mutation)."""
        return len(self.walk(tokens)[0])

    def insert(self, tokens: Sequence[int], pool: PagePool, *,
               walk: Optional[Tuple[List[_Node],
                                    List[Tuple[int, ...]]]] = None
               ) -> Tuple[List[int], int]:
        """Map the prompt's pages: shared prefix pages are refcount
        bumps, the rest are fresh ``pool.alloc()`` calls registered
        under their token key.  ``walk`` (a ``self.walk(tokens)``
        result; must predate no tree mutation) skips the re-descent.
        Returns ``(page_ids, n_shared)`` — the first ``n_shared``
        entries need no K/V writes (a sibling already holds identical
        content)."""
        path, chunks = walk if walk is not None else self.walk(tokens)
        pids: List[int] = []
        for child in path:
            pool.share(child.pid)
            pids.append(child.pid)
            self.hits += 1
        node = path[-1] if path else self.root
        for key in chunks[len(path):]:
            pid = pool.alloc()
            child = _Node(pid)
            node.children[key] = child
            self._where[pid] = (node, key)
            self.misses += 1
            pids.append(pid)
            node = child
        return pids, len(path)

    def forget(self, pid: int) -> None:
        """Prune the node indexing a freed page (no-op for pages the
        tree never saw, e.g. decode-growth or COW pages)."""
        entry = self._where.pop(pid, None)
        if entry is None:
            return
        parent, key = entry
        child = parent.children.get(key)
        if child is not None and child.pid == pid:
            del parent.children[key]


# ===========================================================================
# Per-tenant prefix namespaces
# ===========================================================================
class PrefixNamespaces:
    """Tenant-keyed family of ``PrefixTree``s over ONE shared ``PagePool``.

    Multi-tenant serving must not leak one tenant's prompt content into
    another's cache reuse: a prefix hit proves the requester already
    knows the tokens, so cross-tenant sharing is a timing/content oracle.
    Namespacing the radix index by tenant id makes isolation structural —
    two tenants submitting byte-identical system prompts map DISJOINT
    physical pages, while requests within a tenant still share theirs.
    The physical pool stays shared (pages are just rows; isolation is an
    indexing property), so retirement in one tenant can never free
    another tenant's pages: their refcounts live on separate nodes.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._trees: Dict[str, PrefixTree] = {}

    def tree(self, tenant: str) -> PrefixTree:
        """The tenant's own radix tree (created on first use)."""
        t = self._trees.get(tenant)
        if t is None:
            t = self._trees[tenant] = PrefixTree(self.page_size)
        return t

    @property
    def tenants(self) -> List[str]:
        return sorted(self._trees)

    @property
    def hits(self) -> int:
        """Prefix-hit pages, summed across tenants (each hit is by
        construction a WITHIN-tenant share)."""
        return sum(t.hits for t in self._trees.values())

    @property
    def misses(self) -> int:
        return sum(t.misses for t in self._trees.values())

    def hits_by_tenant(self) -> Dict[str, int]:
        return {k: t.hits for k, t in sorted(self._trees.items())}


# ===========================================================================
# Per-request block table
# ===========================================================================
@dataclasses.dataclass
class BlockTable:
    """One request's logical-page -> physical-page mapping.

    ``n_shared`` counts the leading prompt pages mapped through the
    prefix tree — their contents were written by a sibling request and
    must not be re-written by this request's prefill (a shared partial
    page may already hold the sibling's generated tokens past this
    request's prompt; they are masked out by the valid-length mask)."""
    pages: List[int] = dataclasses.field(default_factory=list)
    n_shared: int = 0

    def __len__(self) -> int:
        return len(self.pages)

    def release_all(self, pool: PagePool,
                    tree: Optional[PrefixTree] = None) -> int:
        """Retirement: drop this request's reference on every page;
        pages still referenced by a live sibling survive (the
        refcounted exact-drain property).  Returns pages freed."""
        freed = 0
        for pid in self.pages:
            if pool.release(pid):
                freed += 1
                if tree is not None:
                    tree.forget(pid)
        self.pages.clear()
        self.n_shared = 0
        return freed

    # -- speculative branching (copy-on-write off a committed table) ----
    def branch(self, pool: PagePool) -> "BlockTable":
        """Map a speculative branch: a new table sharing EVERY page of
        this one (refcount bumps, zero new bytes, zero copies).  The
        branch starts fully shared (``n_shared == len(pages)``); the
        speculator ``cow``s each page before its first write and
        ``rollback``s the suffix a failed verification leaves behind.
        Commit = ``release_all`` the parent, keep the branch."""
        for pid in self.pages:
            pool.share(pid)
        return BlockTable(list(self.pages), len(self.pages))

    def cow(self, idx: int, pool: PagePool) -> Optional[Tuple[int, int]]:
        """Make logical page ``idx`` privately writable.  Shared pages
        (a sibling or the committed parent holds them) are swapped for a
        fresh alloc — the caller must copy the page's contents
        ``old -> new`` in the physical pool; returns ``(old, new)`` to
        batch that copy.  Already-private pages return None (write in
        place)."""
        pid = self.pages[idx]
        if not pool.is_shared(pid):
            if idx < self.n_shared:
                self.n_shared = idx
            return None
        new = pool.alloc()
        pool.release(pid)        # sibling keeps it: never frees here
        pool.stats.cow_copies += 1
        pool._m_cow.inc()
        tr = _tele.get_tracer()
        if tr.enabled:
            tr.instant("page_cow", old=pid, new=new)
        self.pages[idx] = new
        if idx < self.n_shared:
            self.n_shared = idx
        return pid, new

    def rollback(self, pool: PagePool, keep_pages: int,
                 tree: Optional[PrefixTree] = None) -> int:
        """Drop every page past the first ``keep_pages`` — the O(pages)
        rejection path: a refused speculative suffix is unmapped by
        refcount drops alone, never a copy.  Returns pages freed."""
        freed = 0
        while len(self.pages) > max(keep_pages, 0):
            pid = self.pages.pop()
            if pool.release(pid):
                freed += 1
                if tree is not None:
                    tree.forget(pid)
        self.n_shared = min(self.n_shared, len(self.pages))
        return freed
