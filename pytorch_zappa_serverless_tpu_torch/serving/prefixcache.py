"""Prefix KV cache: radix-tree page reuse over the paged pool.

The port's copy of the JAX package's ``serving/prefixcache.py``, with the
same semantics: a **radix tree** keyed on ``(adapter slot, token prefix)``
whose compressed edges own frozen, refcounted pages of the scheduler's
:class:`~.kvcache.BlockManager`.  Admission walks the tree, shares every
matched page into the new sequence's block table, and chunked prefill
starts at the cached offset: a warm prompt's first token costs one small
chunk instead of the whole prompt.  Each adapter slot has a tree of its own
(K/V depends on the tenant's deltas); the server wires
``AdapterManager.prefix_invalidate`` to the scheduler's
``invalidate_prefix``, so a detach drops its slot's tree and a reused slot
never resolves the detached tenant's pages.

- **Only whole-prompt, whole-page spans freeze**: the first
  ``len(prompt) // block_size`` pages of a stream whose prefill completed;
  K/V at position i depends only on the weights and ``tokens[:i+1]``, so a
  frozen page holds what any matching prompt would compute.
- **Copy-on-write on divergence**: a matcher that uses a shared page in part
  gets a private clone of it (``BlockManager.cow`` and a device page copy)
  before it writes past the matched offset; a frozen page is never written.
- **Reclaim only pages the tree alone holds, leaf-first, LRU**: a page a
  live stream shares is never freed from under it.

Owned by the paged scheduler's asyncio task, like the BlockManager.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .metrics import Histogram

# Cached-prefix-length histogram bounds (tokens): page-scale through the
# longest configured prompt buckets.
PREFIX_TOKEN_BUCKETS = (4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
                        1024.0, 2048.0)


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.shape[0], b.shape[0])
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


@dataclass(eq=False)
class _Node:
    """One compressed radix edge: ``tokens`` (a whole number of pages) and
    the frozen ``blocks`` backing them.  Children are keyed by their edge's
    FIRST PAGE of tokens — two children of one node never share a full
    first page (insert splits edges at page boundaries), so the key is
    unique; sub-page divergence is found by scanning (small fan-out)."""

    tokens: np.ndarray
    blocks: list[int]
    children: dict[bytes, "_Node"] = field(default_factory=dict)
    tick: int = 0     # LRU stamp (monotonic counter, newest = largest)
    ts: float = 0.0   # wall stamp for TTL decay


def _key(tokens: np.ndarray) -> bytes:
    return np.ascontiguousarray(tokens, np.int32).tobytes()


class PrefixCache:
    """Radix tree of frozen KV pages for ONE paged generation lane.

    The scheduler is the single caller: ``lookup`` at admission, ``insert``
    when a prompt's prefill completes, ``reclaim`` when the pool runs dry
    (before any live stream is evicted), ``decay`` each tick, and
    ``invalidate`` when an adapter slot is detached (a reused slot index
    must never resolve another tenant's KV).
    """

    def __init__(self, mgr, block_size: int, *, max_pages: int = 0,
                 clock=time.monotonic):
        self._mgr = mgr
        self.block_size = int(block_size)
        # Pages the tree may hold before inserts trigger LRU decay;
        # 0 = bounded only by the pool (reclaim frees on demand).
        self.max_pages = int(max_pages)
        self._clock = clock
        # One root per adapter slot index (0 = base).  KV depends on the
        # adapter's deltas, so trees never mix across slots.
        self._roots: dict[int, _Node] = {}  # guarded-by: event-loop
        self._ticks = 0          # guarded-by: event-loop (LRU clock)
        # Live totals.
        self.node_count = 0      # guarded-by: event-loop
        self.page_count = 0      # guarded-by: event-loop
        # Cumulative counters.
        self.hits = 0            # guarded-by: event-loop
        self.misses = 0          # guarded-by: event-loop
        self.cow_copies = 0      # guarded-by: event-loop
        self.evictions = 0       # guarded-by: event-loop (nodes decayed)
        self.nodes_total = 0     # guarded-by: event-loop (nodes ever created)
        self.pages_total = 0     # guarded-by: event-loop (pages ever frozen)
        self.cached_tokens = Histogram(PREFIX_TOKEN_BUCKETS)

    # -- lookup ---------------------------------------------------------------
    def _touch(self, node: _Node):
        self._ticks += 1
        node.tick = self._ticks
        node.ts = self._clock()

    def lookup(self, aidx: int, ids: np.ndarray,
               max_tokens: int) -> tuple[int, list[int]]:
        """Longest frozen prefix of ``ids`` usable by a new stream.

        Returns ``(cached_len, blocks)``: the matched token count (capped at
        ``max_tokens`` — the scheduler passes ``len(prompt) - 1`` so at
        least one token always prefills and samples the first output) and
        the shared pages covering it, ``ceil(cached_len / block_size)`` of
        them.  When ``cached_len`` is not page-aligned the LAST page is
        partially matched: the caller must copy-on-write it before prefill
        writes into it.  Counts a hit (and observes the cached-token
        histogram) when anything matched, a miss otherwise.
        """
        ids = np.ascontiguousarray(ids, np.int32).reshape(-1)
        bs = self.block_size
        node = self._roots.get(int(aidx))
        n = 0
        blocks: list[int] = []
        while node is not None and n < max_tokens:
            child = None
            if n + bs <= ids.shape[0]:
                child = node.children.get(_key(ids[n:n + bs]))
            if child is None:
                # No full-first-page match: scan for a sub-page divergence
                # (the CoW share).  Children have pairwise-distinct first
                # pages, so at most one can share a non-empty head.
                best, best_l = None, 0
                for c in node.children.values():
                    l = _common_prefix(ids[n:], c.tokens)
                    if l > best_l:
                        best, best_l = c, l
                if best is not None:
                    usable = min(best_l, max_tokens - n)
                    take = -(-usable // bs)  # partial last page rides along
                    blocks.extend(best.blocks[:take])
                    n += usable
                    self._touch(best)
                break
            T = int(child.tokens.shape[0])
            l = _common_prefix(ids[n:], child.tokens)
            usable = min(l, max_tokens - n)
            take = -(-usable // bs)
            blocks.extend(child.blocks[:take])
            n += usable
            self._touch(child)
            if usable < T:
                break  # diverged (or capped) inside this edge
            node = child
        if n > 0:
            self.hits += 1
            self.cached_tokens.observe(float(n))
        else:
            self.misses += 1
        return n, blocks

    # -- insert ---------------------------------------------------------------
    def insert(self, aidx: int, ids: np.ndarray, blocks: list[int]) -> int:
        """Freeze a completed prefill's whole-prompt pages into the tree.

        ``blocks`` is the stream's CURRENT table (shared + private pages in
        prompt order); only the first ``len(ids) // block_size`` pages — the
        ones fully covered by prompt tokens, which the stream will never
        write again — are frozen.  Existing paths are just LRU-touched; new
        tail pages are increffed so they survive the stream's release.
        Returns how many pages were newly frozen.
        """
        ids = np.ascontiguousarray(ids, np.int32).reshape(-1)
        bs = self.block_size
        nfull = ids.shape[0] // bs
        if nfull == 0:
            return 0
        root = self._roots.get(int(aidx))
        if root is None:
            root = self._roots[int(aidx)] = _Node(
                tokens=np.zeros((0,), np.int32), blocks=[])
        node, n, end, frozen = root, 0, nfull * bs, 0
        while n < end:
            key = _key(ids[n:n + bs])
            child = node.children.get(key)
            if child is None:
                span = ids[n:end].copy()
                blks = list(blocks[n // bs:nfull])
                for b in blks:
                    self._mgr.incref(b)
                new = _Node(tokens=span, blocks=blks)
                self._touch(new)
                node.children[key] = new
                self.node_count += 1
                self.page_count += len(blks)
                self.nodes_total += 1
                self.pages_total += len(blks)
                frozen += len(blks)
                n = end
                break
            # The child's first page matches by key; find where the edge
            # and our freezable span part ways, page-aligned.
            l = _common_prefix(ids[n:end], child.tokens)
            lb = (l // bs) * bs
            self._touch(child)
            if lb < child.tokens.shape[0]:
                self._split(child, lb)
            node = child
            n += lb
        if self.max_pages and self.page_count > self.max_pages:
            self.reclaim(self.page_count - self.max_pages)
        return frozen

    def _split(self, node: _Node, at: int):
        """Split ``node``'s edge at page-aligned offset ``at``: the tail
        (tokens, pages, children) moves under a new child node."""
        bs = self.block_size
        tail = _Node(tokens=node.tokens[at:].copy(),
                     blocks=node.blocks[at // bs:],
                     children=node.children,
                     tick=node.tick, ts=node.ts)
        node.tokens = node.tokens[:at].copy()
        node.blocks = node.blocks[: at // bs]
        node.children = {_key(tail.tokens[:bs]): tail}
        self.node_count += 1
        self.nodes_total += 1

    # -- decay / reclaim ------------------------------------------------------
    def _evictable_leaves(self) -> list[tuple[int, _Node, _Node, bytes]]:
        """(tick, node, parent, key) for every leaf whose pages only the
        tree holds — the refcount-0 (stream-wise) candidates, LRU first."""
        out = []
        for root in self._roots.values():
            stack = [(root, None, b"")]
            while stack:
                node, parent, key = stack.pop()
                if node.children:
                    for k, c in node.children.items():
                        stack.append((c, node, k))
                    continue
                if parent is None:
                    continue  # an empty root sentinel
                if all(self._mgr.refcount(b) == 1 for b in node.blocks):
                    out.append((node.tick, node, parent, key))
        out.sort(key=lambda t: t[0])
        return out

    def _evict(self, node: _Node, parent: _Node, key: bytes) -> int:
        freed = 0
        for b in node.blocks:
            if self._mgr.decref(b):
                freed += 1
        del parent.children[key]
        self.node_count -= 1
        self.page_count -= len(node.blocks)
        self.evictions += 1
        return freed

    def reclaim(self, need_blocks: int,
                protect: set[int] | frozenset[int] = frozenset()) -> int:
        """Free LRU, leaf-first tree-only pages until ``need_blocks`` came
        back to the pool (or no candidate remains).  ``protect`` pins pages
        a caller has matched but not yet adopted — reclaiming the path it
        is about to share would hand its pages to another writer."""
        freed = 0
        while freed < need_blocks:
            cands = [(t, n, p, k) for t, n, p, k in self._evictable_leaves()
                     if not protect or not (protect & set(n.blocks))]
            if not cands:
                break
            _, node, parent, key = cands[0]
            freed += self._evict(node, parent, key)
        return freed

    def reclaimable(self) -> int:
        """Pages the tree could free right now (refcount-1, any depth once
        leaves cascade) — the scheduler adds this to ``free_blocks`` before
        shedding, so a pool full of decayed prefixes never 429s."""
        total = 0
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                total += sum(1 for b in node.blocks
                             if self._mgr.refcount(b) == 1)
        return total

    def decay(self, ttl_s: float) -> int:
        """Evict leaves idle longer than ``ttl_s`` (cascading: a parent
        whose children all decayed becomes a leaf next call).  Returns
        pages freed."""
        if ttl_s <= 0:
            return 0
        now = self._clock()
        freed = 0
        changed = True
        while changed:
            changed = False
            for _, node, parent, key in self._evictable_leaves():
                if now - node.ts > ttl_s:
                    freed += self._evict(node, parent, key)
                    changed = True
        return freed

    def invalidate(self, aidx: int) -> int:
        """Drop EVERY node under an adapter slot (detach/slot-reuse: a new
        tenant on this index must never resolve the old tenant's KV).
        Stream-shared pages just lose the tree's ref and free when their
        stream does.  Returns nodes dropped."""
        root = self._roots.pop(int(aidx), None)
        if root is None:
            return 0
        dropped = 0
        stack = list(root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            for b in node.blocks:
                self._mgr.decref(b)
            self.node_count -= 1
            self.page_count -= len(node.blocks)
            self.evictions += 1
            dropped += 1
        return dropped

    # -- introspection --------------------------------------------------------
    def snapshot(self) -> dict:
        looked = self.hits + self.misses
        return {
            "nodes": self.node_count,
            "pages": self.page_count,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / looked, 4) if looked else 0.0,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "nodes_total": self.nodes_total,
            "pages_total": self.pages_total,
            "reclaimable_pages": self.reclaimable(),
            "adapters": sorted(self._roots),
            "cached_tokens": self.cached_tokens.snapshot(),
        }
