"""Block-paged KV-cache accounting: the memory half of the paged lane.

The port's copy of the JAX package's ``serving/kvcache.py``, with the same
semantics.  The slot pool (``serving/generation.GenerationScheduler``)
reserves a whole ``[total = max_seq + max_new]`` cache row per slot; the
paged pool is ``num_blocks`` fixed-size **blocks** of ``block_size`` token
positions (``[L, num_blocks, block_size, D]`` on the device,
``ops/paged_attention.py``), and each sequence holds a **block table**, the
list of physical blocks behind its logical positions, so a sequence holds
memory in proportion to the tokens it has.

:class:`BlockManager` is the host-side allocator: pure bookkeeping, no
tensors, no clocks, no I/O, owned by the paged scheduler's asyncio task.

- Block 0 is the **trash block**: never allocated, every table row is
  padded with it, and retired pool rows write their frozen position into
  it; no live mask reads it.
- Allocation is all-or-nothing per request; the manager never blocks and
  never raises on exhaustion: the caller decides (queue, evict the newest
  sequence, or shed 429 with the expected block-release horizon).
- Blocks are **refcounted**: the prefix cache (``serving/prefixcache.py``)
  freezes a prompt's whole pages into a radix tree and ``adopt``s them into
  later tables, so one page may back many tables.  A block frees when its
  last holder drops it; ``cow`` gives a writer a private replacement for a
  shared page (the caller runs the device copy).  A double free raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# The reserved garbage block (module docstring): tables are padded with it,
# retired rows write into it, nothing ever reads it un-masked.
TRASH_BLOCK = 0


class KVPoolExhausted(OverflowError):
    """Raised by the scheduler's admission gate when a request's prompt
    cannot get blocks and the backlog already covers the pool.

    Carries the expected block-release horizon so the serving layer can
    shed with ``429 + Retry-After`` computed from when blocks actually free
    (a decode finishing, not a guess) instead of a bare constant.
    """

    def __init__(self, msg: str, retry_after_s: float, free_blocks: int,
                 needed_blocks: int):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.free_blocks = int(free_blocks)
        self.needed_blocks = int(needed_blocks)


@dataclass
class _Seq:
    blocks: list[int] = field(default_factory=list)
    tokens: int = 0  # logical positions covered (for utilization accounting)


class BlockManager:
    """Free-list allocator over a ``num_blocks`` pool of ``block_size`` slots.

    ``max_blocks`` is the per-sequence table width (ceil(total / block_size)
    for the model's max sequence): :meth:`table_row` pads every table to it
    so the device-side block tables stay one static shape.
    """

    def __init__(self, num_blocks: int, block_size: int, max_blocks: int):
        if block_size < 1 or num_blocks < 2:
            raise ValueError("need block_size >= 1 and num_blocks >= 2 "
                             "(block 0 is reserved as the trash block)")
        if max_blocks > num_blocks - 1:
            raise ValueError(
                f"a full sequence needs {max_blocks} blocks but the pool "
                f"only has {num_blocks - 1} allocatable; raise kv_num_blocks "
                f"or shrink seq_buckets/max_new_tokens")
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_blocks = int(max_blocks)
        # LIFO free stack (low indices first out, reads nicer in tests);
        # block 0 excluded — it is the shared trash block.
        self._free = list(range(num_blocks - 1, 0, -1))  # guarded-by: event-loop
        self._seqs: dict[object, _Seq] = {}  # guarded-by: event-loop
        # Refcounts for every allocated block (absent = free).  A block may
        # be held by N sequences' tables plus the prefix tree at once; it
        # frees only when the count hits zero.
        self._ref: dict[int, int] = {}  # guarded-by: event-loop
        self.evictions = 0    # guarded-by: event-loop
        self.high_water = 0   # guarded-by: event-loop (peak blocks in use)

    # -- sizing ---------------------------------------------------------------
    def blocks_for(self, ntokens: int) -> int:
        return max((int(ntokens) + self.block_size - 1) // self.block_size, 1)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def can_alloc(self, ntokens: int) -> bool:
        return self.blocks_for(ntokens) <= len(self._free)

    # -- refcounting -----------------------------------------
    def _take(self) -> int:
        """Pop one free block at refcount 1 (internal: callers size-check)."""
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def refcount(self, block: int) -> int:
        """Holders of ``block`` (0 = free).  The prefix tree counts as one."""
        return self._ref.get(int(block), 0)

    def incref(self, block: int) -> None:
        """Add a holder to an ALLOCATED block; increffing a free block is a
        refcount bug and raises."""
        b = int(block)
        if b not in self._ref:
            raise ValueError(f"incref of unallocated block {b}")
        self._ref[b] += 1

    def decref(self, block: int) -> bool:
        """Drop one holder; True when that released the block to the free
        list.  Decreffing a free block (double free) raises."""
        b = int(block)
        r = self._ref.get(b)
        if r is None:
            raise ValueError(f"double free of block {b}")
        if r <= 1:
            del self._ref[b]
            self._free.append(b)
            return True
        self._ref[b] = r - 1
        return False

    def shared_blocks(self) -> int:
        """Blocks currently held by more than one holder."""
        return sum(1 for r in self._ref.values() if r > 1)

    # -- allocation -----------------------------------------------------------
    def alloc(self, seq: object, ntokens: int) -> bool:
        """Give ``seq`` blocks covering ``ntokens`` positions; all-or-nothing.

        False (and no state change) when the pool can't cover it.  ``seq``
        is any hashable identity — the scheduler uses the request object.
        """
        if seq in self._seqs:
            raise ValueError("sequence already holds blocks; use extend()")
        need = self.blocks_for(ntokens)
        if need > len(self._free) or need > self.max_blocks:
            return False
        self._seqs[seq] = _Seq([self._take() for _ in range(need)],
                               int(ntokens))
        self.high_water = max(self.high_water, self.used_blocks)
        return True

    def adopt(self, seq: object, shared: list[int], ntokens: int) -> bool:
        """Register ``seq`` holding ``shared`` (already-allocated) blocks —
        a prefix-cache hit's matched pages — increffing each.  The caller
        then :meth:`extend`s for the uncached tail.  All-or-nothing on the
        ``max_blocks`` cap; sharing itself cannot exhaust the pool."""
        if seq in self._seqs:
            raise ValueError("sequence already holds blocks; use extend()")
        if len(shared) > self.max_blocks:
            return False
        for b in shared:
            self.incref(b)
        self._seqs[seq] = _Seq(list(shared), int(ntokens))
        return True

    def cow(self, seq: object, index: int) -> tuple[int, int] | None:
        """Copy-on-write: replace ``seq``'s block at ``index`` with a fresh
        private block, returning ``(src, dst)`` — or None when the pool has
        no free block (the caller reclaims/evicts and retries).

        The SOURCE's refcount is left untouched: the caller must device-copy
        page ``src`` into ``dst`` before any read of the new page, and only
        then ``decref(src)`` — dropping it earlier would let an LRU decay
        free (and re-issue) the page before the copy reads it."""
        s = self._seqs[seq]
        if not self._free:
            return None
        src = s.blocks[index]
        dst = self._take()
        s.blocks[index] = dst
        self.high_water = max(self.high_water, self.used_blocks)
        return src, dst

    def extend(self, seq: object, ntokens: int) -> bool:
        """Grow ``seq``'s table to cover ``ntokens`` positions (no-op when it
        already does); all-or-nothing like :meth:`alloc`."""
        s = self._seqs[seq]
        need = self.blocks_for(ntokens)
        grow = need - len(s.blocks)
        if grow > 0:
            if grow > len(self._free) or need > self.max_blocks:
                return False
            s.blocks.extend(self._take() for _ in range(grow))
            self.high_water = max(self.high_water, self.used_blocks)
        s.tokens = max(s.tokens, int(ntokens))
        return True

    def free(self, seq: object) -> int:
        """Drop ``seq``'s hold on its blocks; returns how many RELEASED to
        the free list (shared pages just decrement and stay allocated)."""
        s = self._seqs.pop(seq, None)
        if s is None:
            return 0
        return sum(1 for b in s.blocks if self.decref(b))

    def blocks_of(self, seq: object) -> list[int]:
        """A copy of ``seq``'s current block list (prefix-freeze input)."""
        return list(self._seqs[seq].blocks)

    def holds(self, seq: object) -> bool:
        return seq in self._seqs

    def covered(self, seq: object) -> int:
        """Positions the sequence's current blocks can hold."""
        return len(self._seqs[seq].blocks) * self.block_size

    def note_tokens(self, seq: object, ntokens: int) -> None:
        """Update the logical token count (utilization accounting only)."""
        s = self._seqs.get(seq)
        if s is not None:
            s.tokens = max(s.tokens, int(ntokens))

    def table_row(self, seq: object | None) -> list[int]:
        """The device block table row: owned blocks, TRASH-padded to
        ``max_blocks``.  ``None`` (an empty/retired pool row) is all trash."""
        blocks = self._seqs[seq].blocks if seq is not None else []
        return blocks + [TRASH_BLOCK] * (self.max_blocks - len(blocks))

    # -- accounting -----------------------------------------------------------
    def utilization(self) -> float:
        """Logical tokens held / positions allocated (1.0 = zero internal
        fragmentation; the slot pool's equivalent figure is
        tokens / (slots * total), typically far lower).

        Shared pages count ONCE: per-block coverage is the max any holder
        reaches, and blocks held only by an external ref (a frozen prefix
        node, which is full by construction — only whole-prompt blocks
        freeze) count as fully covered.  Summing per-sequence tokens would
        double-count every prefix hit and report >1.0 utilization."""
        used = self.used_blocks * self.block_size
        if not used:
            return 1.0
        cover: dict[int, int] = {}
        for s in self._seqs.values():
            for i, b in enumerate(s.blocks):
                c = min(self.block_size, max(s.tokens - i * self.block_size, 0))
                if c > cover.get(b, 0):
                    cover[b] = c
        for b in self._ref:
            if b not in cover:
                cover[b] = self.block_size  # prefix-tree-only: frozen full
        return min(sum(cover.values()) / used, 1.0)

    def snapshot(self) -> dict:
        used = self.used_blocks
        return {
            "block_size": self.block_size,
            "blocks_total": self.num_blocks - 1,  # allocatable (sans trash)
            "blocks_used": used,
            "blocks_free": len(self._free),
            "sequences": len(self._seqs),
            "shared_blocks": self.shared_blocks(),
            "utilization": round(self.utilization(), 4),
            "fragmentation": round(1.0 - self.utilization(), 4),
            "high_water_blocks": self.high_water,
            "evictions": self.evictions,
        }
