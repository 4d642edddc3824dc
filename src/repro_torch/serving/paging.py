"""Paged KV-cache bookkeeping: BlockAllocator + per-sequence PageTable.

Page-table layout
-----------------
The device-side KV cache is a *pool* of fixed-size pages, one pool per
attention layer (stacked over superblocks, so each pool leaf is
``(n_sb, num_pages, KV, page_size, hd)``).  A sequence does not own a
contiguous ``max_len`` stripe of the cache; instead it owns an ordered list
of physical page ids — its *page table* — and logical token position ``t``
lives at ``(page_table[t // page_size], t % page_size)``.

  physical pool (per layer)          page tables (host, this module)
  ┌────┬────┬────┬────┬────┐         seq A: [3, 1]      (len 21, ps=16)
  │ p0 │ p1 │ p2 │ p3 │ p4 │  ...    seq B: [4]         (len  7)
  └────┴────┴────┴────┴────┘         free list: [2, ...]

Page 0 is reserved as the *null page*: it is never handed out, block-table
rows are padded with 0, and dead decode slots scatter their garbage writes
into it — so every index the kernels see is a valid physical page.

The allocator is pure host-side bookkeeping (device tensors never move when
pages change hands). Ref-counting lets hedged / retried copies of a request
share their common prefix pages: ``fork()`` bumps the ref-count of every
full page and only the last, partially-filled page must be copied
(copy-on-write, performed by the engine on device). ``free()`` decrements
and returns a page to the free list only when its count reaches zero.

All structures are deterministic (freed pages return to a FIFO free list)
so preemption/resume tests can assert exact page reuse.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List

import numpy as np

NULL_PAGE = 0


def bucket_tokens(n: int, unit: int, cap: int) -> int:
    """Length bucket for a context of ``n`` tokens: the smallest
    power-of-two multiple of ``unit`` (the page size) holding ``n``, capped
    at ``cap`` (``max_seq_len``). Right-padding every prefill to its bucket
    bounds the number of distinct prefill shapes — hence XLA compilations —
    at ``num_buckets(unit, cap)`` regardless of the traffic's length mix."""
    m = -(-max(1, n) // unit)           # pages needed, >= 1
    b = 1
    while b < m:
        b *= 2
    return max(n, min(b * unit, cap))


def bucket_lengths(unit: int, cap: int) -> List[int]:
    """Every distinct bucket length ``bucket_tokens`` can produce, ascending
    (the shapes ``prewarm`` must compile): power-of-two multiples of ``unit``
    capped at ``cap``."""
    out, b = [], unit
    while True:
        out.append(min(b, cap))
        if b >= cap:
            break
        b *= 2
    return out


def num_buckets(unit: int, cap: int) -> int:
    """How many distinct bucket lengths exist: ceil(log2(cap/unit)) + 1."""
    return len(bucket_lengths(unit, cap))


class OutOfPages(Exception):
    """Raised when an allocation cannot be satisfied from the free list."""


class BlockAllocator:
    """Fixed-size page allocator with ref-counting over ``num_pages`` pages.

    Page 0 (``NULL_PAGE``) is reserved and never allocated.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: Deque[int] = deque(range(1, num_pages))
        self._refs: Dict[int, int] = {}

    # -- capacity ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._refs)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    # -- alloc / free / share ---------------------------------------------
    def alloc(self, n: int = 1) -> List[int]:
        """Hand out ``n`` pages (ref-count 1 each) or raise OutOfPages —
        all-or-nothing, so a failed admission never leaks pages."""
        if not self.can_alloc(n):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, page: int) -> int:
        """Bump the ref-count of an allocated page (prefix sharing)."""
        if page not in self._refs:
            raise ValueError(f"page {page} is not allocated")
        self._refs[page] += 1
        return self._refs[page]

    def ref_count(self, page: int) -> int:
        return self._refs.get(page, 0)

    def free(self, pages: List[int]) -> int:
        """Drop one reference per page; pages return to the free list only
        when the last reference dies. Returns how many pages actually came
        back to the free list (shared pages survive their co-holders), so
        the prefix cache's eviction can report *reclaimed* capacity rather
        than references dropped."""
        freed = 0
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
                freed += 1
        return freed

    def check_invariants(self) -> None:
        """free + used = num_pages - 1 (null page); no page in both sets."""
        free = set(self._free)
        used = set(self._refs)
        assert NULL_PAGE not in free and NULL_PAGE not in used
        assert not (free & used), free & used
        assert len(free) + len(used) == self.num_pages - 1
        assert all(c > 0 for c in self._refs.values())


@dataclass
class PageTable:
    """Ordered physical pages backing one sequence's logical token stream."""

    page_size: int
    pages: List[int] = field(default_factory=list)
    num_tokens: int = 0

    @property
    def capacity_tokens(self) -> int:
        return len(self.pages) * self.page_size

    def page_of(self, t: int) -> int:
        return self.pages[t // self.page_size]

    def offset_of(self, t: int) -> int:
        return t % self.page_size

    @staticmethod
    def pages_needed(tokens: int, page_size: int) -> int:
        return -(-tokens // page_size)  # ceil div

    def append_pages(self, pages: List[int]) -> None:
        self.pages.extend(pages)

    def row(self, width: int) -> List[int]:
        """Block-table row padded with the null page to ``width`` entries."""
        if len(self.pages) > width:
            raise ValueError(f"sequence needs {len(self.pages)} pages, table width {width}")
        return self.pages + [NULL_PAGE] * (width - len(self.pages))

    def trim(self, keep: int, allocator: BlockAllocator) -> int:
        """Speculative-decode rollback: drop every page past the first
        ``keep``, returning how many came back to the free list. The caller
        guarantees the tail was appended for the current speculation attempt
        (freshly allocated, ref-count 1, exclusively owned) — prefix-cache
        and CoW-fork shared pages always sit at the FRONT of the table
        (matched prefixes are full leading pages; ``fork`` re-allocates the
        trailing partial page), so a trim that never cuts below the
        pre-speculation page count can never free a page another holder
        still reads."""
        if keep >= len(self.pages):
            return 0
        freed = allocator.free(self.pages[keep:])
        self.pages = self.pages[:keep]
        return freed

    def fork(self, allocator: BlockAllocator) -> "PageTable":
        """Share this table's pages with a new sequence (hedged/retried
        copy). Full pages are shared (ref-count++); the trailing partial
        page — which the original will keep appending into — is re-allocated
        fresh for the fork, and the engine must copy its contents on device
        (copy-on-write). Raises OutOfPages if the CoW page can't be had."""
        n_full = self.num_tokens // self.page_size
        shared = self.pages[:n_full]
        for p in shared:
            allocator.share(p)
        new_pages = list(shared)
        if n_full < len(self.pages):  # trailing partial page -> CoW
            try:
                new_pages.extend(allocator.alloc(len(self.pages) - n_full))
            except OutOfPages:
                for p in shared:
                    allocator.free([p])
                raise
        return PageTable(self.page_size, new_pages, self.num_tokens)

    def release(self, allocator: BlockAllocator) -> None:
        allocator.free(self.pages)
        self.pages = []
        self.num_tokens = 0


class ChainedTables:
    """Two-level ("chained") block tables for long-context sequences.

    A flat block table is a device array of shape ``(max_slots, W)`` where
    ``W`` must cover the longest admissible sequence — at long context the
    per-slot row (and the scalar-prefetch footprint the decode kernel pays
    for it) grows linearly with ``max_seq_len``. Chaining splits the map in
    two: each slot's first-level row (``l1``, width ``ceil(W / tpp)``) holds
    *table-page* ids — rows of the shared second-level pool ``l2`` of shape
    ``(n_rows, tpp)`` — and logical block ``i`` resolves to
    ``l2[l1[slot, i // tpp], i % tpp]``. Table pages are allocated on demand
    from a FIFO free list (mirroring ``BlockAllocator``), so a short
    sequence in a long-context engine consumes first-level entries only.

    Row 0 of ``l2`` is reserved as the all-null table page (the indirection
    twin of ``NULL_PAGE``): unused l1 entries point at it and resolve to the
    null data page, so every two-step lookup the kernels perform lands on a
    valid physical page.

    ``n_rows`` is worst-case sized by the caller (every slot holding a
    full-width row) so ``set_row`` can never fail — table-page exhaustion
    would otherwise be a second admission failure mode interleaved with data
    -page exhaustion, and the engine's all-or-nothing admission contract is
    easier to keep when only data pages can run out.
    """

    def __init__(self, max_slots: int, width1: int, tpp: int):
        if tpp < 1 or width1 < 1:
            raise ValueError("width1 and tpp must be >= 1")
        self.tpp = tpp
        self.width1 = width1
        n_rows = 1 + max_slots * width1
        self.l1 = np.zeros((max_slots, width1), np.int32)       # 0 -> null row
        self.l2 = np.full((n_rows, tpp), NULL_PAGE, np.int32)
        self._free: Deque[int] = deque(range(1, n_rows))
        self._owned: List[List[int]] = [[] for _ in range(max_slots)]

    @property
    def free_rows(self) -> int:
        return len(self._free)

    def set_row(self, slot: int, pages: List[int]) -> None:
        """Point ``slot`` at ``pages`` (a flat physical-page row, null-padded
        or not): allocates the table pages the row needs, writes them, and
        returns the slot's previous table pages to the free list. Called at
        every host point where a flat engine would rewrite its block-table
        row, so the device view is always whole-row consistent."""
        if len(pages) > self.width1 * self.tpp:
            raise ValueError(
                f"row of {len(pages)} pages exceeds chained capacity "
                f"{self.width1 * self.tpp}"
            )
        # Trailing null-page entries need no table page — they resolve
        # through the reserved null row.
        n = len(pages)
        while n > 0 and pages[n - 1] == NULL_PAGE:
            n -= 1
        need = -(-n // self.tpp) if n else 0
        rows = self._owned[slot]
        while len(rows) > need:
            r = rows.pop()
            self.l2[r, :] = NULL_PAGE
            self._free.append(r)
        while len(rows) < need:
            rows.append(self._free.popleft())
        for j, r in enumerate(rows):
            chunk = pages[j * self.tpp:(j + 1) * self.tpp]
            self.l2[r, :len(chunk)] = chunk
            self.l2[r, len(chunk):] = NULL_PAGE
        self.l1[slot, :len(rows)] = rows
        self.l1[slot, len(rows):] = 0

    def clear(self, slot: int) -> None:
        self.set_row(slot, [])

    def flat_row(self, slot: int) -> List[int]:
        """Reconstruct the flat physical row this slot's chain encodes
        (width1 * tpp entries, null-padded) — the oracle the fuzz tests
        compare against the flat table the engine also maintains."""
        out: List[int] = []
        for r in self.l1[slot]:
            out.extend(int(p) for p in self.l2[int(r)])
        return out

    def check_invariants(self, max_slots: int) -> None:
        free = set(self._free)
        owned = [r for rows in self._owned for r in rows]
        assert 0 not in free and 0 not in owned
        assert len(owned) == len(set(owned)), "l2 row owned twice"
        assert not (free & set(owned)), free & set(owned)
        assert len(free) + len(owned) == self.l2.shape[0] - 1
        assert (self.l2[0] == NULL_PAGE).all(), "null table row corrupted"
        for s in range(max_slots):
            rows = self._owned[s]
            assert list(self.l1[s, :len(rows)]) == rows
            assert (self.l1[s, len(rows):] == 0).all()
        for r in free:
            assert (self.l2[r] == NULL_PAGE).all(), f"free row {r} not nulled"
