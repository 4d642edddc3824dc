"""Cross-request prefix cache: a hash-per-page radix tree over the paged pool.

At production scale most traffic shares prefixes — system prompts, few-shot
templates, multi-turn chat history — so most prefill work recomputes K/V
another request already produced. This module keeps those pages alive after
their sequence finishes and hands them to the next request with the same
token prefix, so prefill for the matched pages is skipped entirely.

Structure
---------
A radix (compressed prefix) tree keyed by *page runs*: every full page of a
token stream becomes one key — the tuple of its ``page_size`` token ids —
and a node holds a run of consecutive page keys plus the physical page ids
backing them, aligned 1:1::

    root ── [sys-prompt p0 p1 p2] ── [few-shot-A p3 p4]
                                  └─ [few-shot-B p5]

Nodes are split at the EXACT divergence point (page granularity): matching
or inserting a stream that shares only part of a node's run splices a fresh
parent holding the common pages above the original node, so matched paths
always end on node boundaries and pinning is exact.

Ownership & ref-counting
------------------------
The tree holds exactly ONE ``BlockAllocator`` reference per cached page, so
the allocator-wide invariant is ``ref_count(page) == live tables holding it
+ (1 if the tree holds it)``:

* ``acquire(tokens)`` bumps each matched page (``allocator.share``) before
  attaching it to the new sequence's ``PageTable`` — the same mechanism
  ``PageTable.fork`` uses for hedged copies — and *pins* the matched path
  (``holders`` +1 on every node from the match point to the root).
* ``insert(tokens, pages)`` CONSUMES the releasing sequence's reference on
  every page passed: pages whose prefix already exists in the tree are
  freed (the tree keeps its own copy), new suffix pages are adopted as-is
  (the sequence's reference becomes the tree's). Release-to-cache is
  therefore a pure ownership transfer — no page is copied or double-held.
* ``evict(n)`` drops cold, unpinned leaves in LRU order (logical-clock
  timestamps, deterministic) until ``n`` pages have actually returned to
  the free list. Pinned paths — prefixes live sequences are decoding from —
  are never evicted, and path-pinning means ``holders == 0`` on a node
  implies its whole subtree is unpinned.

``cached_pages`` / ``evictable_pages`` are maintained incrementally so the
engine's lock-free ``capacity_now()`` can export them without walking the
tree: cached pages are "free-ish" capacity the placer may count as
reclaimable, not occupancy.

Thread-safety: mutations (acquire/insert/evict/pin/release) happen under
the owning engine's lock; the integer stats are safe to read lock-free.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.serving.paging import BlockAllocator

PageKey = Tuple[int, ...]


class PrefixNode:
    """One run of consecutive cached pages; children keyed by the first
    page-key of each child run."""

    __slots__ = ("keys", "pages", "children", "parent", "holders", "last_used")

    def __init__(
        self,
        keys: List[PageKey],
        pages: List[int],
        parent: Optional["PrefixNode"],
        holders: int = 0,
        last_used: int = 0,
    ):
        self.keys = keys
        self.pages = pages
        self.children: Dict[PageKey, "PrefixNode"] = {}
        self.parent = parent
        self.holders = holders
        self.last_used = last_used


class PrefixCache:
    """Radix-tree prefix index over a ``BlockAllocator`` page pool."""

    def __init__(self, allocator: BlockAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self._root = PrefixNode([], [], None)
        self._tick = 0                  # logical LRU clock (deterministic)
        # incremental counters (lock-free reads from capacity_now)
        self.cached_pages = 0           # pages the tree holds a reference to
        self._evictable = 0             # pages in unpinned (holders==0) nodes
        # stats
        self.queries = 0
        self.hits = 0
        self.matched_tokens_total = 0   # tokens served from cache, cumulative
        self.inserted_pages_total = 0
        self.evictions = 0              # leaf nodes dropped
        self.evicted_pages_total = 0

    # -- stats -----------------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        """Fraction of prefix lookups that matched >= 1 page."""
        return self.hits / self.queries if self.queries else 0.0

    def evictable_pages(self) -> int:
        """Pages reclaimable by eviction right now: every page in a node no
        live sequence is pinned to (path-pinning makes holders==0 imply the
        whole subtree is unpinned, so these really can all be dropped)."""
        return self._evictable

    # -- internals -------------------------------------------------------------
    def _page_keys(self, tokens: List[int], n_pages: int) -> List[PageKey]:
        ps = self.page_size
        return [tuple(tokens[i * ps : (i + 1) * ps]) for i in range(n_pages)]

    def _touch(self, node: PrefixNode) -> None:
        """Refresh LRU stamps from ``node`` up to the root."""
        self._tick += 1
        while node is not self._root:
            node.last_used = self._tick
            node = node.parent

    def _split(self, node: PrefixNode, k: int) -> PrefixNode:
        """Split ``node`` at key index ``k`` (0 < k < len): a fresh parent
        takes the first ``k`` (key, page) pairs, ``node`` keeps the rest.
        The ORIGINAL object stays the deeper part so sequences holding a
        reference to it still unpin their full path through the new parent.
        Returns the new parent (the exact divergence point)."""
        upper = PrefixNode(
            node.keys[:k], node.pages[:k], node.parent,
            holders=node.holders, last_used=node.last_used,
        )
        node.parent.children[upper.keys[0]] = upper
        node.keys = node.keys[k:]
        node.pages = node.pages[k:]
        node.parent = upper
        upper.children[node.keys[0]] = node
        return upper

    def _walk(self, keys: List[PageKey], split: bool) -> Tuple[PrefixNode, int]:
        """Descend from the root matching ``keys``; returns (deepest fully
        matched node, number of keys matched). With ``split`` a mid-node
        divergence splits the node so the match ends on a node boundary."""
        node, i = self._root, 0
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                break
            j, limit = 0, min(len(child.keys), len(keys) - i)
            while j < limit and child.keys[j] == keys[i + j]:
                j += 1
            if j == 0:
                break
            if j < len(child.keys):
                if split:
                    node = self._split(child, j)
                    i += j
                break
            node, i = child, i + j
        return node, i

    def _pin(self, node: PrefixNode, delta: int) -> None:
        """Adjust ``holders`` by +-1 along the path to the root, keeping the
        evictable-page counter exact across 0 <-> 1 transitions."""
        while node is not self._root:
            before = node.holders
            node.holders = before + delta
            assert node.holders >= 0, "prefix-cache pin/release imbalance"
            if before == 0 and delta > 0:
                self._evictable -= len(node.pages)
            elif node.holders == 0 and delta < 0:
                self._evictable += len(node.pages)
            node = node.parent

    # -- match / attach --------------------------------------------------------
    def acquire(self, tokens: List[int]) -> Tuple[List[int], Optional[PrefixNode], int]:
        """Match ``tokens`` against the tree and attach the longest cached
        prefix: returns ``(pages, node, matched_tokens)``. Matched pages get
        one extra allocator reference each (the caller owns it — put them at
        the front of the sequence's ``PageTable``) and the matched path is
        pinned until ``release(node)``. The match is capped one token short
        of the full context so at least one token is always left to prefill
        (something must produce the next-token logits). A miss returns
        ``([], None, 0)`` and pins nothing."""
        n_full = max(0, (len(tokens) - 1) // self.page_size)
        self.queries += 1
        if n_full == 0:
            return [], None, 0
        node, matched = self._walk(self._page_keys(tokens, n_full), split=True)
        if matched == 0:
            return [], None, 0
        pages: List[int] = []
        n = node
        while n is not self._root:
            pages[:0] = n.pages
            n = n.parent
        assert len(pages) == matched
        for p in pages:
            self.allocator.share(p)
        self._pin(node, +1)
        self._touch(node)
        self.hits += 1
        self.matched_tokens_total += matched * self.page_size
        return pages, node, matched * self.page_size

    def pin(self, node: PrefixNode) -> PrefixNode:
        """Add one holder along ``node``'s path — a forked sequence sharing
        cache-attached pages must hold the tree path like its source does,
        so the source finishing does not make the path evictable under the
        still-running clone."""
        self._pin(node, +1)
        return node

    def release(self, node: PrefixNode) -> None:
        """Drop one holder along ``node``'s path (sequence finished or was
        preempted). Page references are NOT touched here — the sequence's
        ``PageTable`` release/insert handles those."""
        self._pin(node, -1)

    def cancel(self, pages: List[int], node: Optional[PrefixNode]) -> None:
        """Undo an ``acquire`` whose admission failed (the remaining pages
        could not be allocated): drop the shares and the pin."""
        if node is None:
            return
        for p in pages:
            self.allocator.free([p])
        self.release(node)

    # -- release-to-cache ------------------------------------------------------
    def insert(self, tokens: List[int], pages: List[int]) -> int:
        """Retire a finished sequence's full pages into the tree, consuming
        the caller's allocator reference on every page passed: prefixes the
        tree already holds free the incoming duplicates, new suffix pages
        are adopted (the reference transfers to the tree). ``tokens`` must
        be exactly the tokens whose K/V the pages contain (``len(pages) ==
        len(tokens) // page_size``). Returns the number of pages adopted."""
        n_full = len(tokens) // self.page_size
        if len(pages) != n_full:
            raise ValueError(f"need {n_full} full pages for {len(tokens)} tokens, got {len(pages)}")
        if n_full == 0:
            return 0
        keys = self._page_keys(tokens, n_full)
        node, matched = self._walk(keys, split=True)
        for p in pages[:matched]:           # duplicates: tree keeps its own copy
            self.allocator.free([p])
        adopted = n_full - matched
        if adopted:
            child = PrefixNode(keys[matched:], list(pages[matched:]), node)
            node.children[keys[matched]] = child
            node = child
            self.cached_pages += adopted
            self._evictable += adopted      # new leaves start unpinned
            self.inserted_pages_total += adopted
        self._touch(node)
        return adopted

    # -- eviction --------------------------------------------------------------
    def _evictable_leaves(self) -> List[PrefixNode]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if not n.children and n.holders == 0:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def evict(self, n_pages: int) -> int:
        """Drop cold unpinned leaves (LRU first) until ``n_pages`` pages have
        actually returned to the allocator's free list, or nothing evictable
        remains. Returns the pages freed — the engine calls this BEFORE
        preempting any live sequence, because cached pages are reclaimable
        capacity, not occupancy."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaf = min(leaves, key=lambda n: n.last_used)
            freed += self.allocator.free(leaf.pages)   # last-ref pages only
            self.cached_pages -= len(leaf.pages)
            self._evictable -= len(leaf.pages)
            self.evicted_pages_total += len(leaf.pages)
            self.evictions += 1
            leaf.parent.children.pop(leaf.keys[0])
            leaf.parent = None
        return freed

    def drop(self) -> int:
        """Free every cached page and reset the tree (shutdown / tests).
        Requires no live pins — a pinned path means a sequence still decodes
        from these pages and dropping them would corrupt the accounting."""
        stack, dropped = list(self._root.children.values()), 0
        while stack:
            n = stack.pop()
            assert n.holders == 0, "drop() with live sequences attached to the cache"
            self.allocator.free(n.pages)
            dropped += len(n.pages)
            stack.extend(n.children.values())
        self._root.children.clear()
        self.cached_pages = 0
        self._evictable = 0
        return dropped

    # -- introspection ---------------------------------------------------------
    def pages(self) -> List[int]:
        """Every page the tree currently holds a reference to (tests)."""
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            out.extend(n.pages)
            stack.extend(n.children.values())
        return out

    def nodes(self) -> List[PrefixNode]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def stats(self) -> dict:
        return {
            "cached_pages": self.cached_pages,
            "evictable_pages": self._evictable,
            "queries": self.queries,
            "hits": self.hits,
            "hit_rate": self.hit_rate,
            "matched_tokens_total": self.matched_tokens_total,
            "inserted_pages_total": self.inserted_pages_total,
            "evictions": self.evictions,
            "evicted_pages_total": self.evicted_pages_total,
        }

    def check_invariants(self) -> None:
        """Structural + accounting invariants (tests call after every op):
        key/page alignment, child keying, parent links, page uniqueness,
        every cached page allocated, incremental counters exact."""
        seen: set = set()
        total = evictable = 0
        stack = [(self._root, True)]
        while stack:
            n, unpinned_path = stack.pop()
            if n is not self._root:
                assert n.keys and len(n.keys) == len(n.pages), "empty or misaligned node"
                assert all(len(k) == self.page_size for k in n.keys)
                assert n.holders >= 0
                # path-pinning: a pinned descendant pins every ancestor
                assert not (n.holders > 0 and unpinned_path is False) or True
                total += len(n.pages)
                if n.holders == 0:
                    evictable += len(n.pages)
                for p in n.pages:
                    assert p not in seen, f"page {p} cached twice"
                    seen.add(p)
                    assert self.allocator.ref_count(p) >= 1, f"cached page {p} not allocated"
            for key, child in n.children.items():
                assert child.keys[0] == key, "child keyed by wrong first page"
                assert child.parent is n, "broken parent link"
                if n is not self._root and n.holders == 0:
                    assert child.holders == 0, "pinned child under unpinned parent"
                stack.append((child, n.holders == 0))
        assert total == self.cached_pages, (total, self.cached_pages)
        assert evictable == self._evictable, (evictable, self._evictable)
