"""Host-side bookkeeping for the paged KV cache: a copy of the
framework-free ``repro/serve/paged.py`` (the port imports nothing of the
JAX package).

Two pieces, both pure Python and numpy: a reference-counted ``PagePool``
over a fixed set of physical KV pages, and a path-compressed
``RadixTree`` of previously served prompts whose nodes pin the pages
covering their prefix.  The serve engine maps a new request's shared
prefix straight out of the tree (bumping refcounts), prefills only the
unshared suffix, and copy-on-writes the boundary page when the suffix
starts mid-page.

Conventions shared with the device side (``models/attention.py`` and
``kernels/paged_attention.py``):

- physical pages are indexed ``0 .. num_pages-1``; the *device* pool
  has one extra trailing page (index ``num_pages``) reserved as the
  TRASH page — never allocated here, used as the scatter target for
  masked/inactive rows so writes are race-free without predication.
- a page holds ``page_size`` consecutive token positions; a slot's
  page table maps logical page ``i`` (positions ``[i*ps, (i+1)*ps)``)
  to a physical page.
"""
from __future__ import annotations

from collections import Counter

import numpy as np


def pages_for(tokens: int, page_size: int) -> int:
    """Number of pages covering positions ``[0, tokens)``."""
    if tokens <= 0:
        return 0
    return -(-int(tokens) // int(page_size))


class PagePoolExhausted(RuntimeError):
    """``alloc`` could not satisfy a request; carries the shortfall.

    The engine converts this into a shed-or-defer decision at admission
    (never head-of-line blocking).
    """

    def __init__(self, requested: int, free: int, num_pages: int):
        self.requested = int(requested)
        self.free = int(free)
        self.num_pages = int(num_pages)
        super().__init__(
            f"page pool exhausted: requested {requested} pages, "
            f"{free} free of {num_pages}")


class PagePool:
    """Reference-counted allocator over ``num_pages`` physical pages.

    Invariants (checked by ``check()``):
    every page is either on the free list with refcount 0 or allocated
    with refcount >= 1; ``alloc`` never hands out a live page; a page
    returns to the free list exactly when its refcount hits 0.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.refcount = np.zeros(self.num_pages, np.int64)
        # pop() hands out ascending page ids (cosmetic, aids debugging)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self.hwm = 0            # pages-in-use high-water mark
        self.cow_copies = 0     # bumped by the engine per CoW copy

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Claim ``n`` free pages (refcount 1 each).

        Raises ``PagePoolExhausted`` (with requested/free counts) when
        short — callers that can defer catch it; nothing downstream has
        to special-case a bare ``None``.
        """
        if n < 0:
            raise ValueError("cannot allocate a negative page count")
        if len(self._free) < n:
            raise PagePoolExhausted(n, len(self._free), self.num_pages)
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            if self.refcount[p] != 0:
                raise AssertionError(f"free list held live page {p}")
            self.refcount[p] = 1
        self.hwm = max(self.hwm, self.in_use)
        return pages

    def share(self, page: int) -> None:
        """Add a reference to an already-live page."""
        if self.refcount[page] <= 0:
            raise ValueError(f"share() on dead page {page}")
        self.refcount[page] += 1

    def release(self, page: int) -> None:
        """Drop one reference; the page frees when the count hits 0."""
        if self.refcount[page] <= 0:
            raise ValueError(f"release() on dead page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(int(page))

    def check(self, external_refs: Counter | None = None) -> None:
        """Assert pool invariants; with ``external_refs`` (page -> count
        held by slots + radix nodes) also assert exact conservation."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate page on the free list")
        for p in range(self.num_pages):
            rc = int(self.refcount[p])
            if rc < 0:
                raise AssertionError(f"negative refcount on page {p}")
            if (rc == 0) != (p in free):
                raise AssertionError(
                    f"page {p}: refcount {rc} vs free-list {p in free}")
        if external_refs is not None:
            for p in range(self.num_pages):
                if int(self.refcount[p]) != external_refs.get(p, 0):
                    raise AssertionError(
                        f"page {p}: refcount {int(self.refcount[p])} != "
                        f"{external_refs.get(p, 0)} external refs")


class _Node:
    __slots__ = ("edge", "children", "pages", "depth", "last_used")

    def __init__(self, edge, depth, pages):
        self.edge = tuple(edge)         # tokens from parent to here
        self.children = {}              # first edge token -> _Node
        self.pages = tuple(pages)       # pages covering positions [0, depth)
        self.depth = int(depth)
        self.last_used = 0


def _lcp(a, b) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixTree:
    """Path-compressed trie of served prompts pinning their KV pages.

    Each node holds one pool reference per page in its own ``pages``
    tuple (symmetric register/release — refcounts are inflated along a
    root-to-leaf chain but exactly conserved, which ``PagePool.check``
    verifies against ``held_refs``).  ``match`` walks greedily, including
    partway down an edge; a partial match returns the child's pages
    truncated to the matched coverage — the boundary page may contain
    the *original* branch's tokens past the match point, which is safe
    because the engine CoWs mid-page boundaries and attention masks
    every position past a row's own depth.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._root = _Node((), 0, ())
        self._clock = 0

    # -- internals -----------------------------------------------------------

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    def _register(self, node: _Node) -> None:
        for p in node.pages:
            self.pool.share(p)

    def _nodes(self):
        stack = [self._root]
        while stack:
            n = stack.pop()
            if n is not self._root:
                yield n
            stack.extend(n.children.values())

    # -- queries -------------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return sum(1 for _ in self._nodes())

    def held_refs(self) -> Counter:
        """page -> number of references held by tree nodes."""
        c = Counter()
        for n in self._nodes():
            c.update(n.pages)
        return c

    def match(self, tokens) -> tuple[int, list[int]]:
        """Longest stored prefix of ``tokens``: (matched_len, pages).

        ``pages`` covers positions ``[0, matched_len)`` (caller bumps
        refcounts when it maps them).  Touches every node on the path
        for LRU.
        """
        tokens = tuple(tokens)
        cur, depth = self._root, 0
        pages: tuple = ()
        while depth < len(tokens):
            child = cur.children.get(tokens[depth])
            if child is None:
                break
            common = _lcp(child.edge, tokens[depth:])
            if common == 0:
                break
            depth += common
            self._touch(child)
            pages = child.pages
            if common < len(child.edge):
                break
            cur = child
        matched = min(depth, len(tokens))
        return matched, list(pages[:pages_for(matched, self.pool.page_size)])

    # -- updates -------------------------------------------------------------

    def insert(self, tokens, pages) -> int:
        """Register ``tokens`` whose KV lives in ``pages`` (covering
        ``[0, len(tokens))``).  Returns the number of new nodes; every
        new node takes its own pool reference on each page it covers.
        """
        tokens = tuple(tokens)
        pages = tuple(pages)
        ps = self.pool.page_size
        if len(pages) != pages_for(len(tokens), ps):
            raise ValueError(
                f"insert(): {len(pages)} pages cannot cover "
                f"{len(tokens)} tokens at page_size={ps}")
        cur, depth, created = self._root, 0, 0
        while depth < len(tokens):
            rest = tokens[depth:]
            child = cur.children.get(rest[0])
            if child is None:
                leaf = _Node(rest, len(tokens), pages)
                self._register(leaf)
                self._touch(leaf)
                cur.children[rest[0]] = leaf
                return created + 1
            common = _lcp(child.edge, rest)
            if common == len(child.edge):
                depth += common
                self._touch(child)
                cur = child
                continue
            # split child's edge at the divergence point
            mid = _Node(child.edge[:common], depth + common,
                        child.pages[:pages_for(depth + common, ps)])
            self._register(mid)
            self._touch(mid)
            child.edge = child.edge[common:]
            mid.children[child.edge[0]] = child
            cur.children[mid.edge[0]] = mid
            created += 1
            depth += common
            cur = mid
        return created

    def evict(self, need_free: int) -> int:
        """LRU-evict leaves until the pool has ``need_free`` free pages
        (or nothing is left to evict).  Returns pages actually freed.
        A freed leaf may expose its parent as the next LRU leaf.
        """
        freed = 0
        while self.pool.free_pages < need_free:
            leaf, parent = None, None
            stack = [(self._root, None)]
            while stack:
                n, par = stack.pop()
                if n is not self._root and not n.children:
                    if leaf is None or n.last_used < leaf.last_used:
                        leaf, parent = n, par
                stack.extend((c, n) for c in n.children.values())
            if leaf is None:
                break
            before = self.pool.free_pages
            for p in leaf.pages:
                self.pool.release(p)
            del parent.children[leaf.edge[0]]
            freed += self.pool.free_pages - before
        return freed

    def clear(self) -> None:
        for n in list(self._nodes()):
            for p in n.pages:
                self.pool.release(p)
        self._root = _Node((), 0, ())
