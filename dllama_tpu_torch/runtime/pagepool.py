"""Host-side paged-KV bookkeeping: a refcounted page pool and a radix
prefix tree over it — a copy of ``dllama_tpu/runtime/pagepool.py``
(snapshot export/restore left out).

The device side (ops/attention.py paged section) only sees int32 page
tables; which physical page backs which logical block of which request
lives here, on the scheduler thread:

* :class:`PagePool` — the allocator.  Physical page 0 is pinned as the
  scratch page; pages 1..n-1 carry refcounts so a page can be owned by
  several slots (shared prefix) plus the prefix tree at once, and returns
  to the free list only when the last reference drops.
* :class:`RadixTree` — prefix cache, one node per page-sized token block.
  After a request's prefill completes its full prompt pages are inserted
  (the tree takes its own reference); a later prompt walking the same
  blocks binds those pages copy-free and prefills only its suffix.
  Eviction drops least-recently-used leaves that nothing else references.

Sharing is correct because slot RoPE clocks start at absolute position 0
(a prefix's KV is the same whichever request computed it) and only whole
pages are shared (shared pages are never written after insertion).
"""

from __future__ import annotations


class PagePoolExhausted(RuntimeError):
    """No free pages for an allocation; the caller defers admission."""


class PagePool:
    """Refcounted allocator over ``n_pages`` physical KV pages.

    Page 0 is the scratch page: pinned with one permanent reference,
    never handed out, never freed.  Allocation hands out the lowest
    free page ids first (deterministic tests; locality is irrelevant —
    pages are gathered by id anyway).
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("paged pool needs >= 2 pages (page 0 is scratch)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._refs = [0] * self.n_pages
        self._refs[0] = 1  # scratch, pinned forever
        # stack popping ascending ids: reversed so .pop() yields 1, 2, …
        self._free = list(range(self.n_pages - 1, 0, -1))

    @property
    def capacity(self) -> int:
        """Usable pages (excludes the scratch page)."""
        return self.n_pages - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Allocate ``n`` fresh pages (refcount 1 each) or raise
        :class:`PagePoolExhausted` without allocating any."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free of {self.capacity}")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def incref(self, pages) -> None:
        """Add a reference to already-live pages (prefix sharing)."""
        for p in pages:
            if self._refs[p] <= 0:
                raise RuntimeError(f"incref on dead page {p}")
            self._refs[p] += 1

    def decref(self, pages) -> None:
        """Drop one reference per page; pages reaching zero return to the
        free list."""
        for p in pages:
            if p == 0:
                raise RuntimeError("decref on scratch page 0")
            if self._refs[p] <= 0:
                raise RuntimeError(f"decref on dead page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def claim(self, page: int) -> None:
        """Allocate a *specific* free page id (snapshot restore rebuilding
        the prefix tree's ownership)."""
        if page == 0:
            raise RuntimeError("cannot claim scratch page 0")
        try:
            self._free.remove(page)
        except ValueError:
            raise RuntimeError(f"claim of non-free page {page}") from None
        self._refs[page] = 1

    def check(self) -> None:
        """Invariant audit (tests, fault drills): refcounts non-negative,
        scratch pinned, the free list exactly the zero-ref pages, no
        duplicates."""
        if self._refs[0] < 1:
            raise AssertionError("scratch page 0 lost its pin")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        if 0 in free:
            raise AssertionError("scratch page 0 on the free list")
        for p in range(1, self.n_pages):
            if self._refs[p] < 0:
                raise AssertionError(f"negative refcount on page {p}")
            if (self._refs[p] == 0) != (p in free):
                raise AssertionError(
                    f"page {p}: refs={self._refs[p]} vs free={p in free}")


class _Node:
    __slots__ = ("block", "page", "children", "last_used")

    def __init__(self, block: tuple, page: int):
        self.block = block
        self.page = page
        self.children: dict = {}
        self.last_used = 0


class RadixTree:
    """Prefix cache keyed on page-sized token blocks.

    Each node owns exactly one KV page holding that block's keys/values
    and carries one pool reference for as long as it stays in the tree.
    Matching walks full blocks only (a partial block's KV cannot be
    shared — the page would still be written by its owner); recency is a
    monotonic clock bumped on every match/insert touch, giving the
    evictor an LRU order without wall-clock time.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._children: dict = {}  # root's children: {token-block: _Node}
        self._clock = 0
        self._n_nodes = 0

    def __len__(self) -> int:
        return self._n_nodes

    def _blocks(self, tokens) -> list[tuple]:
        ps = self.page_size
        n_full = len(tokens) // ps
        return [tuple(tokens[i * ps:(i + 1) * ps]) for i in range(n_full)]

    def match(self, tokens) -> tuple[int, list[int]]:
        """Longest cached prefix of ``tokens`` in whole blocks: returns
        (matched token count, the pages backing it, root-first).  Touches
        matched nodes' recency but takes NO pool references — the caller
        increfs the pages it decides to bind (before any further
        allocation, so eviction cannot race the hit)."""
        self._clock += 1
        children = self._children
        pages: list[int] = []
        for blk in self._blocks(tokens):
            nd = children.get(blk)
            if nd is None:
                break
            nd.last_used = self._clock
            pages.append(nd.page)
            children = nd.children
        return len(pages) * self.page_size, pages

    def insert(self, tokens, pages) -> int:
        """Retain ``tokens``' full blocks backed by ``pages`` (parallel
        lists, root-first).  Existing nodes are kept (first writer wins —
        the prefix KV is identical by construction, see module docstring);
        new nodes take a pool reference on their page.  Returns the number
        of newly retained pages."""
        self._clock += 1
        children = self._children
        added = 0
        for blk, page in zip(self._blocks(tokens), pages):
            nd = children.get(blk)
            if nd is None:
                nd = _Node(blk, page)
                self.pool.incref([page])
                children[blk] = nd
                self._n_nodes += 1
                added += 1
            nd.last_used = self._clock
            children = nd.children
        return added

    def evict(self, n_pages: int) -> int:
        """Free at least ``n_pages`` pages by dropping LRU *leaf* nodes
        whose pages only the tree references (live requests are never
        robbed).  Returns the number actually freed (may be less when
        everything else is shared or interior)."""
        freed = 0
        while freed < n_pages:
            victim_parent = victim_key = victim = None
            stack = [(self._children, k, nd) for k, nd in self._children.items()]
            while stack:
                parent, key, nd = stack.pop()
                if nd.children:
                    stack.extend((nd.children, k, c)
                                 for k, c in nd.children.items())
                    continue
                # leaf: evictable only if the tree holds the last reference
                if self.pool._refs[nd.page] == 1 and (
                        victim is None or nd.last_used < victim.last_used):
                    victim_parent, victim_key, victim = parent, key, nd
            if victim is None:
                break
            del victim_parent[victim_key]
            self._n_nodes -= 1
            self.pool.decref([victim.page])
            freed += 1
        return freed

    def drop_all(self) -> int:
        """Release every retained page (scheduler close/reset)."""
        freed = 0

        def walk(children):
            nonlocal freed
            for nd in children.values():
                walk(nd.children)
                self.pool.decref([nd.page])
                freed += 1

        walk(self._children)
        self._children = {}
        self._n_nodes = 0
        return freed

    # -- snapshot plumbing (runtime/snapshot.py DLSNAP02) -------------------

    def export(self) -> list:
        """JSON-serializable nested form: [[block tokens], page, children]."""
        def walk(children):
            return [[list(nd.block), nd.page, walk(nd.children)]
                    for nd in children.values()]

        return walk(self._children)

    def restore(self, data: list) -> None:
        """Rebuild from :meth:`export` output against a fresh pool whose
        page contents were restored out of band (the pool arrays ride the
        engine snapshot): claims each node's page from the free list."""
        if self._children:
            raise RuntimeError("restore into a non-empty prefix tree")

        def walk(children, items):
            for block, page, kids in items:
                self.pool.claim(page)
                nd = _Node(tuple(block), int(page))
                nd.last_used = self._clock
                children[tuple(block)] = nd
                self._n_nodes += 1
                walk(nd.children, kids)

        self._clock += 1
        walk(self._children, data)
