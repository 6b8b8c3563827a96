"""Host-side KV page accounting: the allocator and the prefix index.

The port's copy of ``paddle_tpu/serving/paging.py``, line for line, so the
two allocators hand out the same pages in the same order and evict the
same prefixes.

The device holds one page pool ``[L, n_pages, Hkv, page_size, dh]`` per
K/V (generation.py owns those tensors); THIS module owns the metadata —
which physical pages are free, how many holders reference each page, and
which pages cache which prompt prefixes. Everything here is plain Python
over numpy ints: no device traffic, no locks (the engine is single-
threaded per tick, like the slot table before it).

Two invariants the engine relies on:

- **Reservation-before-admission.** A request reserves every page it can
  ever need (prompt + max_new_tokens, plus one copy-on-write spare when
  it shares a page it will later write) at admission, so decode never
  allocates — pool pressure surfaces as a typed admission signal
  (:class:`~paddle_tpu_torch.serving.errors.CacheExhaustedError` /
  deferral), never as a mid-decode failure.
- **Write-implies-exclusive.** A page with refcount > 1 is never written;
  the engine copies it first (``kv_cache_page_copy``) and redirects the
  writer's block table to the copy. The prefix index counts as a holder,
  so cached prefixes are immutable by construction.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SCRAP_PAGE = 0  # padding rows / vacant decode slots write here


class PagePool:
    """Free-list + refcount allocator over ``n_pages`` physical pages.

    Page 0 is the scrap page — permanently pinned, never handed out.
    ``reserve``/``release_reservation`` implement admission-time holds:
    reserved pages are not yet assigned, but they are subtracted from
    :meth:`available` so concurrent admissions cannot oversubscribe, and
    ``alloc(reserved=True)`` draws a physical page out of the hold.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (one is scrap)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently-freed pages are re-used first
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self._ref = np.zeros(self.n_pages, np.int32)
        self._ref[SCRAP_PAGE] = 1  # pinned
        self._reserved = 0

    # -- accounting --------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable pages (everything but scrap)."""
        return self.n_pages - 1

    def available(self) -> int:
        """Pages allocatable right now (free minus admission holds)."""
        return len(self._free) - self._reserved

    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    # -- reservation holds -------------------------------------------------
    def reserve(self, n: int) -> None:
        """Hold ``n`` free pages for a future ``alloc(reserved=True)``."""
        if n < 0:
            raise ValueError("negative reservation")
        if self.available() < n:
            raise RuntimeError(
                f"reserve({n}) with only {self.available()} available")
        self._reserved += n

    def release_reservation(self, n: int) -> None:
        if n > self._reserved:
            raise RuntimeError("releasing more pages than reserved")
        self._reserved -= n

    # -- alloc/ref ---------------------------------------------------------
    def alloc(self, reserved: bool = False) -> int:
        """Pop a free page (refcount 1). ``reserved=True`` consumes one
        unit of a prior :meth:`reserve` hold."""
        if reserved:
            if self._reserved < 1:
                raise RuntimeError("alloc(reserved=True) without a hold")
            self._reserved -= 1
        elif self.available() < 1:
            raise RuntimeError("page pool exhausted")
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def alloc_many(self, n: int) -> List[int]:
        """Pop ``n`` free pages atomically: either all allocate or a
        RuntimeError leaves the pool untouched (a multi-page claim — a
        migrated-in KV handoff — must never half-land)."""
        if self.available() < n:
            raise RuntimeError(
                f"alloc_many({n}) with only {self.available()} available")
        return [self.alloc() for _ in range(n)]

    def incref(self, page: int) -> None:
        if page == SCRAP_PAGE or self._ref[page] < 1:
            raise RuntimeError(f"incref of unallocated page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        if page == SCRAP_PAGE:
            raise RuntimeError("decref of the scrap page")
        if self._ref[page] < 1:
            raise RuntimeError(f"decref of free page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            return True
        return False

    def stats(self) -> dict:
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "in_use": self.pages_in_use(), "free": len(self._free),
                "reserved": self._reserved,
                "shared": int(np.sum(self._ref[1:] > 1))}


def chain_key(parent: Optional[bytes], tokens: Sequence[int]) -> bytes:
    """Content-derived prefix key: digest of (parent key, page tokens).
    Two prompts share page i iff their first i pages carry identical
    tokens — the digest chain makes the whole-prefix comparison O(1)
    per page regardless of depth."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent or b"\x00")
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


class PrefixIndex:
    """LRU map from prompt-prefix keys to cached pages.

    Each entry holds ONE pool reference on its page, so cached prefixes
    survive the requests that produced them — the next request with the
    same system prompt skips that prefill. Entries are content-keyed by
    :func:`chain_key`, walked page-by-page from the prompt's first page;
    the final PARTIAL page may be cached too (keyed by its shorter token
    tuple), which is what makes a full-prompt hit — and therefore a real
    copy-on-write divergence — possible.

    ``evict_until`` frees least-recently-used entries until the pool can
    satisfy an allocation; entries whose page is still held by a live
    request drop only the index's reference (the page stays resident
    under the request and is freed when it finishes).
    """

    def __init__(self, pool: PagePool):
        self._pool = pool
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: np.ndarray) -> Tuple[int, List[int], bytes]:
        """Longest cached prefix of ``prompt``: returns
        ``(shared_tokens, page_ids, last_matched_key)``. Walks full
        pages, then tries the exact partial tail; ``shared_tokens`` is a
        page multiple except on a full-prompt hit. Does NOT take
        references — the caller increfs the pages it decides to use."""
        ps = self._pool.page_size
        key: Optional[bytes] = None
        pages: List[int] = []
        shared = 0
        n_full = len(prompt) // ps
        for i in range(n_full):
            k = chain_key(key, prompt[i * ps:(i + 1) * ps])
            page = self._entries.get(k)
            if page is None:
                self.misses += 1
                return shared, pages, key or b""
            self._entries.move_to_end(k)
            self.hits += 1
            key = k
            pages.append(page)
            shared += ps
        tail = prompt[n_full * ps:]
        if len(tail):
            k = chain_key(key, tail)
            page = self._entries.get(k)
            if page is not None:
                self._entries.move_to_end(k)
                self.hits += 1
                key = k
                pages.append(page)
                shared += len(tail)
            else:
                self.misses += 1
        return shared, pages, key or b""

    def insert(self, parent_key: bytes, tokens: Sequence[int],
               page: int) -> bytes:
        """Cache ``page`` as the prefix continuation ``tokens`` of
        ``parent_key`` (b"" for the first page). Takes one pool
        reference; a no-op (key returned) when already cached."""
        k = chain_key(parent_key or None, tokens)
        if k not in self._entries:
            self._pool.incref(page)
            self._entries[k] = page
        self._entries.move_to_end(k)
        return k

    def evict_until(self, pages_needed: int) -> int:
        """Drop LRU entries until ``pool.available() >= pages_needed``
        (or the index is empty). Returns entries evicted."""
        n = 0
        while (self._pool.available() < pages_needed and self._entries):
            _, page = self._entries.popitem(last=False)
            self._pool.decref(page)
            self.evictions += 1
            n += 1
        return n

    def clear(self) -> int:
        return self.evict_until(self._pool.n_pages + 1)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions}
