"""Paged KV-cache page pool: fixed-size pages, refcounts, prefix cache.

The host-side allocator behind the paged serving engine, a copy of the
reference's ``repro.serve.kv_cache`` (standard library only).
Device storage lives in the model's paged cache
(:func:`repro_torch.models.init_paged_cache`); this module manages page ids:

* **Fixed-size pages.**  A page holds ``page_size`` token slots in every
  layer at once (the cache tensors carry a leading period axis).  Page 0 is
  the **null page**: padded page-table entries and inactive lanes' decode
  writes land there, so every gather and scatter stays in bounds.
* **Refcounts.**  A page holding a shared prompt prefix is owned by several
  sequences.  Shared and registered pages are never written: the one write
  that could land in them, the last-token replay (decode-path bytes, about
  an ulp from the prefill-path bytes), goes to a private copy-on-write
  page instead, so registered content stays what a cold prefill writes.
* **Hash-chain prefix cache.**  A full page is registered under the token
  prefix it completes (the exact tuple is the key: no collisions).  Freed
  registered pages park in an LRU list and are revived on a later hit; they
  are evicted (unregistered and reused) only when the free list runs dry.
* **Copy-on-write partial hits.**  When a prompt's unmatched tail is shorter
  than a page and a registered page continues the matched prefix with those
  tokens, :meth:`PagePool.match_partial` returns it as the source the engine
  copies into a fresh page.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.faults import fault_point

__all__ = ["NULL_PAGE", "PagePool", "page_nbytes"]

NULL_PAGE = 0

_KV_ELEM_BYTES = {"bf16": 2.0, "int8": 1.0, "int4": 0.5}


def page_nbytes(
    page_size: int, kvp: int, hd: int, n_periods: int, kv_dtype: str = "bf16"
) -> int:
    """Device bytes one page id costs across all layers: k + v codes at the
    dtype's element width (0.5 B for packed int4) plus the fp32
    per-(slot, head) scale planes quantized dtypes carry.  This is the unit
    for equal-**byte** KV budgets: at a fixed budget, int4 pools hold
    ~3.5× the pages of bf16."""
    elem = _KV_ELEM_BYTES[kv_dtype]
    per_slot = kvp * hd * elem + (kvp * 4.0 if kv_dtype != "bf16" else 0.0)
    return int(2 * per_slot * page_size * n_periods)


class PagePool:
    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least one allocatable page beyond the null page")
        self.n_pages = n_pages
        self.page_size = page_size
        self.free: list[int] = list(range(1, n_pages))
        self.ref = [0] * n_pages
        # Prefix cache: exact token-prefix tuple -> page id completing it,
        # plus a parent-prefix index for O(1) partial-hit (COW) lookup.
        self.by_key: dict[tuple, int] = {}
        self.key_of: dict[int, tuple] = {}
        self.children: dict[tuple, set[int]] = {}
        self.cached_free: list[int] = []  # LRU order, registered pages w/ ref 0
        self.n_evictions = 0

    # -- allocation ---------------------------------------------------------

    @property
    def n_free(self) -> int:
        """Allocatable pages (truly free + evictable cached-free)."""
        return len(self.free) + len(self.cached_free)

    def alloc(self, n: int) -> Optional[list[int]]:
        """Allocate ``n`` pages with refcount 1, or None if the pool can't
        satisfy the request (never partially allocates).  Prefers truly
        free pages; evicts cached-free pages LRU-first only when needed.

        Injection point ``pool.alloc`` (DESIGN.md §Resilience): a ``deny``
        action simulates a pool-exhaustion spike — the allocation fails as
        if the pool were dry, exercising the engine's preemption and
        head-of-line machinery without actually draining pages."""
        if n > 0 and fault_point("pool.alloc") == "deny":
            return None
        if self.n_free < n:
            return None
        out = []
        for _ in range(n):
            if self.free:
                pid = self.free.pop()
            else:
                pid = self.cached_free.pop(0)
                self._unregister(pid)
                self.n_evictions += 1
            self.ref[pid] = 1
            out.append(pid)
        return out

    def incref(self, pid: int):
        if self.ref[pid] == 0:  # revive a parked cached-free page
            self.cached_free.remove(pid)
        self.ref[pid] += 1

    def release(self, pid: int):
        """Drop one reference; at zero the page parks (if registered) or
        returns to the free list."""
        assert self.ref[pid] > 0, f"double free of page {pid}"
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            if pid in self.key_of:
                self.cached_free.append(pid)
            else:
                self.free.append(pid)

    def _unregister(self, pid: int):
        key = self.key_of.pop(pid, None)
        if key is not None:
            self.by_key.pop(key, None)
            parent = key[: -self.page_size]
            kids = self.children.get(parent)
            if kids is not None:
                kids.discard(pid)
                if not kids:
                    del self.children[parent]

    # -- prefix cache -------------------------------------------------------

    def register(self, pid: int, prefix: tuple):
        """Mark ``pid`` as holding the final (full) page of token
        ``prefix`` (len(prefix) must be a multiple of page_size).  A prefix
        already registered by another page keeps its first owner."""
        assert len(prefix) % self.page_size == 0 and prefix
        if prefix in self.by_key or pid in self.key_of:
            return
        self.by_key[prefix] = pid
        self.key_of[pid] = prefix
        self.children.setdefault(prefix[: -self.page_size], set()).add(pid)

    def match_full(self, tokens: tuple) -> tuple[list[int], int]:
        """Longest cached full-page prefix of ``tokens``.  Returns
        ``(pages, n_matched_tokens)`` with every returned page increfed
        (ownership transfers to the caller)."""
        psz = self.page_size
        pages: list[int] = []
        i = psz
        while i <= len(tokens):
            pid = self.by_key.get(tokens[:i])
            if pid is None:
                break
            self.incref(pid)
            pages.append(pid)
            i += psz
        return pages, len(pages) * psz

    def match_partial(self, tokens: tuple, n_matched: int) -> Optional[int]:
        """COW source for the tail ``tokens[n_matched:]`` (when shorter
        than a page): a registered page continuing the matched prefix
        whose leading tokens equal the tail.  Not increfed — the caller
        copies its contents synchronously into a fresh page."""
        psz = self.page_size
        rem = tokens[n_matched:]
        if not rem or len(rem) >= psz:
            return None
        for pid in self.children.get(tokens[:n_matched], ()):
            if self.key_of[pid][n_matched : n_matched + len(rem)] == rem:
                return pid
        return None
