"""Refcounted page allocator over a fixed device-resident pool.

Port of paddle_tpu's `memory/page_allocator.py`. The allocator never
touches device memory — it hands out integer *page ids* into a pool whose
storage the caller owns (for decode: `[layers, pages, page_tokens, heads,
head_dim]` K/V tensors).

Conventions:

  * page 0 is always the reserved **null page** — a scratch sink for
    block-table padding and padded-batch writes, so garbage writes land
    somewhere harmless instead of clobbering live data. It is never
    allocated and never freed.
  * every page has a refcount. `alloc` returns pages at refcount 1;
    `retain` increments (copy-on-write sharing: a prefix cache maps the
    same page into many sequences); `release` decrements and returns
    the page to the free list at zero; `release_range` drops one
    reference on each page of a block table's tail under one lock (the
    speculative-decode rollback), validating every id first.
  * `alloc` raises :class:`PageExhausted` (typed, catchable) instead of
    over-committing — callers turn that into backpressure.
  * thread-safe behind one leaf lock; no callback, device work, or I/O
    ever runs under it.

Owner attribution: every alloc/retain/release accepts an optional
``owner`` tag — a small tuple such as ``("slot", req_id, tenant)`` or
``("trie", node)`` — kept in a side table under the same lock. Rollups
attribute each used page to its **primary owner** (the first
still-holding tagger), so the per-owner page counts always sum to
exactly ``pages_used``. The JAX package also records each operation on
its memz ring; that plane is not ported yet.

`write_pages` / `copy_page` / `gather_pages` are the pool ops that pair
with the bookkeeping, as torch index ops over a pool whose axis 1 is the
page axis (a tensor, or the int8 pool's (data, scale) pair); they are
the only scatter and gather of pool pages in the package (`models.gpt`
writes its rows through `write_pages`). Unlike the
JAX versions (pure functions over donated buffers), `write_pages` and
`copy_page` update the pool **in place**.
"""
from __future__ import annotations

import threading
from bisect import insort
from typing import Dict, List, Optional, Tuple

import torch

#: Attribution bucket for alloc/retain/release calls with no owner tag.
UNTAGGED: Tuple[str, ...] = ("untagged",)

#: The one pool the port allocates from: the decode engine's KV pages.
POOL = "kv"

#: Page id of the reserved null page.
NULL_PAGE = 0


class PageExhausted(RuntimeError):
    """Raised by `PageAllocator.alloc` when the free list cannot cover
    the request — the caller's cue for eviction or backpressure.
    Attributes ``pool`` / ``owner`` / ``requested`` / ``free`` identify
    the denied pool, the requester's owner tag, and the shortfall."""

    def __init__(self, message: str, *, pool: str = "",
                 owner: Tuple = UNTAGGED, requested: int = 0,
                 free: int = 0):
        super().__init__(message)
        self.pool = pool
        self.owner = owner
        self.requested = requested
        self.free = free


def owner_str(owner) -> str:
    """Stable printable form of an owner tag (JSON-safe dict key)."""
    return ":".join(str(x) for x in owner)


class PageAllocator:
    """Bookkeeping for a pool of `num_pages` fixed-size device pages."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"page pool needs >= 2 pages, got {num_pages}")
        self.num_pages = int(num_pages)
        self._lock = threading.Lock()
        # kept sorted ascending at all times: alloc slices the head,
        # release bisect-inserts — never a full sort on the hot path
        self._free: List[int] = list(range(NULL_PAGE + 1, self.num_pages))
        self._refs: Dict[int, int] = {}
        # page -> {owner tag -> refs held under that tag}; insertion
        # order makes the first surviving key the page's primary owner
        self._owners: Dict[int, Dict[Tuple, int]] = {}
        self._allocs = 0
        self._failures = 0
        self._high_water = 0

    # ------------------------------------------------- owner side table

    def _owner_add(self, page: int, owner: Tuple, n: int = 1) -> None:
        d = self._owners.get(page)
        if d is None:
            d = self._owners[page] = {}
        d[owner] = d.get(owner, 0) + n

    def _owner_drop(self, page: int, owner: Tuple) -> None:
        """Drop one owner ref for `page`: the given tag if it holds one,
        else the untagged bucket, else the newest holder — a mismatched
        tag degrades attribution, never correctness."""
        d = self._owners.get(page)
        if not d:
            return
        key = owner if owner in d else (
            UNTAGGED if UNTAGGED in d else next(reversed(d)))
        left = d[key] - 1
        if left > 0:
            d[key] = left
        else:
            del d[key]

    # ------------------------------------------------------------- ops

    def alloc(self, n: int = 1, owner: Optional[Tuple] = None) -> List[int]:
        """Hand out `n` pages at refcount 1 (lowest ids first — keeps
        the pool dense), attributed to `owner` (or the untagged bucket)."""
        if n <= 0:
            return []
        tag = owner if owner is not None else UNTAGGED
        with self._lock:
            free = len(self._free)
            if n > free:
                self._failures += 1
                pages = None
            else:
                pages = self._free[:n]
                del self._free[:n]
                for p in pages:
                    self._refs[p] = 1
                    self._owners[p] = {tag: 1}
                self._allocs += n
                self._high_water = max(self._high_water, len(self._refs))
        if pages is None:
            raise PageExhausted(
                f"pool '{POOL}': requested {n} pages for "
                f"{owner_str(tag)}, {free} free of {self.num_pages}",
                pool=POOL, owner=tag, requested=n, free=free)
        return pages

    def retain(self, page: int, owner: Optional[Tuple] = None) -> int:
        """Add a reference to an allocated page (sharing); returns the
        new refcount."""
        tag = owner if owner is not None else UNTAGGED
        with self._lock:
            if page not in self._refs:
                raise ValueError(f"retain of unallocated page {page}")
            self._refs[page] += 1
            self._owner_add(page, tag)
            return self._refs[page]

    def release(self, page: int, owner: Optional[Tuple] = None) -> int:
        """Drop a reference; the page rejoins the free list at zero.
        Returns the remaining refcount."""
        tag = owner if owner is not None else UNTAGGED
        with self._lock:
            refs = self._refs.get(page)
            if refs is None:
                raise ValueError(f"release of unallocated page {page}")
            if refs > 1:
                self._refs[page] = refs - 1
                self._owner_drop(page, tag)
                return refs - 1
            del self._refs[page]
            self._owners.pop(page, None)
            insort(self._free, page)
            return 0

    def release_range(self, ids, from_idx: int,
                      owner: Optional[Tuple] = None) -> int:
        """Drop one reference on every page in ``ids[from_idx:]`` under a
        single lock acquisition — the speculative-decode rollback path,
        which strands a tail of a block table past the last accepted
        token. Returns the number of references dropped. Any unallocated
        id raises ValueError before *any* refcount changes, so a bad call
        never half-applies."""
        tag = owner if owner is not None else UNTAGGED
        tail = [int(p) for p in list(ids)[max(int(from_idx), 0):]]
        with self._lock:
            for p in tail:
                if p not in self._refs:
                    raise ValueError(f"release of unallocated page {p}")
            for p in tail:
                refs = self._refs[p]
                if refs > 1:
                    self._refs[p] = refs - 1
                    self._owner_drop(p, tag)
                else:
                    del self._refs[p]
                    self._owners.pop(p, None)
                    insort(self._free, p)
        return len(tail)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    # ----------------------------------------------------------- stats

    def owner_rollups(self) -> Tuple[Dict, Dict, Dict]:
        """(by_owner, by_kind, by_tenant) page counts under primary-owner
        attribution: each used page counts once, toward the first owner
        tag still holding it — so every rollup sums to ``pages_used``
        exactly. Tenants come from ``("slot", req, tenant)`` tags; pages
        not held by any slot count toward tenant ``"-"``."""
        by_owner: Dict[Tuple, int] = {}
        by_kind: Dict[str, int] = {}
        by_tenant: Dict[str, int] = {}
        with self._lock:
            primaries = [next(iter(d)) for d in self._owners.values() if d]
        for owner in primaries:
            by_owner[owner] = by_owner.get(owner, 0) + 1
            kind = str(owner[0])
            by_kind[kind] = by_kind.get(kind, 0) + 1
            tenant = str(owner[2]) if kind == "slot" and len(owner) > 2 \
                else "-"
            by_tenant[tenant] = by_tenant.get(tenant, 0) + 1
        return by_owner, by_kind, by_tenant

    def stats(self) -> Dict:
        """Occupancy + fragmentation snapshot (all counts exclude the
        reserved null page). Fragmentation is 1 − largest contiguous
        free run / free pages: 0.0 when the free space is one block
        (or empty), approaching 1.0 as it shatters."""
        with self._lock:
            free = list(self._free)        # already sorted ascending
            used = len(self._refs)
            shared = sum(1 for r in self._refs.values() if r > 1)
            refs_total = sum(self._refs.values())
            allocs, failures = self._allocs, self._failures
            high = self._high_water
        longest = run = 0
        for i, p in enumerate(free):
            run = run + 1 if i and p == free[i - 1] + 1 else 1
            longest = max(longest, run)
        frag = 0.0 if not free else 1.0 - longest / len(free)
        by_owner, by_kind, by_tenant = self.owner_rollups()
        return {
            "pages_total": self.num_pages - 1,
            "pages_free": len(free),
            "pages_used": used,
            "pages_shared": shared,
            "refs_total": refs_total,
            "fragmentation": round(frag, 4),
            "allocs_total": allocs,
            "alloc_failures_total": failures,
            "high_watermark": high,
            "owners": {owner_str(o): c for o, c in sorted(
                by_owner.items(), key=lambda kv: -kv[1])},
            "owner_kinds": by_kind,
            "tenants": by_tenant,
        }


# ----------------------------------------------------------- pool ops
#
# A pool is a bare tensor (fp32 pages) or the int8 pool's ``(data, scale)``
# pair from `quant.kv` (scale drops data's trailing head_dim axis); every
# op below applies to each tensor of a pair with the same indices.

def _leaves(pool):
    return pool if isinstance(pool, tuple) else (pool,)


def write_pages(pool, rows, page_ids, offset=slice(None), layer=slice(None)):
    """Scatter into the pool, in place: ``pool[layer, page_ids, offset] =
    rows``; returns `pool`.

    pool      [L, P, page_tokens, ...]  (page axis = 1), or a (data,
              scale) pair
    rows      [L, W, page_tokens, ...]  whole pages (the defaults), or
              [..., R, ...] single rows when `offset` is an [R] index
              vector beside [R] `page_ids` (and `layer` one layer or all);
              a pair for a pair pool

    Duplicate destinations (several padding rows aimed at the null page)
    resolve arbitrarily — by convention only don't-care data is ever
    aimed at a duplicated id.
    """
    if isinstance(pool, tuple) != isinstance(rows, tuple):
        raise TypeError("write_pages: a (data, scale) pool takes "
                        "(data, scale) rows, a tensor pool a tensor")
    for p, r in zip(_leaves(pool), _leaves(rows)):
        p[layer, page_ids, offset] = r
    return pool


def copy_page(pool, src: int, dst: int):
    """Copy one page (copy-on-write), in place: pool[:, dst] = pool[:, src]
    on every tensor of the pool. Returns `pool`."""
    for p in _leaves(pool):
        p[:, int(dst)].copy_(p[:, int(src)])
    return pool


def gather_pages(pool, page_ids: torch.Tensor):
    """Gather whole pages into a fresh `[L, *page_ids.shape, page_tokens,
    ...]` tensor (a pair for a pair pool) — the read twin of
    `write_pages`. `page_ids` may be a [W] list or a [B, W] block table;
    the result shares no storage with the pool."""
    out = []
    for p in _leaves(pool):
        ids = page_ids.to(p.device, torch.long)
        out.append(p.index_select(1, ids.reshape(-1)).reshape(
            p.shape[:1] + tuple(ids.shape) + p.shape[2:]))
    return tuple(out) if isinstance(pool, tuple) else out[0]


__all__ = ["PageAllocator", "PageExhausted", "UNTAGGED", "POOL",
           "NULL_PAGE", "owner_str",
           "write_pages", "copy_page", "gather_pages"]
