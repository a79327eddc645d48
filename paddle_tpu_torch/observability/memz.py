"""memz: page-level memory attribution, OOM forensics, fleet memory plane.

Port of paddle_tpu's `observability/memz.py`. tracez gives every
process a time plane — "what happened, in order"; memz gives it the
**memory plane** — "who holds page 17, right now".  Three pieces:

* :class:`MemRing` — a bounded, overwrite-on-wrap allocation event ring
  (same discipline as ``tracez.TraceRing``: one tuple build plus one
  slot assignment under one lock, no I/O, no device work).  Every ``PageAllocator`` alloc/retain/release/exhausted lands
  one ``(op, pool, owner, n, pages_free, ts)`` event on the process
  default :data:`RING` — recorded *after* the allocator's leaf lock is
  dropped, so the two locks never nest.
* A weakref **pool registry**: engines register their page pools (plus
  an optional context callback contributing kv ladder/rung state and
  the set of live request ids) and ``/memz`` renders every registered
  pool's owner rollups, fragmentation map, and **ghost-page audit** —
  pages whose owning stream/slot has finished but whose refcount is
  still > 0.
* **OOM forensics**: on ``PageExhausted`` the decode engine calls
  :func:`capture_oom`, which snapshots top holders by tenant and
  owner kind, trie-pinned vs slot-held vs tier-in-flight counts, the
  fragmentation map, engine context, and the tail of the allocation
  ring.  The last N dumps (``PADDLE_TPU_MEMZ_OOM_DUMPS``) are retained
  and served at ``/memz?oom=1`` — the post-mortem for "what exactly was
  resident when this RESOURCE_EXHAUSTED fired".

The ``paddle_tpu_mem_*`` families (pages by owner kind and tenant,
fragmentation, ghost pages, oom_dumps_total) refresh from the registry
on every scrape, so ``/varz`` keeps their history automatically.  The
router merges backend ``/memz`` bodies into a fleet view with
:func:`merge_memz` (next to ``_fleet_tracez``).
"""
from __future__ import annotations

import json
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core import flags as _flags
from . import metrics as _metrics

__all__ = ["MemRing", "RING", "ring_capacity", "oom_dump_limit",
           "register_pool", "snapshot", "status_block", "capture_oom",
           "oom_dumps", "ghost_audit", "fetch_memz", "merge_memz"]

DEFAULT_CAPACITY = 4096
DEFAULT_OOM_DUMPS = 4

#: Owner kinds every pool reports (fixed set so gauges zero out cleanly
#: when a kind's last page is released).
OWNER_KINDS = ("slot", "trie", "tier", "draft", "handoff", "untagged")

#: Owner kinds whose second element is a stream/slot id the ghost-page
#: audit can check against the engine's live set.
_STREAM_KINDS = ("slot", "draft", "handoff")


def _owner_str(owner) -> str:
    return ":".join(str(x) for x in owner)


def ring_capacity() -> int:
    """``PADDLE_TPU_MEMZ_RING_CAPACITY``; 0 disables the ring entirely."""
    try:
        return max(int(_flags.env_value("PADDLE_TPU_MEMZ_RING_CAPACITY")), 0)
    except Exception:
        return DEFAULT_CAPACITY


def oom_dump_limit() -> int:
    """``PADDLE_TPU_MEMZ_OOM_DUMPS``: OOM forensic dumps retained."""
    try:
        return max(int(_flags.env_value("PADDLE_TPU_MEMZ_OOM_DUMPS")), 1)
    except Exception:
        return DEFAULT_OOM_DUMPS


class MemRing:
    """Bounded allocation-event ring with a wall-clock anchor.

    Events are tuples ``(op, pool, owner, n, free, ts)`` where ``op`` is
    one of alloc/retain/release/exhausted/spill/refetch, ``owner`` is
    the allocator owner tag, ``n`` the page count the operation moved,
    ``free`` the pool's free pages after it, and ``ts`` a
    ``perf_counter`` timestamp.  When full, the oldest event is
    overwritten (``dropped`` counts the losses)."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = ring_capacity() if capacity is None \
            else max(int(capacity), 0)
        self.anchor_wall = time.time()
        self.anchor_mono = time.perf_counter()
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0
        self._lock = threading.Lock()

    # -- hot path ---------------------------------------------------------

    def record(self, op: str, pool: str, owner, n: int, free: int):
        """Append one raw event; the ring's only write path."""
        cap = self.capacity
        if cap == 0:
            return
        evt = (op, pool, owner, n, free, time.perf_counter())
        with self._lock:
            self._buf[self._n % cap] = evt
            self._n += 1

    # -- reads ------------------------------------------------------------

    @property
    def total(self) -> int:
        """Events recorded since creation (including overwritten ones)."""
        return self._n

    @property
    def dropped(self) -> int:
        return max(self._n - self.capacity, 0)

    def wall(self, ts: float) -> float:
        return self.anchor_wall + (ts - self.anchor_mono)

    def snapshot(self) -> Tuple[List[tuple], int]:
        """(events oldest->newest, total recorded)."""
        with self._lock:
            n, cap = self._n, self.capacity
            if cap == 0 or n == 0:
                return [], n
            if n <= cap:
                return list(self._buf[:n]), n
            i = n % cap
            return self._buf[i:] + self._buf[:i], n

    def clear(self):
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0

    def tail(self, limit: int = 64) -> List[dict]:
        """Last `limit` events rendered human-readable — what the OOM
        forensic dump and the flight recorder embed."""
        events, _ = self.snapshot()
        return [{"t": round(self.wall(ts), 6), "op": op, "pool": pool,
                 "owner": _owner_str(owner), "n": n, "free": free}
                for op, pool, owner, n, free, ts in events[-limit:]]


# ---------------------------------------------------------------------------
# process-default ring + registry gauges
# ---------------------------------------------------------------------------

RING = MemRing()

_PAGES = _metrics.gauge(
    "paddle_tpu_mem_pages",
    "Used pages per registered pool attributed to their primary owner "
    "kind (slot/trie/tier/draft/handoff/untagged); kinds sum to the "
    "pool's pages_used exactly.",
    labelnames=("pool", "owner_kind"))
_TENANT_PAGES = _metrics.gauge(
    "paddle_tpu_mem_tenant_pages",
    "Used pages per registered pool attributed to the tenant of their "
    "primary slot owner ('-' = not slot-held).",
    labelnames=("pool", "tenant"))
_FRAG = _metrics.gauge(
    "paddle_tpu_mem_fragmentation",
    "Free-space fragmentation per registered pool (1 - largest "
    "contiguous free run / free pages).",
    labelnames=("pool",))
_GHOSTS = _metrics.gauge(
    "paddle_tpu_mem_ghost_pages",
    "Ghost pages per registered pool: pages whose owning stream/slot "
    "has finished but whose refcount is still > 0.",
    labelnames=("pool",))
_RING_EVENTS = _metrics.gauge(
    "paddle_tpu_mem_ring_events",
    "Allocation events recorded into the default memz ring since "
    "process start (overwritten events included).")
_OOM_TOTAL = _metrics.counter(
    "paddle_tpu_mem_oom_dumps_total",
    "OOM forensic dumps captured on PageExhausted (served at "
    "/memz?oom=1; last PADDLE_TPU_MEMZ_OOM_DUMPS retained).")


# ---------------------------------------------------------------------------
# pool registry
# ---------------------------------------------------------------------------

_POOLS: Dict[str, Tuple[Any, Any]] = {}   # label -> (alloc ref, ctx ref)
_POOLS_LOCK = threading.Lock()


def register_pool(alloc, context_fn: Optional[Callable[[], dict]] = None,
                  label: Optional[str] = None) -> str:
    """Register a ``PageAllocator`` (weakly — a stopped engine's pool
    unregisters itself by dying) under its label.  ``context_fn``
    contributes engine context to snapshots and OOM dumps — any dict,
    conventionally including ``live_owner_ids`` (ids of streams still
    alive) which powers the ghost-page audit.  Re-registering a label
    replaces the previous pool (engine restarts)."""
    key = str(label if label is not None else alloc.label)
    ctx = None
    if context_fn is not None:
        try:
            ctx = weakref.WeakMethod(context_fn)
        except TypeError:
            ctx = (lambda fn=context_fn: fn)
    with _POOLS_LOCK:
        _POOLS[key] = (weakref.ref(alloc), ctx)
    return key


def _iter_pools():
    """Yield (label, alloc, context dict or {}) for live pools, pruning
    dead weakrefs."""
    with _POOLS_LOCK:
        items = list(_POOLS.items())
    for label, (aref, ctxref) in items:
        alloc = aref()
        if alloc is None:
            with _POOLS_LOCK:
                if _POOLS.get(label) == (aref, ctxref):
                    del _POOLS[label]
            continue
        ctx = {}
        if ctxref is not None:
            fn = ctxref()
            if fn is not None:
                try:
                    ctx = fn() or {}
                except Exception:
                    ctx = {"error": "context callback failed"}
        yield label, alloc, ctx


def ghost_audit(alloc, context: Optional[dict]) -> List[dict]:
    """Pages whose owning stream/slot has finished but refcount > 0.

    Checks each page's primary owner: if its kind names a stream
    (slot/draft/handoff) and the owner id is absent from the engine's
    ``live_owner_ids``, the page is leaked-but-held — a ghost.  Without
    a live set the audit reports nothing (no false positives)."""
    live = (context or {}).get("live_owner_ids")
    if live is None:
        return []
    live = {str(x) for x in live}
    ghosts = []
    for page, owner, refs in alloc.owned_pages():
        if (str(owner[0]) in _STREAM_KINDS and len(owner) > 1
                and str(owner[1]) not in live):
            ghosts.append({"page": page, "owner": _owner_str(owner),
                           "refs": refs})
    return ghosts


# ---------------------------------------------------------------------------
# snapshots (the /memz body) + OOM forensics
# ---------------------------------------------------------------------------

_OOM_DUMPS: deque = deque(maxlen=64)
_OOM_LOCK = threading.Lock()
_OOM_SEQ = [0]


def snapshot(oom: bool = False) -> dict:
    """The ``/memz`` body: every registered pool's stats + owner
    rollups + fragmentation map + ghost audit, the allocation-ring
    tail, and the OOM dump count.  With ``oom=True`` (``/memz?oom=1``)
    returns the retained OOM forensic dumps instead."""
    if oom:
        with _OOM_LOCK:
            return {"oom_dumps": list(_OOM_DUMPS)}
    pools = {}
    for label, alloc, ctx in _iter_pools():
        st = alloc.stats()
        ghosts = ghost_audit(alloc, ctx)
        entry = {
            "stats": st,
            "fragmentation_map": alloc.fragmentation_map(),
            "ghost_pages": len(ghosts),
            "ghosts": ghosts[:32],
        }
        if ctx:
            entry["context"] = {k: v for k, v in ctx.items()
                                if k != "live_owner_ids"}
        pools[label] = entry
    with _OOM_LOCK:
        n_dumps = len(_OOM_DUMPS)
    return {
        "pools": pools,
        "ring": {"events_recorded": RING.total,
                 "events_dropped": RING.dropped,
                 "capacity": RING.capacity,
                 "tail": RING.tail(64)},
        "oom_dumps": n_dumps,
        "time": time.time(),
    }


def status_block() -> dict:
    """Compact per-pool summary for /statusz and stall dumps: owner
    rollups + fragmentation + ghost count, no maps or ring tail."""
    pools = {}
    for label, alloc, ctx in _iter_pools():
        st = alloc.stats()
        pools[label] = {
            "pages_used": st["pages_used"],
            "pages_free": st["pages_free"],
            "fragmentation": st["fragmentation"],
            "owner_kinds": st["owner_kinds"],
            "tenants": st["tenants"],
            "top_owners": dict(list(st["owners"].items())[:8]),
            "ghost_pages": len(ghost_audit(alloc, ctx)),
        }
    with _OOM_LOCK:
        n_dumps = len(_OOM_DUMPS)
    return {"pools": pools, "oom_dumps": n_dumps,
            "ring_events": RING.total}


def capture_oom(alloc, *, owner=None, requested: int = 0,
                context: Optional[dict] = None) -> dict:
    """Snapshot the pool at the moment a ``PageExhausted`` fired — the
    OOM forensic dump.  Retained (last ``PADDLE_TPU_MEMZ_OOM_DUMPS``)
    and served at ``/memz?oom=1``.  Pure bookkeeping reads; safe on the
    scheduler thread, never called under the allocator lock."""
    st = alloc.stats()
    ghosts = ghost_audit(alloc, context)
    dump = {
        "pool": alloc.label,
        "time": time.time(),
        "denied_owner": _owner_str(owner) if owner else "untagged",
        "requested": int(requested),
        "pages_free": st["pages_free"],
        "pages_used": st["pages_used"],
        "top_owners": dict(list(st["owners"].items())[:20]),
        "owner_kinds": st["owner_kinds"],
        "tenants": st["tenants"],
        "fragmentation": st["fragmentation"],
        "fragmentation_map": alloc.fragmentation_map(),
        "ghost_pages": len(ghosts),
        "ghosts": ghosts[:32],
        "stats": st,
        "context": {k: v for k, v in (context or {}).items()
                    if k != "live_owner_ids"},
        "ring_tail": RING.tail(64),
    }
    with _OOM_LOCK:
        _OOM_SEQ[0] += 1
        dump["seq"] = _OOM_SEQ[0]
        _OOM_DUMPS.append(dump)
        while len(_OOM_DUMPS) > oom_dump_limit():
            _OOM_DUMPS.popleft()
    _OOM_TOTAL.inc()
    return dump


def oom_dumps() -> List[dict]:
    with _OOM_LOCK:
        return list(_OOM_DUMPS)


def clear_oom_dumps():                     # test hook
    with _OOM_LOCK:
        _OOM_DUMPS.clear()


# ---------------------------------------------------------------------------
# registry collector: mem gauges refresh from live pools on every scrape
# ---------------------------------------------------------------------------

def _collect_mem():
    _RING_EVENTS.set(RING.total)
    for label, alloc, ctx in _iter_pools():
        st = alloc.stats()
        kinds = st["owner_kinds"]
        for kind in OWNER_KINDS:
            _PAGES.labels(pool=label, owner_kind=kind).set(
                kinds.get(kind, 0))
        tenants = st["tenants"]
        for labels, _ in _TENANT_PAGES.samples():
            if labels["pool"] == label and labels["tenant"] not in tenants:
                _TENANT_PAGES.remove(**labels)
        for tenant, n in tenants.items():
            _TENANT_PAGES.labels(pool=label, tenant=tenant).set(n)
        _FRAG.labels(pool=label).set(st["fragmentation"])
        _GHOSTS.labels(pool=label).set(len(ghost_audit(alloc, ctx)))


_metrics.REGISTRY.add_collector(_collect_mem)


# ---------------------------------------------------------------------------
# fleet view: the router merges backend /memz bodies
# ---------------------------------------------------------------------------

def fetch_memz(url: str, timeout: float = 5.0) -> dict:
    """GET a live ``/memz`` body from an admin endpoint."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def merge_memz(snapshots, keys: Optional[List[str]] = None) -> dict:
    """Merge per-backend ``/memz`` bodies into one fleet view: summed
    owner-kind/tenant rollups and pool totals across the fleet, with
    every backend's full body retained under ``backends``.  OOM-mode
    bodies (``{"oom_dumps": [...]}``) merge into one time-ordered dump
    list.  An unreachable backend is simply absent."""
    backends = {}
    kinds: Dict[str, int] = {}
    tenants: Dict[str, int] = {}
    totals = {"pages_total": 0, "pages_used": 0, "pages_free": 0,
              "ghost_pages": 0, "oom_dumps": 0}
    all_dumps: List[dict] = []
    for i, snap in enumerate(snapshots):
        if not snap:
            continue
        key = keys[i] if keys and i < len(keys) else f"backend-{i}"
        backends[key] = snap
        dumps = snap.get("oom_dumps")
        if isinstance(dumps, list):
            all_dumps.extend(dumps)
            totals["oom_dumps"] += len(dumps)
            continue
        totals["oom_dumps"] += int(dumps or 0)
        for entry in (snap.get("pools") or {}).values():
            st = entry.get("stats") or {}
            for k in ("pages_total", "pages_used", "pages_free"):
                totals[k] += int(st.get(k, 0))
            totals["ghost_pages"] += int(entry.get("ghost_pages", 0))
            for k, n in (st.get("owner_kinds") or {}).items():
                kinds[k] = kinds.get(k, 0) + int(n)
            for t, n in (st.get("tenants") or {}).items():
                tenants[t] = tenants.get(t, 0) + int(n)
    if all_dumps:
        all_dumps.sort(key=lambda d: d.get("time", 0.0))
        return {"merged": len(backends), "oom_dumps": all_dumps,
                "backends": sorted(backends)}
    out = {"merged": len(backends), "owner_kinds": kinds,
           "tenants": tenants, "backends": backends}
    out.update(totals)
    return out
