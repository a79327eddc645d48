"""Async host<->device page migration: the two-tier KV memory manager.

Port of paddle_tpu's `memory/migration.py`. The device page pool becomes
a *cache* over a larger host-RAM page store. Three pieces:

* :class:`TieredPageAllocator` grows :class:`PageAllocator` into a
  two-tier manager. Device pages keep the inherited id space
  (non-negative ints); spilled page *contents* live in a bounded host
  tier addressed by negative **handles**, each with a residency state —
  ``HOST`` (payload landed, refetchable), ``IN_FLIGHT`` (a migration is
  moving it in either direction). Device-resident pages are simply
  allocator pages (residency ``DEVICE``). Pure bookkeeping behind one
  leaf lock, like the base class — it never touches device memory.
* :class:`HostPageStore` owns the payload bytes: ONE host buffer
  allocated at construction and carved into a per-pool-leaf arena
  (page-locked when the pool lives on a GPU, so copies to and from it
  are true async DMA; a pin that fails raises, it never falls back to
  pageable memory), indexed by the same handles.
* :class:`MigrationEngine` is the async transport. On a GPU every copy
  runs on the engine's own CUDA stream, enqueued by the submitting
  (scheduler) thread when it submits — the thread that holds the GIL
  anyway, where a worker thread issuing the copies waited for the GIL at
  every call while the scheduler ran the decode loop (PERF.md §6).
  A spill's device->host copies wait
  (an event) for the gather the scheduler enqueued on its stream, and
  the gathered snapshot stays referenced by the ticket until the copies'
  event has completed; a refetch's host->device copies land in a fresh
  staging buffer whose event the scheduler waits on before it writes the
  rows into the pool. A background worker with per-direction queues and
  a bounded in-flight window retires the tickets: it waits on each
  batch's event (the GIL released) and runs its callback. Spills retire
  before refetches; a handle is refetchable only once its spill has
  committed, and both directions' copies share the one stream in
  submission order.

The engine is consumer-agnostic: callers hand it device chunks / handle
lists plus an ``on_done`` callback, so the same transport serves KV
tiering, and :func:`serialize_pages` / :func:`deserialize_pages` serve
the cross-process prefill/decode KV handoff with the JAX package's wire
layout (the same leaf order, uint8 views of int8 leaves and per-page
crc32 chain), so a payload crosses between the packages. Failure never
raises out of the worker — the callback reports it and the *caller*
decides (the decode engine degrades to a re-prefill, which is always
correct).

Chaos: every migration batch passes the ``page.migrate`` site in the
worker before it retires. A ``Fail`` kills that batch (callback with the
error; whatever its copies moved is never used); ``Hang@s`` sleeps the
worker — both stall or fail only streams waiting on those pages, because
no scheduler thread ever blocks on this worker.

Observability: the ``paddle_tpu_kv_tier_*`` families (resident pages per
tier, spill/refetch counters, per-direction migration latency, in-flight
depth), one ``page.spill`` / ``page.refetch`` tracez span per retired
batch (from its submission to its retirement), and a
``spill`` / ``refetch`` memz ring event per page as its handle commits.
"""
from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .page_allocator import PageAllocator, _ring_record, gather_pages

__all__ = ["Residency", "TieredPageAllocator", "HostPageStore",
           "MigrationEngine", "MigrationTicket", "gather_pages",
           "serialize_pages", "deserialize_pages", "tier_metrics"]

_ARENA_ALIGN = 64          # byte alignment of each leaf's arena


class Residency:
    """Residency states for a logical KV page in the two-tier manager."""
    DEVICE = "DEVICE"
    HOST = "HOST"
    IN_FLIGHT = "IN_FLIGHT"


_METRICS = None


def tier_metrics():
    """Register (idempotently) and return the paddle_tpu_kv_tier_* family."""
    global _METRICS
    if _METRICS is None:
        from ..observability import counter, gauge, histogram
        _METRICS = {
            "resident": gauge(
                "paddle_tpu_kv_tier_resident_pages",
                "KV pages resident per tier: device = allocator pages in "
                "use, host = spilled page payloads held in the host "
                "arena (in-flight pages count toward host)",
                labelnames=("tier",)),
            "spills": counter(
                "paddle_tpu_kv_tier_spills_total",
                "KV pages spilled device -> host by the migration "
                "engine"),
            "refetches": counter(
                "paddle_tpu_kv_tier_refetches_total",
                "KV pages refetched host -> device by the migration "
                "engine"),
            "migration_seconds": histogram(
                "paddle_tpu_kv_tier_migration_seconds",
                "Wall time of one migration batch by direction "
                "(out = device->host spill, in = host->device refetch)",
                labelnames=("direction",)),
            "inflight": gauge(
                "paddle_tpu_kv_tier_inflight",
                "Migration jobs submitted but not yet retired "
                "(queued + dispatched)"),
        }
    return _METRICS


# ------------------------------------------------------- pool structure
#
# A pool is a tensor or the int8 pool's (data, scale) pair; an engine
# moves all of its pools as one tuple ((k, v), or (k, v, dk, dv) for the
# speculative engine). Leaves flatten depth-first, left to right — the
# order `jax.tree_util.tree_flatten` gives the JAX engine's pytree, so a
# chunk's leaves line up across the packages.

def pool_leaves(tree) -> list:
    """The leaves of a nested tuple of tensors, in JAX tree order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in pool_leaves(sub)]
    return [tree]


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, (tuple, list)):
            return tuple(build(s) for s in t)
        return next(it)
    return build(template)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TieredPageAllocator(PageAllocator):
    """`PageAllocator` plus a bounded host tier of spilled page contents.

    Host **handles** are negative ints (``-(slot + 1)`` for arena slot
    ``slot``) so they can never collide with device page ids; callers
    that store "a page or its spilled handle" branch on the sign. The
    handle lifecycle is
    ``spill_begin (IN_FLIGHT) -> spill_commit (HOST) ->
    refetch_begin (IN_FLIGHT) -> host_drop`` with ``host_drop`` also
    serving every abort path. All transitions are O(1) bookkeeping
    under the inherited leaf lock."""

    def __init__(self, num_pages: int, *, host_pages: int,
                 label: str = "kv"):
        super().__init__(num_pages, label=label)
        if host_pages < 1:
            raise ValueError(f"host tier needs >= 1 page, got {host_pages}")
        self.host_pages = int(host_pages)
        self._host_free: List[int] = list(range(self.host_pages))
        self._residency: Dict[int, str] = {}     # handle -> Residency
        self._spilled = 0
        self._refetched = 0

    @staticmethod
    def handle_slot(handle: int) -> int:
        """Arena slot index a (negative) host handle addresses."""
        return -int(handle) - 1

    # ---------------------------------------------------------- spills

    def spill_begin(self, n: int) -> List[int]:
        """Reserve up to `n` host slots; returns their handles at
        residency IN_FLIGHT (the payload is still moving). Returns
        fewer — possibly none — when the host tier is near capacity;
        the caller falls back to destructive eviction for the rest."""
        with self._lock:
            take = min(max(n, 0), len(self._host_free))
            handles = [-(self._host_free.pop() + 1) for _ in range(take)]
            for h in handles:
                self._residency[h] = Residency.IN_FLIGHT
            return handles

    def spill_commit(self, handle: int) -> None:
        """The payload landed in the host arena: IN_FLIGHT -> HOST."""
        with self._lock:
            if self._residency.get(handle) != Residency.IN_FLIGHT:
                raise ValueError(f"spill_commit of handle {handle} not "
                                 f"in flight")
            self._residency[handle] = Residency.HOST
            self._spilled += 1
            host_free = len(self._host_free)
        # ring event after the lock, same discipline as the base class
        _ring_record("spill", self.label, ("tier", handle), 1, host_free)

    # -------------------------------------------------------- refetches

    def refetch_begin(self, handle: int) -> None:
        """Pin a HOST handle for refetch: HOST -> IN_FLIGHT (a pinned
        handle can neither be refetched again nor dropped under it)."""
        with self._lock:
            if self._residency.get(handle) != Residency.HOST:
                raise ValueError(f"refetch_begin of handle {handle} not "
                                 f"host-resident")
            self._residency[handle] = Residency.IN_FLIGHT

    def refetch_commit(self, handle: int) -> None:
        """The payload is back on device: count it and free the slot."""
        with self._lock:
            self._refetched += 1
        self.host_drop(handle)
        with self._lock:
            host_free = len(self._host_free)
        _ring_record("refetch", self.label, ("tier", handle), 1,
                     host_free)

    def host_drop(self, handle: int) -> None:
        """Free a host slot (restore landed, spill failed, refetch
        failed, or the entry was evicted). Idempotent."""
        with self._lock:
            if self._residency.pop(handle, None) is not None:
                self._host_free.append(self.handle_slot(handle))

    def residency(self, handle: int) -> Optional[str]:
        """Residency of a host handle (None when unknown/dropped);
        non-negative ids are device pages and report DEVICE while
        allocated."""
        if handle >= 0:
            return Residency.DEVICE if self.refcount(handle) else None
        with self._lock:
            return self._residency.get(handle)

    def host_used(self) -> int:
        with self._lock:
            return self.host_pages - len(self._host_free)

    def stats(self) -> Dict:
        st = super().stats()
        with self._lock:
            st["host_pages_total"] = self.host_pages
            st["host_pages_used"] = self.host_pages - len(self._host_free)
            st["host_inflight"] = sum(
                1 for r in self._residency.values()
                if r == Residency.IN_FLIGHT)
            st["spilled_total"] = self._spilled
            st["refetched_total"] = self._refetched
        return st


class HostPageStore:
    """The host arena for spilled page payloads.

    ``template`` is a (nested tuple of) pool leaves with the *pool* shape
    ``[L, P, page_tokens, ...]`` (page axis 1) — tensors or anything with
    ``.shape`` and a torch or numpy ``.dtype``. One host buffer is
    allocated up front and carved into one arena ``(capacity, L,
    page_tokens, ...)`` per leaf, so a spill is a bounded copy into a
    fixed slot and the store's footprint is visible at construction,
    never a surprise mid-serve. ``pin=True`` page-locks the buffer (the
    engine asks for it when its pools live on a GPU); a pin that fails
    raises with the size asked for — the store never falls back to
    pageable memory, whose copies are synchronous."""

    def __init__(self, template, capacity: int, *, pin: bool = False):
        self.capacity = int(capacity)
        self._template = template
        specs, offset = [], 0
        for leaf in pool_leaves(template):
            shape = tuple(int(s) for s in leaf.shape)
            dtype = _torch_dtype(leaf.dtype)
            page_shape = shape[:1] + shape[2:]     # drop the page axis
            n = self.capacity * int(np.prod(page_shape)) * \
                torch.empty((), dtype=dtype).element_size()
            specs.append((offset, n, dtype, page_shape))
            offset += -(-n // _ARENA_ALIGN) * _ARENA_ALIGN
        try:
            self._buf = torch.empty(offset, dtype=torch.uint8,
                                    pin_memory=pin)
        except RuntimeError as e:
            raise RuntimeError(
                f"HostPageStore: could not allocate {offset} bytes of "
                f"{'pinned ' if pin else ''}host memory for {capacity} "
                f"KV pages: {e}") from e
        if pin and not self._buf.is_pinned():
            raise RuntimeError(f"HostPageStore: {offset} bytes of host "
                               f"memory came back unpinned")
        self.pinned = bool(pin)
        self._arenas = [
            self._buf[off:off + n].view(dtype).view(
                (self.capacity,) + page_shape)
            for off, n, dtype, page_shape in specs]

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self._arenas)

    def put(self, slot: int, chunk_leaves: Sequence, index: int) -> None:
        """Store page `index` of a gathered chunk (leaf list, each
        ``[L, W, page_tokens, ...]``) into arena slot `slot`. A device
        leaf is copied asynchronously on the caller's current stream
        (the arena is pinned): the caller orders and awaits the copy."""
        for arena, leaf in zip(self._arenas, chunk_leaves):
            arena[slot].copy_(leaf[:, index], non_blocking=True)

    def assemble(self, slots: Sequence[int], rung: int, device=None):
        """Page rows for `slots`, zero-padded to `rung` pages — the host
        half of a refetch. Returns a structure mirroring the template
        whose leaves are ``[L, rung, page_tokens, ...]`` on `device`
        (default the host); a device copy is asynchronous on the
        caller's current stream."""
        rows = []
        for arena in self._arenas:
            out = torch.empty((int(rung),) + tuple(arena.shape[1:]),
                              dtype=arena.dtype, device=device)
            if len(slots) < rung:
                out[len(slots):].zero_()
            for j, slot in enumerate(slots):
                out[j].copy_(arena[slot], non_blocking=True)
            rows.append(out.transpose(0, 1))       # page axis 1, a view
        return _unflatten(self._template, rows)


# ---------------------------------------------------- wire serialization
#
# The prefill/decode KV handoff ships gathered page chunks between
# processes over the serve wire protocol. Same leaf discipline as
# `HostPageStore`: a chunk is a (nested tuple of) ``[L, W, page_tokens,
# ...]`` leaves (page axis 1), possibly padded past the real page count.
# Serialization slices each leaf to the real count, records per-leaf
# dtype/shape metadata plus a per-page crc32 chained across leaves, and
# re-views int8 leaves as uint8 (the wire tensor codec carries no int8
# code); deserialization restores the dtypes and refuses any structural
# or checksum mismatch — a torn or mis-routed handoff must degrade to a
# re-prefill, never land garbage in a pool.

def _page_crc(leaves: Sequence[np.ndarray], index: int) -> int:
    c = 0
    for a in leaves:
        c = zlib.crc32(np.ascontiguousarray(a[:, index]).tobytes(), c)
    return c


def serialize_pages(chunk, count: int) -> Tuple[List[np.ndarray], Dict]:
    """Flatten a gathered page chunk into wire-safe arrays + metadata.

    Returns ``(arrays, meta)``: one contiguous numpy array per leaf,
    sliced to `count` real pages (int8 leaves ride as a uint8 view),
    and ``meta`` = ``{"n_pages", "leaves": [{"dtype", "shape"}, ...],
    "crcs": [per-page crc32]}`` — byte for byte what the JAX package
    makes of the same pages."""
    count = int(count)
    leaves = [np.ascontiguousarray(_to_numpy(x)[:, :count])
              for x in pool_leaves(chunk)]
    arrays, leaf_meta = [], []
    for a in leaves:
        leaf_meta.append({"dtype": str(a.dtype), "shape": list(a.shape)})
        arrays.append(a.view(np.uint8) if a.dtype == np.int8 else a)
    meta = {"n_pages": count,
            "leaves": leaf_meta,
            "crcs": [_page_crc(leaves, j) for j in range(count)]}
    return arrays, meta


def deserialize_pages(arrays: Sequence[np.ndarray],
                      meta: Dict) -> List[np.ndarray]:
    """Inverse of :func:`serialize_pages`: restore leaf dtypes from the
    metadata and validate every page's crc32 chain. Returns the per-leaf
    arrays (``[..., n_pages, ...]``, page axis 1). Raises ``ValueError``
    on any structural or checksum mismatch."""
    leaf_meta = meta.get("leaves") or []
    crcs = list(meta.get("crcs") or [])
    n = int(meta.get("n_pages") or 0)
    if len(arrays) != len(leaf_meta):
        raise ValueError(
            f"kv payload structure mismatch: {len(arrays)} arrays for "
            f"{len(leaf_meta)} leaf descriptors")
    if len(crcs) != n:
        raise ValueError(
            f"kv payload structure mismatch: {len(crcs)} checksums for "
            f"{n} pages")
    leaves = []
    for i, (a, lm) in enumerate(zip(arrays, leaf_meta)):
        dt = np.dtype(lm.get("dtype", ""))
        shape = tuple(int(s) for s in lm.get("shape") or ())
        a = np.asarray(a)
        if dt == np.int8 and a.dtype == np.uint8:
            a = a.view(np.int8)
        if a.dtype != dt or a.shape != shape:
            raise ValueError(
                f"kv payload structure mismatch: leaf {i} is "
                f"{a.dtype}{list(a.shape)}, descriptor says "
                f"{dt}{list(shape)}")
        if len(shape) < 2 or shape[1] != n:
            raise ValueError(
                f"kv payload structure mismatch: leaf {i} holds "
                f"{shape[1] if len(shape) > 1 else 0} pages, "
                f"metadata says {n}")
        leaves.append(a)
    for j in range(n):
        if _page_crc(leaves, j) != int(crcs[j]):
            raise ValueError(f"kv page {j} checksum mismatch")
    return leaves


class MigrationTicket:
    """Async handle on one migration batch. ``poll()`` is non-blocking
    ("pending" | "ok" | "failed"); ``rows`` carries the device page rows
    after a successful refetch, and ``event`` (on a GPU) the CUDA event
    their copies complete at — wait on it before reading ``rows``."""

    __slots__ = ("direction", "handles", "count", "rung", "chunk",
                 "rows", "error", "duration_s", "event", "_t0",
                 "_failed", "_done", "_on_done")

    def __init__(self, direction: str, handles: List[int], count: int,
                 rung: int = 0, chunk=None,
                 on_done: Optional[Callable] = None):
        self.direction = direction        # "out" (spill) | "in" (refetch)
        self.handles = handles
        self.count = count
        self.rung = rung
        self.chunk = chunk                # device chunk to land (spill)
        self.rows = None                  # device rows to write (refetch)
        self.error: Optional[BaseException] = None
        self.duration_s = 0.0
        self.event = None                 # copies-complete CUDA event
        self._t0 = 0.0                    # submission time
        self._failed = None               # the copies could not start
        self._done = threading.Event()
        self._on_done = on_done

    def poll(self) -> str:
        if not self._done.is_set():
            return "pending"
        return "failed" if self.error is not None else "ok"

    def wait(self, timeout: Optional[float] = None) -> str:
        self._done.wait(timeout)
        return self.poll()

    def _finish(self, error: Optional[BaseException] = None):
        self.error = error
        self.chunk = None                 # the copies are done: drop it
        self._done.set()
        if self._on_done is not None:
            try:
                self._on_done(self)
            except Exception:             # pragma: no cover - callback bug
                pass                      # must never kill the worker


class MigrationEngine:
    """Background host<->device page transport.

    Submission enqueues the batch's copies (asynchronous on the engine's
    own stream with a CUDA `device`, synchronous on the CPU) and never
    blocks on them; one daemon worker thread retires the batches from
    per-direction queues (spills first), `window` at a time in flight.
    The decode scheduler hands work off and keeps stepping, so a
    chaos-hung migration stalls only the streams waiting on those
    pages."""

    def __init__(self, store: HostPageStore, *, window: int = 2,
                 name: str = "kv-migrate",
                 wake: Optional[Callable[[], None]] = None, device=None):
        if window < 1:
            raise ValueError(f"in-flight window must be >= 1, got {window}")
        self._store = store
        self._window = int(window)
        self._wake = wake                 # poked after every retirement
        self._device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._stream = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" else None
        self._m = tier_metrics()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._out_q: deque = deque()      # spills (device -> host)
        self._in_q: deque = deque()       # refetches (host -> device)
        self._inflight = 0                # submitted - retired
        self._spill_s: deque = deque(maxlen=256)
        self._refetch_s: deque = deque(maxlen=256)
        self._totals = {"spill_pages": 0, "spill_seconds": 0.0,
                        "refetch_pages": 0, "refetch_seconds": 0.0}
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------ submission

    def spill(self, chunk, handles: List[int], count: int,
              on_done: Optional[Callable] = None) -> MigrationTicket:
        """Start a device->host spill. `chunk` is an already-gathered
        device snapshot of `count` pages (page axis 1 on every leaf);
        page j lands in `handles[j]`'s arena slot. On a GPU the copies
        are enqueued now on the engine's stream behind an event on the
        caller's current stream, so the gather that made `chunk` must be
        enqueued before this call. The caller may release the device
        pages right away — the ticket holds the snapshot until its copies
        complete."""
        t = MigrationTicket("out", list(handles), int(count),
                            chunk=chunk, on_done=on_done)
        self._submit(self._out_q, t)
        return t

    def refetch(self, handles: List[int], rung: int,
                on_done: Optional[Callable] = None) -> MigrationTicket:
        """Start a host->device refetch of `handles`, padded to `rung`
        pages. On success ``ticket.rows`` holds the device page rows
        (and ``ticket.event`` the event to wait on before reading them
        on another stream)."""
        t = MigrationTicket("in", list(handles), len(handles),
                            rung=int(rung), on_done=on_done)
        self._submit(self._in_q, t)
        return t

    def _submit(self, q: deque, t: MigrationTicket):
        with self._cond:
            if self._stop:
                raise RuntimeError("migration engine stopped")
        t._t0 = time.perf_counter()
        try:
            self._dispatch(t)
        except BaseException as exc:     # retired as a failed batch
            t._failed = exc
        with self._cond:
            q.append(t)
            self._inflight += 1
            self._m["inflight"].set(self._inflight)
            self._cond.notify_all()

    # ---------------------------------------------------------- worker

    def _next(self, block: bool) -> Optional[MigrationTicket]:
        with self._cond:
            while True:
                if self._out_q:            # spills first: a refetch of an
                    return self._out_q.popleft()   # in-flight spill must
                if self._in_q:                     # see its payload land
                    return self._in_q.popleft()
                if self._stop or not block:
                    return None
                self._cond.wait(timeout=0.1)

    def _loop(self):
        from ..testing import chaos

        inflight: deque = deque()          # (ticket, t0) dispatched
        while True:
            t = self._next(block=not inflight)
            if t is None and not inflight:
                if self._stop:
                    return
                continue
            if t is not None:
                try:
                    if t._failed is not None:
                        raise t._failed
                    chaos.maybe_fail(
                        "page.migrate",
                        detail=f"{t.direction}:{t.count}")
                except BaseException as exc:
                    self._retire_err(t, exc, t._t0)
                else:
                    inflight.append((t, t._t0))
            # retire the oldest once the window is full, or when the
            # queues are momentarily empty (nothing to overlap with)
            while inflight and (len(inflight) >= self._window
                                or not self._queued()):
                self._retire(*inflight.popleft())

    def _queued(self) -> bool:
        with self._lock:
            return bool(self._out_q or self._in_q)

    def _dispatch(self, t: MigrationTicket):
        """Enqueue the copies of a transfer in the submitting thread:
        asynchronous on the engine's stream on a GPU (a spill's behind
        the caller's current stream), synchronous on the CPU."""
        slots = [TieredPageAllocator.handle_slot(h) for h in t.handles]
        if self._stream is None:
            self._copy(t, slots)
            return
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self._device))
        with torch.cuda.device(self._device), \
                torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            self._copy(t, slots)
            t.event = torch.cuda.Event()
            t.event.record(self._stream)

    def _copy(self, t: MigrationTicket, slots: List[int]):
        if t.direction == "out":
            leaves = pool_leaves(t.chunk)
            for j, slot in enumerate(slots):
                self._store.put(slot, leaves, j)
        else:
            t.rows = self._store.assemble(slots, t.rung,
                                          device=self._device)

    def _retire(self, t: MigrationTicket, t0: float):
        """Block until the transfer's copies complete, finish the
        ticket."""
        try:
            if t.event is not None:
                t.event.synchronize()
            self._m["spills" if t.direction == "out"
                    else "refetches"].inc(t.count)
        except BaseException as exc:
            self._retire_err(t, exc, t0)
            return
        t.duration_s = time.perf_counter() - t0
        from ..observability.tracez import RING as _RING

        span = "page.spill" if t.direction == "out" else "page.refetch"
        _RING.complete(span, t0, time.perf_counter(),
                       {"pages": t.count})
        self._m["migration_seconds"].labels(
            direction=t.direction).observe(t.duration_s)
        key = "spill" if t.direction == "out" else "refetch"
        with self._lock:
            (self._spill_s if key == "spill"
             else self._refetch_s).append(t.duration_s)
            self._totals[key + "_pages"] += t.count
            self._totals[key + "_seconds"] += t.duration_s
        self._done(t, None)

    def _retire_err(self, t: MigrationTicket, exc: BaseException,
                    t0: float):
        if t.event is not None:
            try:             # copies already enqueued read the snapshot
                t.event.synchronize()
            except BaseException:    # pragma: no cover - device error
                pass
        t.duration_s = time.perf_counter() - t0
        self._done(t, exc)

    def _done(self, t: MigrationTicket, exc: Optional[BaseException]):
        with self._cond:
            self._inflight -= 1
            self._m["inflight"].set(self._inflight)
        t._finish(exc)
        if self._wake is not None:
            try:
                self._wake()
            except Exception:              # pragma: no cover
                pass

    # ------------------------------------------------------------ misc

    def stats(self) -> Dict:
        """The JAX engine's keys (window, inflight, arena bytes, p50/p95
        batch ms by direction) plus the port's running totals: pages
        moved and seconds spent by direction (``spill_pages``,
        ``spill_seconds``, ``refetch_pages``, ``refetch_seconds``)."""
        with self._lock:
            spill_s = sorted(self._spill_s)
            refetch_s = sorted(self._refetch_s)
            inflight = self._inflight
            totals = dict(self._totals)

        def _p(vals, q):
            if not vals:
                return 0.0
            return vals[min(len(vals) - 1, int(q * len(vals)))]
        return {
            "window": self._window,
            "inflight": inflight,
            "host_arena_bytes": self._store.nbytes(),
            "spill_p50_ms": round(_p(spill_s, 0.50) * 1e3, 3),
            "spill_p95_ms": round(_p(spill_s, 0.95) * 1e3, 3),
            "refetch_p50_ms": round(_p(refetch_s, 0.50) * 1e3, 3),
            "refetch_p95_ms": round(_p(refetch_s, 0.95) * 1e3, 3),
            **totals,
        }

    def stop(self, timeout: float = 30.0):
        """Drain queued work and join the worker. Idempotent."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
