"""Continuous-batching autoregressive decode engine over a paged KV cache.

Port of paddle_tpu's `inference/decode.py` `DecodeEngine` (one tenant):

  * the KV store is one device-resident page pool per K and V
    (`[layers, pages, page_tokens, heads, head_dim]`, fp32, or with
    ``kv_dtype="int8"`` the `quant.kv` pair of int8 codes and one fp32
    scale per (layer, page, row, head)) plus a per-sequence block table; `memory.page_allocator` hands out
    refcounted page ids. Admission allocates pages, eviction releases
    them — capacity growth is a longer block table, never a cache copy;
  * the compute core is `models.gpt`: a miss admission runs the fused
    prefill-into-pages, and `paged_step` advances EVERY active request
    one token, writing through the block table and attending through the
    hand-written CUDA kernels (`ops.kernels`: paged attention, fp32 or
    int8, and the int8-weight matmul of a quantized artifact);
  * batch and block-table width are padded to bucket rungs
    (`inference.batching`), so the step sees a small fixed set of shapes;
  * **prefix sharing**: a hash trie caches page-aligned prompt prefixes.
    A request with a cached head maps the cached pages (refcount++) and
    feeds only its tail through the batched decode step. A slot's first
    write into a shared page triggers copy-on-write;
  * pool exhaustion is a typed RESOURCE_EXHAUSTED on the victim stream
    (after LRU-evicting cold prefix-cache pages), never an engine crash;
  * sampling is host-side numpy (greedy, or temperature with optional
    top-k), with the JAX package's per-(seed, position) generator, so a
    seeded stream samples the same tokens in both packages;
  * **speculative decoding** (`SpecDecodeEngine`): a draft GPT with the
    same vocab rolls out up to k greedy tokens a tick over its own page
    pool (same page ids), the target scores them in one multi-token
    verify, and the committed token is always the target's own, so a
    stream is token for token the plain engine's;
  * **multi-tenant QoS**: every request carries a ``tenant`` (default
    ``"default"``) and an integer ``priority``. Admission is
    weighted-fair — each free slot goes to the quota-eligible tenant
    with the smallest weighted virtual time (tokens served / weight,
    PADDLE_TPU_TENANT_WEIGHTS) — and per-tenant token-rate quotas
    (PADDLE_TPU_TENANT_QUOTA) defer a tenant's queued requests, never
    drop them. Each tenant gets a weighted share of the pending queue; a
    flood past its share is shed (typed RESOURCE_EXHAUSTED) while other
    tenants still admit. When a strictly higher-priority request cannot
    be admitted, the lowest-priority active slot is *preempted to host*:
    its full pages are stashed in the prefix cache, its pages released,
    and it resumes later over ``prompt + generated`` (teacher-forced, so
    token-identical) on the same live `DecodeStream`;
  * **host-RAM KV tiering** (``host_pages=`` /
    PADDLE_TPU_DECODE_HOST_PAGES): a `memory.migration`
    `TieredPageAllocator` + `MigrationEngine` behind the pool. Under pool
    pressure cold trie-only pages *spill* to a pinned host arena (the
    trie entry swaps its page for a negative host handle) instead of
    being evicted; an admission whose prefix continues in the host tier
    parks on an async *refetch* (only that stream waits) and resumes as
    a device hit with the same bytes. The tier's copies run on the
    migration engine's own CUDA stream, ordered against the scheduler's
    stream by events (see `_tier_spill`, `_tier_restore`);
  * **prefill/decode KV handoff** (``handoff=`` /
    PADDLE_TPU_DECODE_HANDOFF): `export_kv` gathers and serializes a
    prompt's full pages (prefilling them first on a miss), `import_kv`
    validates the compat facts (page size, pool dtype, `kv_fingerprint`)
    and per-page crc32s, lands the pages and seeds the prefix trie, so
    the follow-up stream admits as a prefix hit. The payload is the JAX
    package's, so pages cross between the packages;
  * **metrics**: the JAX engine's ``paddle_tpu_decode_*`` families in
    `observability.metrics.REGISTRY` (tokens, steps, prefills, evictions,
    latency histograms, TTFT, the page pool, the prefix cache, the
    speculation counters, tenants, preemptions and quotas), the
    ``paddle_tpu_handoff_*`` and ``paddle_tpu_kv_tier_*`` families, which
    `inference.serve` exposes on ``/metrics``;
  * **the observability planes**, as in the JAX engine: request ids from
    `observability.spans.next_request_id` and a queue / prefill / decode
    `SpanRecorder` record per finished stream; tracez events for the
    tick phases (``decode.admit``, ``decode.cow``, ``decode.emit``,
    ``decode.sample``, ``decode.step``, the speculative ``decode.draft``
    / ``decode.verify`` / ``decode.accept``) and the handoff
    (``handoff.export`` / ``handoff.import``); every device entry point
    goes through the engine's `_timed` hook under the JAX package's label
    (``decode.prefill``, ``decode.pstep``, ``decode.pcow``,
    ``decode.pgather``, ``decode.ptier``, ``decode.dprefill``,
    ``decode.droll``, ``decode.dcow``, ``decode.verify``), which feeds
    profilez and an ``exec:<label>`` tracez span without adding a
    synchronization; the page pool registers with memz (owner rollups,
    the ghost-page audit over the engine's live stream ids) and an
    exhausted pool leaves an OOM forensic dump.

Unlike the JAX engine, whose pools are donated and functionally updated,
this engine updates its pools in place, and it runs eagerly (no AOT
cache). Only the scheduler thread touches the pools: tier copies run on
the migration worker against snapshots and staging buffers, and handoff
jobs are parked for the scheduler. Chaos sites (`testing.chaos`):
``decode.stream`` per token delivery, ``decode.page_alloc`` per page
allocation, ``decode.preempt`` per preemption, ``page.migrate`` per tier
migration batch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import framework, profiler  # noqa: F401  (JAX module surface)
from ..core import flags as _flags
from ..core import monitor  # noqa: F401  (JAX module surface)
from ..core.device import resolve_device
from ..memory.migration import (HostPageStore, MigrationEngine, Residency,
                                TieredPageAllocator, deserialize_pages,
                                pool_leaves, serialize_pages, tier_metrics)
from ..memory.page_allocator import (PageAllocator, PageExhausted,
                                     copy_page, gather_pages, write_pages)
from ..models.gpt import (GPTConfig, gpt_paged_decode_fns,
                          gpt_paged_prefill_fns, gpt_paged_rollout_fns,
                          gpt_paged_verify_fns, params_from_numpy)
from ..observability import counter, gauge, histogram
from ..observability import memz as _memz
from ..observability.profilez import PROFILER as _PROFILER
from ..observability.spans import SpanRecorder, next_request_id
from ..observability.tracez import RING as _RING
from ..quant.kv import kv_pool_zeros, validate_kv_dtype
from ..quant.ptq import is_quantized, quantize_params
from ..testing import chaos
from .batching import (_WARMUP_SIG_CAP, bucket_ladder, next_bucket,
                       tenant_quotas as _tenant_quotas,
                       tenant_weights as _tenant_weights)
from .errors import (ERR_FAILED_PRECONDITION, ERR_INVALID_ARGUMENT,
                     ERR_RESOURCE_EXHAUSTED, ERR_UNAVAILABLE,
                     TypedServeError)

DEFAULT_MAX_SLOTS = 8          # fallback when device memory stats are absent
DEFAULT_MAX_NEW_TOKENS = 64
HBM_FRACTION = 0.5             # share of free device memory slots may fill
DEFAULT_PAGE_TOKENS = 16       # mirrors PADDLE_TPU_DECODE_PAGE_TOKENS
ARTIFACT_FORMAT = "paddle_tpu.decode.v1"

# the token-bucket clock of the tenant quotas (tests replace it)
_quota_clock = time.monotonic

_METRICS = None


def _decode_metrics():
    """Register (idempotently) and return the paddle_tpu_decode_* families
    this engine keeps: the JAX engine's names, types, help strings and
    label names."""
    global _METRICS
    if _METRICS is None:
        _METRICS = {
            "tokens": counter(
                "paddle_tpu_decode_tokens_total",
                "Tokens sampled by the decode engine (prefill + steps)"),
            "steps": counter(
                "paddle_tpu_decode_steps_total",
                "Batched decode steps executed (one per token column)"),
            "prefills": counter(
                "paddle_tpu_decode_prefills_total",
                "Requests admitted through the prefill phase"),
            "evictions": counter(
                "paddle_tpu_decode_cache_evictions_total",
                "KV-cache slot evictions by reason",
                labelnames=("reason",)),
            "occupancy": gauge(
                "paddle_tpu_decode_slot_occupancy",
                "Active sequences / slot-pool capacity (0..1)"),
            "active": gauge(
                "paddle_tpu_decode_active_requests",
                "Sequences currently holding a KV slot"),
            "prefill_latency": histogram(
                "paddle_tpu_decode_prefill_latency_seconds",
                "Prefill execution latency per admitted request"),
            "step_latency": histogram(
                "paddle_tpu_decode_step_latency_seconds",
                "Batched decode-step execution latency"),
            "ttft": histogram(
                "paddle_tpu_decode_ttft_seconds",
                "Submit-to-first-token latency per request"),
            # paged KV pool
            "page_pool_size": gauge(
                "paddle_tpu_decode_page_pool_pages",
                "Allocatable KV pages in the decode page pool"),
            "page_in_use": gauge(
                "paddle_tpu_decode_page_in_use",
                "KV pages currently allocated (refcount >= 1)"),
            "page_shared": gauge(
                "paddle_tpu_decode_page_shared",
                "KV pages mapped by more than one owner (refcount > 1)"),
            "page_fragmentation": gauge(
                "paddle_tpu_decode_page_fragmentation",
                "Free-list fragmentation of the KV page pool (0..1)"),
            "page_allocs": counter(
                "paddle_tpu_decode_page_allocs_total",
                "KV pages handed out by the decode page allocator"),
            "page_alloc_failures": counter(
                "paddle_tpu_decode_page_alloc_failures_total",
                "Page allocations refused (pool exhausted or chaos)"),
            "cow": counter(
                "paddle_tpu_decode_page_cow_copies_total",
                "Copy-on-write page copies (first write into a shared "
                "page)"),
            # prefix cache
            "prefix_hits": counter(
                "paddle_tpu_decode_prefix_hits_total",
                "Admissions that mapped at least one cached prefix page"),
            "prefix_misses": counter(
                "paddle_tpu_decode_prefix_misses_total",
                "Admissions that found no cached prefix page"),
            "prefix_hit_tokens": counter(
                "paddle_tpu_decode_prefix_hit_tokens_total",
                "Prompt tokens served from cached prefix pages"),
            "prefix_lookup_tokens": counter(
                "paddle_tpu_decode_prefix_lookup_tokens_total",
                "Prompt tokens offered to prefix-cache lookup"),
            "prefix_cached_pages": gauge(
                "paddle_tpu_decode_prefix_cached_pages",
                "Pages pinned by the prefix-cache trie"),
            "prefix_evictions": counter(
                "paddle_tpu_decode_prefix_evictions_total",
                "Prefix-cache entries LRU-evicted under pool pressure"),
            # speculative decoding
            "spec_draft_steps": counter(
                "paddle_tpu_decode_spec_draft_steps_total",
                "Batched draft-model decode steps executed"),
            "spec_accepted": counter(
                "paddle_tpu_decode_spec_accepted_tokens_total",
                "Drafted tokens accepted by target verification"),
            "spec_rejected": counter(
                "paddle_tpu_decode_spec_rejected_tokens_total",
                "Drafted tokens rejected by target verification"),
            "spec_acceptance": gauge(
                "paddle_tpu_decode_spec_acceptance_rate",
                "Cumulative accepted/drafted token ratio (0..1)"),
            "page_rollback_released": counter(
                "paddle_tpu_decode_page_rollback_released_total",
                "Page references released by speculative rollback "
                "(pages stranded past the last accepted token)"),
            # multi-tenant QoS
            "tenant_tokens": counter(
                "paddle_tpu_tenant_decode_tokens_total",
                "Tokens sampled by the decode engine per tenant",
                labelnames=("tenant",)),
            "tenant_admissions": counter(
                "paddle_tpu_tenant_admissions_total",
                "Requests admitted into a decode slot per tenant "
                "(resumes after preemption count again)",
                labelnames=("tenant",)),
            "tenant_shed": counter(
                "paddle_tpu_tenant_shed_total",
                "Requests refused at decode admission because the "
                "tenant was past its weighted share of the pending "
                "queue (typed RESOURCE_EXHAUSTED)",
                labelnames=("tenant",)),
            "tenant_quota_deferred": counter(
                "paddle_tpu_tenant_quota_deferred_total",
                "Requests deferred in the pending queue because the "
                "tenant's token-rate quota bucket was empty "
                "(PADDLE_TPU_TENANT_QUOTA)",
                labelnames=("tenant",)),
            "preemptions": counter(
                "paddle_tpu_decode_preemptions_total",
                "Active decode slots evicted to host so a "
                "higher-priority request could run"),
            "preempt_resumes": counter(
                "paddle_tpu_decode_preempt_resumes_total",
                "Preempted requests re-admitted into a decode slot"),
            "preempted_tokens": counter(
                "paddle_tpu_decode_preempted_tokens_total",
                "Generated tokens stashed host-side at preemption "
                "(re-prefilled or prefix-cache-mapped at resume)"),
            "preempted_waiting": gauge(
                "paddle_tpu_decode_preempted_waiting",
                "Preempted requests currently parked host-side "
                "awaiting re-admission"),
            # quantized serving
            "kv_page_bytes": gauge(
                "paddle_tpu_decode_kv_page_bytes",
                "HBM bytes one K+V page occupies at the engine's pool "
                "dtype (int8 pools: payload + per-row scales)"),
            "kv_quantized": gauge(
                "paddle_tpu_decode_kv_quantized",
                "1 when the engine's KV page pool is int8, 0 for fp32"),
        }
    return _METRICS


_HANDOFF_METRICS = None


def _handoff_metrics():
    """Register (idempotently) and return the paddle_tpu_handoff_*
    family — the engine-side half of disaggregated prefill/decode
    serving, under the JAX engine's names."""
    global _HANDOFF_METRICS
    if _HANDOFF_METRICS is None:
        _HANDOFF_METRICS = {
            "exports": counter(
                "paddle_tpu_handoff_exports_total",
                "KV-page handoffs exported by a prefill worker"),
            "imports": counter(
                "paddle_tpu_handoff_imports_total",
                "KV-page handoffs landed by a decode worker"),
            "rejects": counter(
                "paddle_tpu_handoff_rejects_total",
                "KV handoffs the receiving engine refused, by reason "
                "(compat, structure, checksum, exhausted, disabled)",
                labelnames=("reason",)),
            "pages": counter(
                "paddle_tpu_handoff_pages_total",
                "KV pages moved by handoffs, by direction "
                "(export, import)", labelnames=("direction",)),
            "bytes": counter(
                "paddle_tpu_handoff_bytes_total",
                "Serialized KV payload bytes moved by handoffs, by "
                "direction (export, import)", labelnames=("direction",)),
            "latency": histogram(
                "paddle_tpu_handoff_seconds",
                "Engine-side handoff latency by stage (export = "
                "prefill-if-miss + gather + serialize, import = "
                "validate + scatter + trie insert)",
                labelnames=("stage",)),
        }
    return _HANDOFF_METRICS


def _jax_layout_spec(cfg: GPTConfig, params: Mapping) -> list:
    """(name, shape, dtype) of every parameter in the layout the JAX
    package holds this config's weights in: per block
    (``blocks.<i>.<rel>``) when ``cfg.scan_layers`` is False or the
    model has MoE blocks, else stacked (``blocks.<rel>`` with a leading
    [layers] axis) — the port's params are always per block."""
    def dtype_str(v):
        return str(v.dtype).replace("torch.", "") \
            if isinstance(v, torch.Tensor) else str(np.dtype(v.dtype))

    stacked = cfg.scan_layers if cfg.scan_layers is not None \
        else cfg.moe_experts == 0
    out, blocks = [], {}
    for k, v in params.items():
        parts = str(k).split(".", 2)
        if stacked and len(parts) == 3 and parts[0] == "blocks" \
                and parts[1].isdigit():
            blocks.setdefault(parts[2], []).append(v)
            continue
        out.append((str(k), list(v.shape), dtype_str(v)))
    for rel, vs in blocks.items():
        out.append((f"blocks.{rel}", [len(vs)] + list(vs[0].shape),
                    dtype_str(vs[0])))
    return out


def kv_fingerprint(cfg: GPTConfig, eps: float, params: Mapping) -> str:
    """16-hex-char identity of (config, eps, parameter names/shapes/
    dtypes). Two engines with equal fingerprints run the same forward
    over the same weights *layout*, so their KV pages are
    interchangeable — the model-identity leg of the KV-handoff compat
    contract. Weight VALUES are not hashed. The spec is the JAX
    package's, taken over the JAX layout of the weights
    (`_jax_layout_spec`), so a JAX engine and a port engine over the same
    weights agree and pages cross between them."""
    spec = json.dumps(
        {"config": dataclasses.asdict(cfg), "eps": float(eps),
         "params": sorted(tuple(e) for e in
                          _jax_layout_spec(cfg, params))},
        sort_keys=True)
    return hashlib.sha1(spec.encode()).hexdigest()[:16]


class _HandoffJob:
    """Pseudo-request for allocator accounting inside a KV handoff —
    `_alloc_pages` only reads `.id` (chaos detail, error messages) and
    `_owner_for` stamps its pages ``("handoff", id)``."""
    __slots__ = ("id",)

    def __init__(self):
        self.id = next_request_id()


def _tree_map(fn, pools):
    """Apply `fn` to every tensor of a (nested tuple of) pool(s)."""
    if isinstance(pools, tuple):
        return tuple(_tree_map(fn, p) for p in pools)
    return fn(pools)


def _trie_owner(digest: bytes) -> tuple:
    """Allocator owner tag for a prefix-trie node (short digest hex)."""
    return ("trie", digest.hex()[:12])


def _pool_bytes(pools) -> int:
    return sum(t.numel() * t.element_size() for t in pool_leaves(pools))


def _observe(label: str, t0: float, t1: float, block: float,
             donated: int):
    """One finished dispatch into tracez and profilez."""
    _RING.complete(f"exec:{label}", t0, t1 + block)
    _PROFILER.observe(label, t1 - t0, block, donated)


def _settle(pending: list, wait: bool = False) -> list:
    """Observe every dispatch of `pending` whose end event has completed
    (all of them, waiting, with `wait`); returns those still pending."""
    keep = []
    for item in pending:
        label, t0, t1, donated, start, end = item
        if wait:
            end.synchronize()
        elif not end.query():
            keep.append(item)
            continue
        _observe(label, t0, t1, start.elapsed_time(end) / 1e3, donated)
    return keep


def kv_slot_bytes(cfg: GPTConfig, capacity: Optional[int] = None) -> int:
    """Device bytes one sequence's full K+V panel occupies at `capacity`
    (the paged analog is `kv_page_bytes` x pages actually mapped)."""
    cap = capacity or cfg.max_seq_len
    return cfg.layers * 2 * cap * cfg.heads * cfg.head_dim * 4


def kv_page_bytes(cfg: GPTConfig, page_tokens: int,
                  kv_dtype: str = "float32") -> int:
    """Device bytes one K+V page occupies at the pool dtype. The int8 pool
    (quant/kv.py) pays 1 byte per element plus one fp32 scale per (token
    row, head) — 1 + 4/head_dim bytes/element vs 4 for fp32."""
    rows = cfg.layers * 2 * int(page_tokens) * cfg.heads
    if validate_kv_dtype(kv_dtype) == "int8":
        return rows * cfg.head_dim + rows * 4
    return rows * cfg.head_dim * 4


def default_slot_count(cfg: GPTConfig, device=None) -> int:
    """Size the slot pool from free device memory: how many full-capacity
    KV panels fit in `HBM_FRACTION` of the free bytes
    (`torch.cuda.mem_get_info`). A CPU device gets `DEFAULT_MAX_SLOTS`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return DEFAULT_MAX_SLOTS
    free, _ = torch.cuda.mem_get_info(dev)
    return max(1, min(int(free * HBM_FRACTION // kv_slot_bytes(cfg)), 256))


def kv_capacity_ladder(max_seq_len: int,
                       floor: Optional[int] = None) -> List[int]:
    """Powers of two (times the floor) from the floor up to — and
    including — max_seq_len. The floor defaults to the page size so
    every rung is a page-granular capacity."""
    lo = int(floor) if floor else DEFAULT_PAGE_TOKENS
    if max_seq_len <= lo:
        return [int(max_seq_len)]
    vals, v = [], lo
    while v < max_seq_len:
        vals.append(v)
        v *= 2
    vals.append(int(max_seq_len))
    return sorted(set(vals))


class DecodeStream:
    """Consumer handle for one request's token stream.

    Events arrive in order: zero or more ``("token", tok, eos)`` then
    exactly one ``("done", tokens)`` — or a `TypedServeError` raised out
    of `next_event` / `result` if the stream died (engine stop,
    per-request failure)."""

    def __init__(self, req_id: int, prompt: List[int]):
        self.request_id = req_id
        self.prompt = list(prompt)
        self.tokens: List[int] = []      # generated so far (mirror)
        self.spec_drafted = 0            # speculative-decode stats
        self.spec_accepted = 0           # (stay 0 on the plain engine)
        self.spec_k = 0                  # the slot's k after its last tick
        self._q: queue.Queue = queue.Queue()
        self._pending: deque = deque()   # consumer-side unbatch buffer
        self._closed = False             # producer-side latch

    # -- producer (engine thread) ------------------------------------
    def _push_token(self, tok: int, eos: bool):
        if not self._closed:
            self.tokens.append(int(tok))
            self._q.put(("token", int(tok), bool(eos)))

    def _push_tokens(self, toks: List[int], eos: bool):
        # One queue put for a burst of committed tokens (the speculative
        # engine lands several a tick); `eos` applies to the last token
        # only — commits stop at the first eos. Consumers still see one
        # event per token: `_unbatch` expands the burst on their side.
        if not self._closed:
            toks = [int(t) for t in toks]
            self.tokens.extend(toks)
            self._q.put(("tokens", toks, bool(eos)))

    def _push_done(self):
        if not self._closed:
            self._closed = True
            self._q.put(("done", list(self.tokens)))

    def _push_error(self, err: TypedServeError):
        if not self._closed:
            self._closed = True
            self._q.put(("error", err))

    # -- consumer ----------------------------------------------------
    def _unbatch(self, ev):
        if ev[0] == "tokens":
            toks, eos = ev[1], ev[2]
            last = len(toks) - 1
            for i, t in enumerate(toks):
                self._pending.append(("token", t, eos and i == last))
            return self._pending.popleft()
        return ev

    def next_event(self, timeout: Optional[float] = None):
        if self._pending:
            return self._pending.popleft()
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TypedServeError(
                ERR_UNAVAILABLE,
                f"decode stream {self.request_id}: no event within "
                f"{timeout}s") from None
        if ev[0] == "error":
            raise ev[1]
        return self._unbatch(ev)

    def poll(self):
        """Non-blocking `next_event`: the next pending event, or None when
        the queue is momentarily empty. Raises the stream's typed error
        like `next_event` if the stream died."""
        if self._pending:
            return self._pending.popleft()
        try:
            ev = self._q.get_nowait()
        except queue.Empty:
            return None
        if ev[0] == "error":
            raise ev[1]
        return self._unbatch(ev)

    def events(self, timeout: Optional[float] = None):
        """Yield ("token", tok, eos) events until done; raises on error."""
        while True:
            ev = self.next_event(timeout=timeout)
            if ev[0] == "done":
                return
            yield ev

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the stream completes; returns generated tokens."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            left = None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
            ev = self.next_event(timeout=left)
            if ev[0] == "done":
                return ev[1]


DEFAULT_TENANT = "default"


class _Req:
    __slots__ = ("id", "prompt", "max_new", "temperature", "top_k",
                 "eos_id", "seed", "stream", "cache_len", "last_tok",
                 "generated", "pages", "input_tail", "feeding",
                 "t_submit", "t_admit", "prefill_s", "tenant", "priority",
                 "preempts", "deferred")

    def __init__(self, prompt, max_new, temperature, top_k, eos_id,
                 seed=None, tenant=DEFAULT_TENANT, priority=0):
        self.id = next_request_id()
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.seed = seed         # per-stream sampling seed (None -> engine RNG)
        self.stream = DecodeStream(self.id, prompt)
        self.cache_len = 0
        self.last_tok = 0
        self.generated: List[int] = []
        self.pages: List[int] = []       # block table (page ids, in order)
        self.input_tail: deque = deque() # prompt tokens still to feed
        self.feeding = False             # consuming prompt via the step
        self.t_submit = time.monotonic()
        self.t_admit = 0.0
        self.prefill_s = 0.0
        self.tenant = tenant
        self.priority = priority         # higher wins; may preempt lower
        self.preempts = 0                # times evicted to host
        self.deferred = False            # quota deferral counted once


class _SpecReq(_Req):
    """_Req plus speculative-decode state: how far the draft pool has been
    written, the slot's adaptive speculation depth, and acceptance
    accounting for the adaptive-k policy."""
    __slots__ = ("draft_len", "spec_k", "accept_ema", "drafted",
                 "accepted")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.draft_len = 0       # draft-pool rows written (positions)
        self.spec_k = 1          # per-slot adaptive k (set at admission)
        self.accept_ema = 1.0    # EMA of per-tick acceptance rate
        self.drafted = 0
        self.accepted = 0


class _PrefixCache:
    """Hash trie of page-aligned prompt prefixes -> pool pages.

    Keys are a SHA-1 hash *chain* over full pages of prompt tokens —
    entry i's digest commits to pages 0..i, so one dict lookup per page
    walks the trie without storing token arrays. Every device-resident
    entry holds one allocator reference; `lookup` retains matched pages
    on the caller's behalf (so an entry evicted a microsecond later
    cannot free a page the caller is about to map).

    Eviction is **leaf-first LRU**: among evictable entries, ones with no
    live child go first (ordered by last-touch tick), and only when every
    candidate is mid-chain does the oldest interior entry go. Forced
    mid-chain removals bump the `orphaned` stat.

    With a `memory.migration.TieredPageAllocator` behind it, an entry's
    location may also be a negative **host handle**: the page content was
    spilled to the host tier. `lookup` stops at a spilled entry (the
    device chain ends there); the engine's tier path reads the
    continuation via `host_chain` and swaps locations back with
    `restore_entry` once the migration engine lands the pages. Single
    leaf lock, no device work or blocking calls under it; lock order is
    trie -> allocator everywhere."""

    def __init__(self, alloc: PageAllocator, page_tokens: int):
        self._alloc = alloc
        self._pt = int(page_tokens)
        self._lock = threading.Lock()
        # digest -> [loc, tick, parent_digest|None]; loc >= 0 is a
        # device page (one ref held), loc < 0 a host-tier handle
        self._entries: Dict[bytes, List] = {}
        self._kids: Dict[bytes, int] = {}     # digest -> live children
        self._tick = 0
        self._evictions = 0
        self._orphaned = 0

    def _digests(self, prompt: Sequence[int]) -> List[bytes]:
        h, out = b"", []
        for i in range(len(prompt) // self._pt):
            chunk = np.asarray(prompt[i * self._pt:(i + 1) * self._pt],
                               np.int64).tobytes()
            h = hashlib.sha1(h + chunk).digest()
            out.append(h)
        return out

    def _remove(self, d: bytes, ent: List):
        """Drop one entry (lock held): release its device ref or host
        slot, unlink from its parent, count stranded descendants."""
        del self._entries[d]
        parent = ent[2]
        if parent is not None and parent in self._kids:
            self._kids[parent] -= 1
            if self._kids[parent] <= 0:
                del self._kids[parent]
        self._orphaned += self._kids.pop(d, 0)
        if ent[0] >= 0:
            self._alloc.release(ent[0], owner=_trie_owner(d))
        else:
            self._alloc.host_drop(ent[0])

    def lookup(self, prompt: Sequence[int],
               owner: Optional[tuple] = None) -> Tuple[List[int], int]:
        """Longest *device-resident* cached page-aligned prefix of
        `prompt`. Returns (pages, hit_tokens); each returned page has
        been retained for the caller — attributed to `owner` — who owns
        releasing every one."""
        pages: List[int] = []
        with self._lock:
            self._tick += 1
            for d in self._digests(prompt):
                ent = self._entries.get(d)
                if ent is None or ent[0] < 0:
                    break
                self._alloc.retain(ent[0], owner=owner)
                ent[1] = self._tick
                pages.append(ent[0])
        return pages, len(pages) * self._pt

    def host_chain(self, prompt: Sequence[int],
                   start: int) -> List[Tuple[bytes, int]]:
        """The contiguous run of HOST-resident entries continuing the
        device hit (`start` = device pages matched). Returns
        [(digest, handle)]; an IN_FLIGHT or missing entry ends the run —
        the caller just gets a shorter refetch, which is always
        correct."""
        out: List[Tuple[bytes, int]] = []
        with self._lock:
            for d in self._digests(prompt)[max(start, 0):]:
                ent = self._entries.get(d)
                if ent is None or ent[0] >= 0:
                    break
                if self._alloc.residency(ent[0]) != Residency.HOST:
                    break
                out.append((d, ent[0]))
        return out

    def insert(self, prompt: Sequence[int], pages: Sequence[int]):
        """Cache `prompt`'s full pages (pages[i] holds prompt rows
        [i*pt, (i+1)*pt)); already-cached prefixes are left in place. A
        spilled (host) entry whose content is being re-inserted live is
        upgraded back to the device page — the host copy is redundant
        from that moment."""
        with self._lock:
            self._tick += 1
            prev = None
            for d, p in zip(self._digests(prompt), pages):
                ent = self._entries.get(d)
                if ent is None:
                    self._alloc.retain(p, owner=_trie_owner(d))
                    self._entries[d] = [int(p), self._tick, prev]
                    if prev is not None and prev in self._entries:
                        self._kids[prev] = self._kids.get(prev, 0) + 1
                elif ent[0] < 0 and \
                        self._alloc.residency(ent[0]) == Residency.HOST:
                    self._alloc.retain(p, owner=_trie_owner(d))
                    self._alloc.host_drop(ent[0])
                    ent[0] = int(p)
                    ent[1] = self._tick
                prev = d

    def _leaf_key(self, d: bytes, ent: List):
        return (1 if self._kids.get(d) else 0, ent[1])

    def evict(self, n: int) -> int:
        """Release up to `n` device-resident entries' pages, leaf-first
        LRU, re-deriving leaf status after every removal (so evicting a
        whole chain walks it tip-to-root instead of orphaning it)."""
        removed = 0
        with self._lock:
            while removed < max(n, 0):
                cands = [(d, e) for d, e in self._entries.items()
                         if e[0] >= 0]
                if not cands:
                    break
                d, e = min(cands, key=lambda x: self._leaf_key(*x))
                self._remove(d, e)
                removed += 1
            self._evictions += removed
        return removed

    # ------------------------------------------------- host-tier hooks

    def spill_victims(self, n: int) -> List[Tuple[bytes, int]]:
        """Up to `n` spillable entries, coldest leaves first: device-
        resident and trie-only (refcount 1 — nothing active maps the
        page, so its content is immutable and nobody stalls on it)."""
        with self._lock:
            cands = [(d, e) for d, e in self._entries.items()
                     if e[0] >= 0 and self._alloc.refcount(e[0]) == 1]
            cands.sort(key=lambda x: self._leaf_key(*x))
            return [(d, e[0]) for d, e in cands[:max(n, 0)]]

    def mark_spilled(self, d: bytes, page: int, handle: int) -> bool:
        """Swap an entry's location to its host handle and release the
        trie's device ref (this is what actually frees the page)."""
        with self._lock:
            ent = self._entries.get(d)
            if ent is None or ent[0] != page:
                return False
            ent[0] = int(handle)
            self._alloc.release(page, owner=_trie_owner(d))
            return True

    def restore_entry(self, d: bytes, handle: int, page: int) -> bool:
        """A refetch landed: point the entry back at a device page. The
        caller transfers its allocator reference to the trie. False if
        the entry moved on meanwhile (caller keeps the ref)."""
        with self._lock:
            ent = self._entries.get(d)
            if ent is None or ent[0] != handle:
                return False
            ent[0] = int(page)
            ent[1] = self._tick
            self._alloc.retag(page, ("tier", handle), _trie_owner(d))
            return True

    def drop_by_handle(self, handle: int) -> bool:
        """Remove the entry parked on `handle` (failed migration): the
        cached content is gone, the stream degrades to a re-prefill."""
        with self._lock:
            for d, ent in self._entries.items():
                if ent[0] == handle:
                    self._remove(d, ent)
                    return True
        return False

    def drop_host_lru(self, n: int) -> int:
        """Drop up to `n` coldest HOST-resident entries to make room in
        the host tier (never IN_FLIGHT ones — a migration owns those
        slots)."""
        dropped = 0
        with self._lock:
            cands = sorted(
                ((d, e) for d, e in self._entries.items()
                 if e[0] < 0
                 and self._alloc.residency(e[0]) == Residency.HOST),
                key=lambda x: x[1][1])
            for d, e in cands[:max(n, 0)]:
                self._remove(d, e)
                dropped += 1
        return dropped

    def clear(self):
        with self._lock:
            for d, ent in self._entries.items():
                if ent[0] >= 0:
                    self._alloc.release(ent[0], owner=_trie_owner(d))
                else:
                    self._alloc.host_drop(ent[0])
            self._entries.clear()
            self._kids.clear()

    def stats(self) -> Dict:
        with self._lock:
            host = sum(1 for e in self._entries.values() if e[0] < 0)
            return {"cached_pages": len(self._entries),
                    "host_entries": host,
                    "evictions": self._evictions,
                    "orphaned": self._orphaned}


class DecodeEngine:
    """Slot-pool continuous batcher over the paged incremental GPT
    forward: fixed device page pool + per-slot block tables, prefix
    sharing with copy-on-write, typed backpressure on exhaustion,
    weighted-fair multi-tenant admission with quotas and preemption, an
    optional host-RAM KV tier, and the prefill/decode KV handoff.

    Give it a `models.gpt.GPTDecoder` as `model`, or `cfg` plus `params`
    (the port's flat tensor dict: `models.gpt.params_from_numpy` carries
    the JAX package's weights across, int8 weights of a quantized artifact
    included, which stay int8). `kv_dtype` ("float32" or "int8", default
    PADDLE_TPU_DECODE_KV_DTYPE) picks the page pool. `tenant_weights` /
    `tenant_quota` take the ``tenant:value,...`` specs (default
    PADDLE_TPU_TENANT_WEIGHTS / PADDLE_TPU_TENANT_QUOTA), `preempt`
    defaults to PADDLE_TPU_DECODE_PREEMPT, `host_pages` (the host tier's
    capacity in pages, 0 = off) to PADDLE_TPU_DECODE_HOST_PAGES and
    `handoff` to PADDLE_TPU_DECODE_HANDOFF; either of the last two turns
    the prefix cache on. `device` defaults to cuda and raises without a
    GPU."""

    _req_cls = _Req       # SpecDecodeEngine swaps in _SpecReq

    def __init__(self, model=None, *, cfg: Optional[GPTConfig] = None,
                 params: Optional[Mapping] = None,
                 eps: Optional[float] = None,
                 max_slots: Optional[int] = None,
                 max_new_tokens: int = DEFAULT_MAX_NEW_TOKENS,
                 max_pending: Optional[int] = None,
                 page_tokens: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 tenant_weights=None, tenant_quota=None,
                 preempt: Optional[bool] = None,
                 kv_dtype: Optional[str] = None,
                 host_pages: Optional[int] = None,
                 handoff: Optional[bool] = None,
                 device=None):
        if model is not None:
            cfg = model.cfg
            params = model.params()
            eps = model.eps if eps is None else eps
        if cfg is None or params is None:
            raise ValueError("DecodeEngine needs a model or (cfg, params)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.eps = 1e-5 if eps is None else float(eps)
        # int8 weights (a quantized artifact) stay int8; the rest is fp32
        self.params = {k: v.to(self.device) if v.dtype == torch.int8
                       else v.to(self.device, torch.float32)
                       for k, v in params.items()}
        self.kv_dtype = validate_kv_dtype(
            kv_dtype if kv_dtype is not None
            else _flags.env_value("PADDLE_TPU_DECODE_KV_DTYPE"))
        self.max_new_tokens = int(max_new_tokens)
        self.max_slots = int(max_slots) if max_slots \
            else default_slot_count(cfg, device=self.device)
        self.max_pending = int(max_pending) if max_pending is not None \
            else 4 * self.max_slots
        self.page_tokens = int(
            page_tokens or _flags.env_value("PADDLE_TPU_DECODE_PAGE_TOKENS"))
        if self.page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, "
                             f"got {self.page_tokens}")
        self.batch_ladder = bucket_ladder(
            self.max_slots, env=_flags.env_value("PADDLE_TPU_DECODE_BUCKETS"))
        self.kv_ladder = kv_capacity_ladder(cfg.max_seq_len,
                                            floor=self.page_tokens)
        # block-table width rungs: pages needed to hold each kv rung
        self.page_ladder = sorted(
            {-(-r // self.page_tokens) for r in self.kv_ladder})
        self.pages_per_seq = -(-cfg.max_seq_len // self.page_tokens)
        # +1: page 0 is the reserved null/scratch page (table padding
        # and padded-batch writes land there, never on live data)
        self.num_pages = int(num_pages) if num_pages \
            else self.max_slots * self.pages_per_seq + 1
        hp = int(host_pages) if host_pages is not None \
            else int(_flags.env_value("PADDLE_TPU_DECODE_HOST_PAGES"))
        self.host_pages = max(hp, 0)
        self._alloc = TieredPageAllocator(self.num_pages,
                                          host_pages=self.host_pages) \
            if self.host_pages else PageAllocator(self.num_pages)
        self.handoff = bool(_flags.env_value("PADDLE_TPU_DECODE_HANDOFF")) \
            if handoff is None else bool(handoff)
        use_prefix = prefix_cache if prefix_cache is not None \
            else bool(_flags.env_value("PADDLE_TPU_DECODE_PREFIX_CACHE"))
        # tiering spills and refetches *through* the trie (its entries are
        # the spill candidates and the resume index) and a handoff import
        # lands as a trie entry, so either mode implies the prefix cache
        if self.host_pages or self.handoff:
            use_prefix = True
        self._prefix = _PrefixCache(self._alloc, self.page_tokens) \
            if use_prefix else None

        # the device entry points, each behind the dispatch hook under
        # the JAX engine's label. The port's prefill writes the prompt's
        # K/V straight into its pages, so it has no separate page write
        # ("decode.pwrite" in the JAX engine); tier restores and handoff
        # imports scatter through "decode.ptier", and the tier's spill
        # snapshot and the handoff export gather through "decode.pgather"
        # in both packages.
        self._dispatched: List = []      # GPU dispatches not yet settled
        self._donated: Dict[str, int] = {}   # label -> in-place pool bytes
        _, self._step = gpt_paged_decode_fns(
            cfg, eps=self.eps, page_tokens=self.page_tokens)
        self._paged_prefill = gpt_paged_prefill_fns(
            cfg, eps=self.eps, page_tokens=self.page_tokens)
        self._rng = np.random.default_rng(0)   # unseeded requests' draws

        self.fingerprint = kv_fingerprint(cfg, self.eps, self.params)
        self._hm = _handoff_metrics() if self.handoff else None
        self._handoff_counts = {"exports": 0, "imports": 0, "rejects": 0}

        self._pending: deque = deque()
        self._paused: deque = deque()    # preempted-to-host requests
        self._active: List[_Req] = []
        # multi-tenant QoS: fair-share weights, token-rate quota buckets,
        # weighted virtual time per tenant (tokens served / weight)
        self._weights = _tenant_weights(tenant_weights)
        self._quota = _tenant_quotas(tenant_quota)
        self._vtokens: Dict[str, float] = {}
        self._quota_tokens: Dict[str, float] = {}
        self._quota_ts = _quota_clock()
        self._preempt_on = bool(
            _flags.env_value("PADDLE_TPU_DECODE_PREEMPT")) \
            if preempt is None else bool(preempt)
        self._kpool = None           # [L, P, page_tokens, nh, D] (or the
                                     # int8 (data, scale) pair), lazy
        self._vpool = None
        # host tier (lazy with the pools): arena store + migration worker
        # + requests parked on an in-flight refetch
        self._store = None
        self._migrate: Optional[MigrationEngine] = None
        self._migrating: List = []   # [ticket, req, [(digest, handle)]]
        # KV-handoff jobs parked for the scheduler thread (only it touches
        # the pools); each entry is (closure, reply Queue(1))
        self._handoff_q: deque = deque()
        self._tm = tier_metrics() if self.host_pages else None
        self._last_b_rung = self.batch_ladder[0]
        self._last_w_rung = self.page_ladder[0]
        self._steps = 0
        self._tokens = 0
        self._step_s = 0.0
        self._counts = {"prefix_hits": 0, "prefix_misses": 0,
                        "prefix_hit_tokens": 0, "cow_copies": 0,
                        "prefills": 0, "preemptions": 0,
                        "preempt_resumes": 0}
        self._admissions: Dict[str, int] = {}
        # handoff job ids holding pages, and requests popped by _schedule
        # but not yet in _active (they hold pages during _admit): the
        # ghost-page audit must see both as live
        self._handoff_live: set = set()
        self._admitting: List = []
        self._m = _decode_metrics()
        self._m["kv_page_bytes"].set(
            kv_page_bytes(cfg, self.page_tokens, self.kv_dtype))
        self._m["kv_quantized"].set(1 if self.kv_dtype == "int8" else 0)
        self._spans = SpanRecorder(
            component="decode", metric="paddle_tpu_decode_span_seconds",
            help="Decode request stage latency (queue/prefill/decode)")
        self._stop = False
        self._cond = threading.Condition()
        # memory plane: /memz renders this pool's owner attribution, and
        # the context callback feeds the ghost-page audit the set of
        # stream ids still alive (registered after _cond exists —
        # _memz_context reads the queues under it)
        _memz.register_pool(self._alloc, context_fn=self._memz_context)
        self._thread = threading.Thread(
            target=self._loop, name="decode-scheduler", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ API

    def submit(self, prompt: Sequence[int], max_new_tokens=None,
               temperature: float = 0.0, top_k: int = 0,
               eos_id=None, seed=None, tenant=None,
               priority=None) -> DecodeStream:
        toks = [int(t) for t in np.asarray(prompt, dtype=np.int64).reshape(-1)]
        if not toks:
            raise TypedServeError(ERR_INVALID_ARGUMENT, "empty prompt")
        if any(t < 0 or t >= self.cfg.vocab_size for t in toks):
            raise TypedServeError(
                ERR_INVALID_ARGUMENT,
                f"prompt token out of range [0, {self.cfg.vocab_size})")
        if len(toks) >= self.cfg.max_seq_len:
            raise TypedServeError(
                ERR_INVALID_ARGUMENT,
                f"prompt length {len(toks)} leaves no room to generate "
                f"(max_seq_len={self.cfg.max_seq_len})")
        tenant = str(tenant).strip() if tenant else DEFAULT_TENANT
        req = self._req_cls(toks, int(max_new_tokens or self.max_new_tokens),
                            float(temperature), int(top_k),
                            None if eos_id is None else int(eos_id),
                            seed=None if seed is None else int(seed),
                            tenant=tenant,
                            priority=0 if priority is None else int(priority))
        with self._cond:
            if self._stop:
                raise TypedServeError(ERR_UNAVAILABLE,
                                      "decode engine stopped")
            # each tenant gets a weighted share of the pending queue, so
            # a flood tenant saturates its own share while others keep a
            # clear path to admission. A single tenant's share is the
            # whole queue; with several tenants queued the per-tenant
            # share IS the watermark, and 2x the watermark is the hard
            # backstop
            mine = sum(1 for r in self._pending if r.tenant == tenant)
            tset = {r.tenant for r in self._pending}
            tset.add(tenant)
            if len(tset) <= 1:
                share = self.max_pending
                over = len(self._pending) >= self.max_pending
            else:
                wsum = sum(self._weight(t) for t in tset)
                share = max(1, int(round(
                    self.max_pending * self._weight(tenant) / wsum)))
                over = (mine >= share
                        or len(self._pending) >= 2 * self.max_pending)
            if over:
                self._m["tenant_shed"].labels(tenant=tenant).inc()
                raise TypedServeError(
                    ERR_RESOURCE_EXHAUSTED,
                    f"decode queue full ({self.max_pending} pending): "
                    f"tenant {tenant!r} holds {mine} of its "
                    f"{share}-slot share")
            self._pending.append(req)
            self._cond.notify_all()
        return req.stream

    def _weight(self, tenant: str) -> float:
        return self._weights.get(tenant, self._weights["*"])

    def _quota_rate(self, tenant: str) -> float:
        return self._quota.get(tenant, self._quota["*"])

    def _pool_shape(self):
        L, nh, D = self.cfg.layers, self.cfg.heads, self.cfg.head_dim
        return (L, self.num_pages, self.page_tokens, nh, D)

    def _pools(self):
        """Every page pool a page id names a page in — the tier and the
        handoff move a page's whole footprint across these, in this
        order (the JAX engine's pytree order)."""
        return (self._kpool, self._vpool)

    def _make_pools(self):
        if self._kpool is None:
            self._kpool = kv_pool_zeros(self._pool_shape(), self.kv_dtype,
                                        self.device)
            self._vpool = kv_pool_zeros(self._pool_shape(), self.kv_dtype,
                                        self.device)

    def _donated_bytes(self) -> Dict[str, int]:
        """{label: bytes of the pool tensors that entry point updates in
        place}, fixed once the pools exist."""
        target = _pool_bytes((self._kpool, self._vpool))
        return {"decode.pstep": target, "decode.prefill": target,
                "decode.pcow": target,
                "decode.ptier": _pool_bytes(self._pools())}

    def _ensure_pool(self):
        if not self._donated:
            self._make_pools()
            self._donated = self._donated_bytes()
        if self.host_pages and self._migrate is None:
            # one host arena for the engine's life, pinned on a GPU
            self._store = HostPageStore(self._pools(), self.host_pages,
                                        pin=self.device.type == "cuda")
            self._migrate = MigrationEngine(
                self._store, window=2, name="kv-migrate",
                wake=self._tier_wake, device=self.device)

    def _tier_wake(self):
        """Migration-worker completion callback: poke the scheduler so
        `_tier_poll` runs promptly (no other lock is ever held here)."""
        with self._cond:
            self._cond.notify_all()

    def warmup(self, verbose: bool = False) -> int:
        """Allocate the pools (and the host arena of a tiered engine),
        build the kernels, and run the decode step once per (batch-rung x
        page-rung) signature (capped), with all-null block tables so
        every write lands in the null page. Call before submitting.
        Returns the number of signatures run."""
        self._ensure_pool()
        sigs = [(b, w) for b in self.batch_ladder for w in self.page_ladder]
        sigs = sigs[:_WARMUP_SIG_CAP]
        for b, w in sigs:
            z = torch.zeros(b, dtype=torch.int32)
            self._step(self.params, self._kpool, self._vpool,
                       torch.zeros((b, w), dtype=torch.int32), z, z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if verbose:
            print(f"DECODE WARMUP step_sigs={len(sigs)} "
                  f"page_rungs={self.page_ladder} "
                  f"batch_rungs={self.batch_ladder}", flush=True)
        return len(sigs)

    def stats(self) -> Dict:
        st = {
            "device": str(self.device),
            "active": len(self._active),
            "pending": len(self._pending),
            "paused": len(self._paused),
            "max_slots": self.max_slots,
            "steps": self._steps,
            "tokens": self._tokens,
            "step_seconds": self._step_s,
            # rung of the most recent step; the smallest formable rung
            # before the first one (never a bogus 0)
            "batch_rung": int(self._last_b_rung),
            "kv_rung": int(self._last_w_rung * self.page_tokens),
            "batch_ladder": list(self.batch_ladder),
            "kv_ladder": list(self.kv_ladder),
            "page_tokens": self.page_tokens,
            "kv_dtype": self.kv_dtype,
            "fingerprint": self.fingerprint,
            "kv_page_bytes": kv_page_bytes(self.cfg, self.page_tokens,
                                           self.kv_dtype),
            "pages": self._alloc.stats(),
            "cow_copies": self._counts["cow_copies"],
            "prefills": self._counts["prefills"],
            "preemptions": self._counts["preemptions"],
            "preempt_resumes": self._counts["preempt_resumes"],
            "tenants": {t: round(v, 4)
                        for t, v in sorted(dict(self._vtokens).items())},
            "tenant_admissions": dict(sorted(self._admissions.items())),
        }
        if self._prefix is not None:
            st["prefix_cache"] = dict(
                self._prefix.stats(),
                hits=self._counts["prefix_hits"],
                misses=self._counts["prefix_misses"],
                hit_tokens=self._counts["prefix_hit_tokens"])
        if self.handoff:
            st["handoff"] = dict(self._handoff_counts)
        if self.host_pages:
            ps = st["pages"]
            tier = {
                "host_pages_total": ps.get("host_pages_total",
                                           self.host_pages),
                "host_pages_used": ps.get("host_pages_used", 0),
                "spilled_total": ps.get("spilled_total", 0),
                "refetched_total": ps.get("refetched_total", 0),
                "parked_refetches": len(self._migrating),
            }
            if self._migrate is not None:
                tier.update(self._migrate.stats())
                tier["host_arena_pinned"] = self._store.pinned
            st["kv_tier"] = tier
        return st

    def stop(self):
        """Stop the scheduler and the migration worker; open streams —
        queued, active, preempted or parked on a refetch — get typed
        UNAVAILABLE, and parked handoff calls return it."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=30)
        if self._migrate is not None:
            self._migrate.stop()
        self._settle(wait=True)
        self._spans.close()
        leftovers = (list(self._active) + list(self._pending)
                     + list(self._paused)
                     + [item[1] for item in self._migrating])
        self._active, self._pending = [], deque()
        self._paused = deque()
        self._migrating = []
        while self._handoff_q:
            _, box = self._handoff_q.popleft()
            box.put(("err", TypedServeError(
                ERR_UNAVAILABLE, "decode engine stopped")))
        for req in leftovers:
            req.stream._push_error(TypedServeError(
                ERR_UNAVAILABLE, "decode engine stopped"))
            self._release_pages(req)
        if self._prefix is not None:
            self._prefix.clear()
        self._m["active"].set(0)
        self._m["occupancy"].set(0.0)

    # ------------------------------------------------------- scheduler

    def _loop(self):
        while True:
            with self._cond:
                while (not self._stop and not self._pending
                       and not self._paused and not self._active
                       and not self._migrating and not self._handoff_q):
                    if self._dispatched:
                        self._settle()
                    self._cond.wait(timeout=0.1)
                if self._stop:
                    return
                self._refill_quota()
                newly, victims = self._schedule()
                self._admitting = list(newly) + list(victims)
                if not newly and not victims and not self._active \
                        and not self._handoff_q:
                    # everything queued is quota-blocked (or parked on an
                    # in-flight refetch): wait for the bucket refill or
                    # the migration wake instead of spinning
                    self._cond.wait(timeout=0.02)
            admitting = list(newly)
            try:
                if self._handoff_q:
                    self._handoff_drain()
                if self._migrating:
                    self._tier_poll()
                for vic in victims:
                    self._preempt(vic)
                for req in newly:
                    if len(self._active) >= self.max_slots:
                        # a preemption was abandoned (chaos) and its
                        # candidate has no slot: requeue at the front
                        with self._cond:
                            (self._paused if req.preempts
                             else self._pending).appendleft(req)
                        admitting.remove(req)
                        continue
                    t_adm = time.perf_counter()
                    admitted = self._admit(req)
                    _RING.complete("decode.admit", t_adm,
                                   time.perf_counter(), {"req": req.id})
                    if admitted:
                        self._active.append(req)
                        self._admissions[req.tenant] = \
                            self._admissions.get(req.tenant, 0) + 1
                        self._m["tenant_admissions"].labels(
                            tenant=req.tenant).inc()
                        if req.preempts:
                            self._counts["preempt_resumes"] += 1
                            self._m["preempt_resumes"].inc()
                    admitting.remove(req)
                if self._admitting:
                    with self._cond:
                        self._admitting = []
                if newly or victims:
                    self._update_gauges()
                if self._active:
                    self._step_once()
            except Exception as exc:  # engine-level failure: fail the
                # batch (typed), free its pages, keep serving newcomers
                err = exc if isinstance(exc, TypedServeError) else \
                    TypedServeError(ERR_UNAVAILABLE,
                                    f"decode scheduler failure: {exc}")
                for req in self._active + admitting:
                    req.stream._push_error(err)
                    self._m["evictions"].labels(reason="error").inc()
                    self._release_pages(req)
                self._active = []
                with self._cond:
                    self._admitting = []
                self._update_gauges()

    # ------------------------------------------------- QoS scheduling

    def _schedule(self):
        """Pick this tick's admissions — and preemption victims — under
        `_cond`.

        Weighted fair queuing over tenants: a tenant's virtual time
        advances by tokens_served / weight, and each free slot goes to
        the quota-eligible tenant head with the smallest virtual time
        (preempted requests queue ahead of their tenant's fresh ones). A
        tenant whose quota bucket is in debt is skipped — its requests
        wait, they are never dropped. When no slot is free and preemption
        is enabled, a head with strictly higher priority than the
        lowest-priority active slot evicts it and takes the slot."""
        newly: List[_Req] = []
        victims: List[_Req] = []
        free = self.max_slots - len(self._active)
        preemptable = list(self._active)
        while True:
            heads: Dict[str, tuple] = {}
            for q in (self._paused, self._pending):
                for r in q:
                    heads.setdefault(r.tenant, (q, r))
            eligible: Dict[str, tuple] = {}
            for t, (q, r) in heads.items():
                if self._quota_ok(t):
                    eligible[t] = (q, r)
                elif not r.deferred:
                    r.deferred = True
                    self._m["tenant_quota_deferred"].labels(
                        tenant=t).inc()
            if not eligible:
                return newly, victims
            if free > 0:
                t = min(eligible,
                        key=lambda x: self._vtokens.get(x, 0.0))
                q, r = eligible[t]
                q.remove(r)
                free -= 1
            else:
                if not self._preempt_on or not preemptable:
                    return newly, victims
                # the highest-priority eligible head justifies evicting
                # the lowest-priority (most recently admitted) active slot
                # — and takes that slot itself, so a third tenant cannot
                # slip into the preempt-freed capacity
                t, (q, r) = max(eligible.items(),
                                key=lambda kv: kv[1][1].priority)
                vic = min(preemptable,
                          key=lambda a: (a.priority, -a.t_admit))
                if r.priority <= vic.priority:
                    return newly, victims
                q.remove(r)
                preemptable.remove(vic)
                victims.append(vic)
            newly.append(r)
            # an idle tenant re-entering service starts at the busy
            # tenants' floor, not at the ancient credit it banked
            floor = min((self._vtokens.get(a.tenant, 0.0)
                         for a in self._active), default=0.0)
            self._vtokens[r.tenant] = max(
                self._vtokens.get(r.tenant, 0.0), floor)

    def _preempt(self, req: _Req) -> bool:
        """Evict an active slot to host so a higher-priority request can
        run: stash resumable state, release every page, park the request
        in `_paused`. The live `DecodeStream` is untouched — the client
        just sees a pause. On chaos the preemption is abandoned and the
        victim keeps decoding."""
        try:
            chaos.maybe_fail("decode.preempt", detail=req.id)
        except Exception:
            return False
        self._preempt_stash(req)
        self._release_pages(req)
        req.cache_len = 0
        req.last_tok = 0
        req.input_tail = deque()
        req.feeding = False
        req.preempts += 1
        self._counts["preemptions"] += 1
        self._m["preemptions"].inc()
        self._m["preempted_tokens"].inc(len(req.generated))
        self._active = [r for r in self._active if r.id != req.id]
        with self._cond:
            self._paused.append(req)
        return True

    def _preempt_stash(self, req: _Req):
        """Keep a victim's FULL pages alive in the prefix cache, keyed by
        the tokens they hold, so a quick resume re-maps them (or, spilled,
        refetches them) instead of re-prefilling. The partial last page is
        excluded — its rows past the last page boundary were never
        written."""
        if self._prefix is None:
            return
        pt = self.page_tokens
        toks = (req.prompt + req.generated)[:req.cache_len]
        if len(toks) >= pt:
            self._prefix.insert(toks, req.pages[:len(toks) // pt])

    def _refill_quota(self):
        """Advance every tenant's token bucket by elapsed time on
        `_quota_clock` (rate tokens/s, burst = max(rate, 1)). Loop thread
        only."""
        now = _quota_clock()
        dt = now - self._quota_ts
        if dt <= 0:
            return
        self._quota_ts = now
        for t in list(self._quota_tokens):
            rate = self._quota_rate(t)
            if rate > 0:
                self._quota_tokens[t] = min(
                    self._quota_tokens[t] + dt * rate, max(rate, 1.0))

    def _quota_ok(self, tenant: str) -> bool:
        rate = self._quota_rate(tenant)
        if rate <= 0:
            return True
        if tenant not in self._quota_tokens:
            self._quota_tokens[tenant] = max(rate, 1.0)
        return self._quota_tokens[tenant] > 0.0

    def _note_token(self, req: _Req, n: int = 1):
        """Charge `n` sampled tokens to the request's tenant: advances its
        weighted virtual time and drains its quota bucket (which may go
        negative — the debt defers the tenant's next admission)."""
        t = req.tenant
        self._vtokens[t] = self._vtokens.get(t, 0.0) + n / self._weight(t)
        rate = self._quota_rate(t)
        if rate > 0:
            self._quota_tokens[t] = self._quota_tokens.get(
                t, max(rate, 1.0)) - n
        self._m["tenant_tokens"].labels(tenant=t).inc(n)

    # ---------------------------------------------------- page plumbing

    def _owner_for(self, req) -> tuple:
        """The owner tag stamped on pages `req` holds: handoff jobs own as
        ``("handoff", id)``, decode slots as ``("slot", id, tenant)``
        (SpecDecodeEngine retags its streams ``("draft", id)``)."""
        if isinstance(req, _HandoffJob):
            return ("handoff", req.id)
        return ("slot", req.id, getattr(req, "tenant", DEFAULT_TENANT))

    def _memz_context(self) -> Dict:
        """Engine context for /memz snapshots and OOM dumps: the ids of
        every stream legitimately holding pages (the ghost-page audit's
        live set) plus the ladder state that shapes allocations."""
        with self._cond:
            live = [r.id for r in self._active]
            live += [r.id for r in self._pending]
            live += [r.id for r in self._paused]
            live += [r.id for r in self._admitting]
            live += [item[1].id for item in self._migrating]
            live += list(self._handoff_live)
        return {"live_owner_ids": [str(i) for i in live],
                "kv_ladder": list(self.kv_ladder),
                "page_ladder": list(self.page_ladder),
                "page_tokens": self.page_tokens,
                "prefix_cache": self._prefix is not None}

    # the page entry points (each called through `_timed`)

    def _copy_pages(self, old: int, new: int):
        """Copy one page to another in the target pools (copy-on-write;
        data and scale of an int8 pool)."""
        for pool in (self._kpool, self._vpool):
            copy_page(pool, old, new)

    def _gather_pages(self, fn):
        """`fn` over every tensor of every pool: a snapshot of pages that
        shares no storage with the pools."""
        return _tree_map(fn, self._pools())

    def _write_pages(self, rows, ids: torch.Tensor):
        """Write page rows (one entry per pool of `_pools`) into pages
        `ids` of every pool, in place."""
        for pool, r in zip(self._pools(), rows):
            write_pages(pool, r, ids)

    def _timed(self, label: str, fn, *args):
        """``fn(*args)``, a device entry point, under the JAX engine's AOT
        label: the port's counterpart of the JAX `_ProfiledExecutable`
        wrapper, without its ``block_until_ready``.

        A call times its wall (the Python call: kernel launches are
        asynchronous on a GPU), and on a GPU records a pair of timing
        events around it on the current stream. Its *block* time — the
        call's span on the device's clock, its kernels plus any gaps
        while the device waits for the host's launches — is read from
        those events by `_settle`, which the scheduler calls where it
        already waits on that stream (the host read of the step's, the
        prefill's or the verify's logits, the handoff's serialized pages)
        or finds them done while idle; a dispatch whose events have not
        completed yet stays pending. So the hook adds no synchronization:
        events are recorded and queried, never waited on, until
        ``_settle(wait=True)`` at engine stop. On the CPU a call is
        synchronous, its block time is 0 and it is observed at once. Each
        settled dispatch lands one ``exec:<label>`` tracez span (from the
        call's start to its end plus its device time) and one
        `PROFILER.observe(label, wall, block, donated)`, where `donated`
        is the bytes of the pool tensors the call updates in place (the
        JAX engine donates those buffers; `_donated_bytes`)."""
        donated = self._donated.get(label, 0)
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = fn(*args)
            t1 = time.perf_counter()
            _observe(label, t0, t1, 0.0, donated)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = fn(*args)
        t1 = time.perf_counter()
        end.record()
        self._dispatched.append((label, t0, t1, donated, start, end))
        return out

    def _settle(self, wait: bool = False):
        """Observe the finished GPU dispatches (see `_timed`)."""
        if self._dispatched:
            self._dispatched = _settle(self._dispatched, wait)

    def _release_pages(self, req: _Req):
        """Drop the slot's reference on every page it maps (exactly one
        ref per block-table entry). Idempotent via the list reset."""
        owner = self._owner_for(req)
        pages, req.pages = req.pages, []
        for p in pages:
            self._alloc.release(p, owner=owner)
        self._update_gauges()

    def _alloc_pages(self, n: int, req, owner: Optional[tuple] = None
                     ) -> List[int]:
        """Allocate `n` pages for `req`: chaos site, then the pool, then —
        under pressure — spill cold prefix-cache pages to the host tier
        (a tiered engine) and LRU-evict what the tier could not take, and
        retry once. Failure is typed RESOURCE_EXHAUSTED for THIS request.
        `owner` overrides the request-derived tag (tier restores allocate
        on behalf of the tier, not the parked slot)."""
        owner = owner or self._owner_for(req)
        try:
            chaos.maybe_fail("decode.page_alloc", detail=req.id)
        except Exception as exc:
            self._m["page_alloc_failures"].inc()
            raise TypedServeError(
                ERR_RESOURCE_EXHAUSTED,
                f"decode request {req.id}: page allocation failed: "
                f"{exc}") from exc
        retried = False
        while True:
            try:
                pages = self._alloc.alloc(n, owner=owner)
                break
            except PageExhausted as exc:
                err = exc
            if not retried and self._prefix is not None:
                shortfall = max(n - self._alloc.free_count(), 1)
                # host tier first: spilling parks the content in host RAM
                # (a later resume is a page copy, not a re-prefill);
                # destructive LRU eviction only covers the rest
                freed = self._tier_spill(shortfall) \
                    if self._migrate is not None else 0
                evicted = 0
                if freed < shortfall:
                    evicted = self._prefix.evict(shortfall - freed)
                    if evicted:
                        self._m["prefix_evictions"].inc(evicted)
                if freed or evicted:
                    retried = True
                    continue
            self._m["page_alloc_failures"].inc()
            try:
                # the OOM forensic dump: who held every page when this
                # RESOURCE_EXHAUSTED fired (served at /memz?oom=1)
                _memz.capture_oom(self._alloc, owner=owner, requested=n,
                                  context=self._memz_context())
            except Exception:        # forensics must not mask the error
                pass
            raise TypedServeError(
                ERR_RESOURCE_EXHAUSTED,
                f"decode request {req.id}: KV page pool exhausted ({err})"
            ) from err
        self._m["page_allocs"].inc(n)
        return pages

    def _cow(self, req: _Req, slot: int):
        """First write into a shared page: copy it to a fresh page (data
        and scale of an int8 pool, every pool of the engine) and repoint
        this slot's block table (the other owners keep the original —
        that's the isolation)."""
        old = req.pages[slot]
        (new,) = self._alloc_pages(1, req)
        self._timed("decode.pcow", self._copy_pages, old, new)
        req.pages[slot] = new
        self._alloc.release(old, owner=self._owner_for(req))
        self._counts["cow_copies"] += 1
        self._m["cow"].inc()

    # ---------------------------------------------------- host KV tier
    #
    # All tier work below runs on the scheduler thread, the one thread
    # that touches the pools; the migration worker only ever sees
    # independent tensors (the gathered snapshot, the refetch's staging
    # buffer) plus allocator/trie bookkeeping behind their own leaf
    # locks. Requests that need a refetch are PARKED in `_migrating` —
    # their slot stays free for other streams, so a slow or chaos-hung
    # migration stalls only the touching stream.

    def _tier_spill(self, n: int) -> int:
        """Spill up to `n` cold trie-only pages to the host tier. Returns
        how many device pages were freed. The gather (a fresh snapshot,
        page-major so each page's copy to the arena is contiguous) is
        enqueued on the scheduler's stream BEFORE the trie refs drop, so
        any later write into a freed page is stream-ordered after the
        read; the migration worker's copies wait for the gather on an
        event, and the ticket holds the snapshot until they complete.
        The host handles turn HOST only then."""
        victims = self._prefix.spill_victims(n)
        if not victims:
            return 0
        handles = self._alloc.spill_begin(len(victims))
        if len(handles) < len(victims):
            # host tier full: age out its coldest entries and retry —
            # anything still short of `n` falls to destructive evict
            if self._prefix.drop_host_lru(len(victims) - len(handles)):
                handles += self._alloc.spill_begin(
                    len(victims) - len(handles))
        victims = victims[:len(handles)]
        if not victims:
            return 0
        ids = torch.tensor([p for _, p in victims], dtype=torch.long,
                           device=self.device)
        chunk = self._timed(
            "decode.pgather", self._gather_pages,
            lambda t: t.transpose(0, 1).index_select(0, ids)
            .transpose(0, 1))
        for (d, p), h in zip(victims, handles):
            self._prefix.mark_spilled(d, p, h)
        prefix, alloc = self._prefix, self._alloc

        def on_done(t):
            # migration-worker thread: pure bookkeeping. Failure drops
            # the trie entries — the content degrades to a re-prefill,
            # which is always token-identical, never wrong.
            for h in t.handles:
                try:
                    if t.error is not None:
                        raise ValueError
                    alloc.spill_commit(h)
                except ValueError:
                    prefix.drop_by_handle(h)
                    alloc.host_drop(h)

        self._migrate.spill(chunk, handles, len(victims), on_done=on_done)
        return len(victims)

    def _tier_fetch(self, req: _Req, chain) -> bool:
        """Launch an async refetch of `chain` ([(digest, handle)]) and park
        `req` until it lands. False when nothing could be pinned (the
        caller proceeds with its partial device hit)."""
        pinned = []
        for d, h in chain:
            try:
                self._alloc.refetch_begin(h)
            except ValueError:
                break
            pinned.append((d, h))
        if not pinned:
            return False
        t = self._migrate.refetch([h for _, h in pinned], rung=len(pinned))
        self._migrating.append([t, req, pinned])
        return True

    def _tier_poll(self):
        """Non-blocking sweep over parked refetches (scheduler thread,
        outside `_cond`): a landed ticket gets its pages written back into
        the pool and its request reinjected at the head of its queue; a
        failed one drops the spilled entries and the request degrades to
        the ordinary prefill path."""
        still, done = [], []
        for item in self._migrating:
            (done if item[0].poll() != "pending" else still).append(item)
        if not done:
            return
        self._migrating = still
        for t, req, pinned in done:
            ok = t.poll() == "ok" and self._tier_restore(t, req, pinned)
            if not ok:
                for d, h in pinned:
                    self._prefix.drop_by_handle(h)
                    self._alloc.host_drop(h)
            with self._cond:
                (self._paused if req.preempts
                 else self._pending).appendleft(req)
                self._cond.notify_all()
        self._update_gauges()

    def _tier_restore(self, t, req: _Req, pinned) -> bool:
        """Write a landed refetch into fresh pool pages and point the trie
        back at them; the request's next admission then sees a full device
        hit. On a GPU the scheduler's stream first waits on the ticket's
        copy event, and the staging rows are recorded on that stream so
        their memory is not reused before the write has read them. False
        on allocation pressure — the entries drop and the request
        re-prefills instead."""
        try:
            # the tier (not the parked slot) owns these pages until
            # restore_entry retags each one to its trie node
            pages = self._alloc_pages(len(pinned), req,
                                      owner=("tier", req.id))
        except TypedServeError:
            return False
        ids = torch.tensor(pages, dtype=torch.long, device=self.device)
        if t.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(t.event)
            for leaf in pool_leaves(t.rows):
                leaf.record_stream(stream)
        self._timed("decode.ptier", self._write_pages, t.rows, ids)
        t.rows = None
        for (d, h), p in zip(pinned, pages):
            if self._prefix.restore_entry(d, h, p):
                self._alloc.refetch_commit(h)
            else:                 # entry moved on: keep nothing
                self._alloc.release(p, owner=("tier", req.id))
                self._alloc.host_drop(h)
        return True

    # ----------------------------------------- prefill/decode KV handoff
    #
    # Disaggregated serving: a prefill worker calls `export_kv` — run the
    # prompt forward if its full pages are not already cached, gather
    # them, serialize with per-page crc32 — and the payload travels to a
    # decode worker, whose `import_kv` validates compat, writes the pages
    # in and seeds the prefix trie so the follow-up decode stream admits
    # as an ordinary prefix hit. Both halves run ON THE SCHEDULER THREAD
    # via a parked-work queue the loop drains; the calling connection
    # thread waits on a one-slot reply box. Only the prompt's FULL pages
    # travel — the decode side re-feeds the tail and samples every token
    # itself, so a failed or refused handoff degrades to a plain
    # re-prefill.

    def kv_compat(self) -> Dict:
        """The engine-identity facts a KV handoff must match to land here
        (the compat contract)."""
        return {"page_tokens": self.page_tokens,
                "kv_dtype": self.kv_dtype,
                "fingerprint": self.fingerprint}

    def _handoff_call(self, fn, timeout: float):
        """Park `fn` for the scheduler thread; wait for its reply."""
        if not self.handoff:
            raise TypedServeError(
                ERR_FAILED_PRECONDITION,
                "KV handoff is disabled on this engine (enable with "
                "handoff= / PADDLE_TPU_DECODE_HANDOFF)")
        box: queue.Queue = queue.Queue(1)
        with self._cond:
            if self._stop:
                raise TypedServeError(ERR_UNAVAILABLE,
                                      "decode engine stopped")
            self._handoff_q.append((fn, box))
            self._cond.notify_all()
        try:
            status, val = box.get(timeout=timeout)
        except queue.Empty:
            raise TypedServeError(
                ERR_UNAVAILABLE,
                f"KV handoff did not complete within {timeout}s") \
                from None
        if status == "err":
            raise val
        return val

    def _handoff_drain(self):
        """Run parked handoff jobs (scheduler thread, outside `_cond`). A
        job's failure goes back through its reply box — it must never
        poison the active batch the way a step failure does."""
        while True:
            with self._cond:
                if not self._handoff_q:
                    return
                fn, box = self._handoff_q.popleft()
            try:
                box.put(("ok", fn()))
            except BaseException as exc:
                self._handoff_counts["rejects"] += 1
                box.put(("err", exc))

    def export_kv(self, prompt: Sequence[int],
                  timeout: float = 30.0) -> Dict:
        """Prefill-side half of a KV handoff: ensure the prompt's full
        pages exist (prefix-cache hit, else one prefill), snapshot and
        serialize them. Returns the wire payload — compat metadata, the
        prompt tokens, per-leaf page arrays (int8 as uint8 views) and
        per-page checksums. ``n_pages`` may be 0 for a sub-page prompt;
        the importer then seeds nothing and the decode worker
        re-prefills."""
        toks = [int(t)
                for t in np.asarray(prompt, np.int64).reshape(-1)]
        if not toks:
            raise TypedServeError(ERR_INVALID_ARGUMENT, "empty prompt")
        if any(t < 0 or t >= self.cfg.vocab_size for t in toks):
            raise TypedServeError(
                ERR_INVALID_ARGUMENT,
                f"prompt token out of range [0, {self.cfg.vocab_size})")
        if len(toks) >= self.cfg.max_seq_len:
            raise TypedServeError(
                ERR_INVALID_ARGUMENT,
                f"prompt length {len(toks)} exceeds "
                f"max_seq_len={self.cfg.max_seq_len}")
        return self._handoff_call(lambda: self._export_kv(toks), timeout)

    def import_kv(self, payload: Dict, timeout: float = 30.0) -> int:
        """Decode-side half of a KV handoff: validate the compat contract
        and the payload integrity, write the pages into the pool, and seed
        the prefix trie so the follow-up stream admits as a prefix hit.
        Returns the number of pages landed. Raises typed
        FAILED_PRECONDITION on any compat / structure / checksum mismatch
        — never a silent garbage admission."""
        return self._handoff_call(lambda: self._import_kv(payload),
                                  timeout)

    def _export_kv(self, toks: List[int]) -> Dict:
        t0 = time.perf_counter()
        n_full = len(toks) // self.page_tokens
        self._ensure_pool()
        payload = self.kv_compat()
        payload["prompt"] = list(toks)
        if n_full == 0:
            payload.update(n_pages=0, leaves=[], crcs=[], arrays=[])
        else:
            job = _HandoffJob()
            owner = self._owner_for(job)
            with self._cond:
                self._handoff_live.add(job.id)
            try:
                pages = self._handoff_pages(toks, n_full, job)
                try:
                    ids = torch.tensor(pages, dtype=torch.long)
                    chunk = self._timed(
                        "decode.pgather", self._gather_pages,
                        lambda t: gather_pages(t, ids))
                    arrays, meta = serialize_pages(chunk, n_full)
                    self._settle()       # serialize read the pages
                finally:
                    for p in pages:
                        self._alloc.release(p, owner=owner)
            finally:
                with self._cond:
                    self._handoff_live.discard(job.id)
            payload.update(meta)
            payload["arrays"] = arrays
        nbytes = sum(a.nbytes for a in payload["arrays"])
        self._handoff_counts["exports"] += 1
        self._hm["exports"].inc()
        self._hm["pages"].labels(direction="export").inc(n_full)
        self._hm["bytes"].labels(direction="export").inc(nbytes)
        self._hm["latency"].labels(stage="export").observe(
            time.perf_counter() - t0)
        _RING.complete("handoff.export", t0, time.perf_counter(),
                       {"pages": n_full, "bytes": nbytes})
        return payload

    def _handoff_pages(self, toks: List[int], n_full: int,
                       job: _HandoffJob) -> List[int]:
        """Device pages holding `toks`' first `n_full` full pages, one
        reference each held for the caller (attributed to `job`): the
        cached chain when the trie already covers them, else one prefill
        of those pages' tokens into fresh pages (which also seeds the
        trie — the next export of this prompt is a pure gather)."""
        pt = self.page_tokens
        owner = self._owner_for(job)
        hit_pages, _ = self._prefix.lookup(toks, owner=owner)
        if len(hit_pages) >= n_full:
            for p in hit_pages[n_full:]:
                self._alloc.release(p, owner=owner)
            return hit_pages[:n_full]
        for p in hit_pages:
            self._alloc.release(p, owner=owner)
        pages = self._alloc_pages(n_full, job)
        n = n_full * pt
        t0 = time.perf_counter()
        self._timed(
            "decode.prefill", self._paged_prefill,
            self.params, self._kpool, self._vpool,
            torch.tensor([toks[:n]], dtype=torch.long),
            torch.tensor([pages], dtype=torch.int32),
            torch.tensor([n], dtype=torch.long))
        self._counts["prefills"] += 1
        self._m["prefills"].inc()
        self._m["prefill_latency"].observe(time.perf_counter() - t0)
        self._prefix.insert(toks[:n], pages)
        return pages

    def _handoff_reject(self, reason: str, detail: str):
        self._hm["rejects"].labels(reason=reason).inc()
        raise TypedServeError(ERR_FAILED_PRECONDITION,
                              f"kv_handoff refused: {detail}")

    def _import_kv(self, payload: Dict) -> int:
        t0 = time.perf_counter()
        mine = self.kv_compat()
        for key in ("page_tokens", "kv_dtype", "fingerprint"):
            theirs = payload.get(key)
            if theirs != mine[key]:
                self._handoff_reject(
                    "compat",
                    f"{key} mismatch (sender {theirs!r}, receiver "
                    f"{mine[key]!r})")
        toks = [int(t) for t in payload.get("prompt") or []]
        n = int(payload.get("n_pages") or 0)
        pt = self.page_tokens
        if not toks or n != len(toks) // pt:
            self._handoff_reject(
                "structure",
                f"page count {n} does not cover prompt length "
                f"{len(toks)} at page_tokens={pt}")
        self._ensure_pool()
        if n > 0:
            self._import_pages(payload, toks, n)
        self._handoff_counts["imports"] += 1
        self._hm["imports"].inc()
        self._hm["pages"].labels(direction="import").inc(n)
        self._hm["bytes"].labels(direction="import").inc(
            sum(np.asarray(a).nbytes for a in payload.get("arrays") or []))
        self._hm["latency"].labels(stage="import").observe(
            time.perf_counter() - t0)
        _RING.complete("handoff.import", t0, time.perf_counter(),
                       {"pages": n})
        return n

    def _import_pages(self, payload: Dict, toks: List[int], n: int):
        try:
            leaves = deserialize_pages(
                payload.get("arrays") or [],
                {"n_pages": n, "leaves": payload.get("leaves"),
                 "crcs": payload.get("crcs")})
        except ValueError as e:
            self._handoff_reject(
                "checksum" if "checksum" in str(e) else "structure",
                str(e))
        # the payload's leaf structure must be THIS engine's pool
        # structure — a speculative engine's 4-pool footprint can never
        # land in a plain engine's 2-pool one, nor across draft shapes
        mine = pool_leaves(self._pools())
        if len(leaves) != len(mine):
            self._handoff_reject(
                "structure",
                f"pool structure mismatch ({len(leaves)} payload "
                f"leaves, engine has {len(mine)})")
        for i, (a, p) in enumerate(zip(leaves, mine)):
            want = (p.shape[0], n) + tuple(p.shape[2:])
            want_dt = str(p.dtype).replace("torch.", "")
            if tuple(a.shape) != want or str(a.dtype) != want_dt:
                self._handoff_reject(
                    "structure",
                    f"leaf {i} is {a.dtype}{list(a.shape)}, engine pool "
                    f"wants {want_dt}{list(want)}")
        job = _HandoffJob()
        with self._cond:
            self._handoff_live.add(job.id)
        try:
            self._land_pages(leaves, toks, n, job)
        finally:
            with self._cond:
                self._handoff_live.discard(job.id)

    def _land_pages(self, leaves, toks: List[int], n: int,
                    job: _HandoffJob):
        """Write validated handoff leaves into fresh pool pages and seed
        the trie; pages are attributed to `job` while held."""
        try:
            pages = self._alloc_pages(n, job)
        except TypedServeError:
            self._hm["rejects"].labels(reason="exhausted").inc()
            raise
        ids = torch.tensor(pages, dtype=torch.long, device=self.device)
        it = iter(torch.from_numpy(np.require(a, requirements=("C", "W")))
                  .to(self.device) for a in leaves)
        rows = [tuple(next(it) for _ in pool)
                if isinstance(pool, tuple) else next(it)
                for pool in self._pools()]
        self._timed("decode.ptier", self._write_pages, rows, ids)
        # the trie takes its own reference per inserted page; dropping
        # ours makes it the sole owner — imported pages age out (or spill
        # to the host tier) exactly like any cached prefix
        self._prefix.insert(toks[:n * self.page_tokens], pages)
        owner = self._owner_for(job)
        for p in pages:
            self._alloc.release(p, owner=owner)

    # ------------------------------------------------------- admission

    def _admit(self, req: _Req) -> bool:
        """Give the request KV pages and a first token source.

        Prefix hit: map the cached pages (refcount++), queue the uncached
        tail to be fed through the batched decode step — no prefill at
        all. A hit that continues in the host tier parks the request on
        an async refetch instead (False, no slot held). Miss: prefill the
        sequence straight into fresh pages, deliver the first sampled
        token immediately. True if the request now occupies a decode
        slot.

        A preempted request resumes through this same path over
        ``prompt + generated`` (for a fresh request that IS the prompt):
        replayed tokens are teacher-forced — prefix-mapped or prefilled,
        then tail-fed without sampling — and the per-(seed, position)
        RNG picks up sampling at the first unseen position, so the
        resumed stream is token-identical to an unpreempted run."""
        toks = req.prompt + req.generated
        plen = len(toks)
        pt = self.page_tokens
        self._ensure_pool()
        req.t_admit = time.monotonic()

        usable, hit_pages = 0, []
        owner = self._owner_for(req)
        if self._prefix is not None:
            hit_pages, hit_tokens = self._prefix.lookup(toks, owner=owner)
            self._m["prefix_lookup_tokens"].inc(plen)
            if self._migrate is not None:
                # the device hit may continue in the host tier (spilled
                # cold prefixes, a preempted stream's stashed pages): when
                # refetching would lengthen the usable prefix, park the
                # request on an async refetch instead of re-prefilling
                # content that already exists host-side
                chain = self._prefix.host_chain(toks, len(hit_pages))
                gain = min((len(hit_pages) + len(chain)) * pt, plen - 1)
                if chain and gain > min(hit_tokens, plen - 1) \
                        and self._tier_fetch(req, chain):
                    for p in hit_pages:
                        self._alloc.release(p, owner=owner)
                    return False     # parked in _migrating, no slot held
            # at least one prompt token is always re-fed so the step
            # has logits to sample the first generated token from
            usable = min(hit_tokens, plen - 1)
            n_map = min(len(hit_pages), -(-(usable + 1) // pt)) \
                if usable else 0
            for p in hit_pages[n_map:]:
                self._alloc.release(p, owner=owner)
            hit_pages = hit_pages[:n_map]
            self._counts["prefix_hits" if usable else "prefix_misses"] += 1
            self._counts["prefix_hit_tokens"] += usable
            self._m["prefix_hits" if usable else "prefix_misses"].inc()
            if usable:
                self._m["prefix_hit_tokens"].inc(usable)

        if usable:
            req.pages = hit_pages
            req.cache_len = usable
            req.last_tok = toks[usable]
            req.input_tail = deque(toks[usable + 1:])
            req.feeding = True
            return True

        # miss: prefill the whole sequence into freshly allocated pages
        try:
            pages = self._alloc_pages(-(-plen // pt), req)
        except TypedServeError as err:
            req.stream._push_error(err)
            self._m["evictions"].labels(reason="exhausted").inc()
            return False
        req.pages = pages
        t0 = time.perf_counter()
        logits, _, _ = self._timed(
            "decode.prefill", self._paged_prefill,
            self.params, self._kpool, self._vpool,
            torch.tensor([toks], dtype=torch.long),
            torch.tensor([pages], dtype=torch.int32),
            torch.tensor([plen], dtype=torch.long))
        row = logits[0].float().cpu().numpy()
        req.prefill_s = time.perf_counter() - t0
        self._settle()
        self._counts["prefills"] += 1
        self._m["prefills"].inc()
        self._m["prefill_latency"].observe(req.prefill_s)
        if not req.generated:        # resumes already saw a first token
            self._m["ttft"].observe(time.monotonic() - req.t_submit)
        try:
            chaos.maybe_fail("decode.stream", detail=req.id)
            tok = self._sample(row, req)
        except Exception as exc:
            req.stream._push_error(TypedServeError(
                ERR_UNAVAILABLE, f"decode stream killed: {exc}"))
            self._m["evictions"].labels(reason="error").inc()
            self._release_pages(req)
            return False
        req.cache_len = plen
        req.last_tok = tok
        req.generated.append(tok)
        self._tokens += 1
        self._m["tokens"].inc()
        self._note_token(req)
        if self._prefix is not None:
            self._prefix.insert(toks, pages[:plen // pt])
        eos = req.eos_id is not None and tok == req.eos_id
        req.stream._push_token(tok, eos)
        _RING.instant("decode.emit", {"req": req.id})
        if eos or len(req.generated) >= req.max_new \
                or req.cache_len >= self.cfg.max_seq_len:
            self._finish(req, "eos" if eos else "length")
            self._release_pages(req)
            return False
        return True

    # ------------------------------------------------------------ step

    def _step_once(self):
        t_tick = time.perf_counter()
        pt = self.page_tokens
        # provision the write target for row cache_len: a fresh page at
        # a page boundary, a copy-on-write if the target page is shared
        victims = []
        for req in self._active:
            slot = req.cache_len // pt
            try:
                if slot >= len(req.pages):
                    req.pages.extend(self._alloc_pages(1, req))
                elif self._alloc.refcount(req.pages[slot]) > 1:
                    t_cow = time.perf_counter()
                    self._cow(req, slot)
                    _RING.complete("decode.cow", t_cow,
                                   time.perf_counter(), {"req": req.id})
            except TypedServeError as err:
                req.stream._push_error(err)
                self._m["evictions"].labels(reason="exhausted").inc()
                self._release_pages(req)
                victims.append(req)
        if victims:
            dead = {r.id for r in victims}
            self._active = [r for r in self._active if r.id not in dead]
            self._update_gauges()
        reqs = self._active
        if not reqs:
            return
        b_rung = next_bucket(len(reqs), self.batch_ladder)
        w_rung = next_bucket(max(len(r.pages) for r in reqs),
                             self.page_ladder)
        tables = np.zeros((b_rung, w_rung), np.int32)   # pad -> null page
        ltok = np.zeros(b_rung, np.int64)
        clen = np.zeros(b_rung, np.int64)
        for j, req in enumerate(reqs):
            tables[j, :len(req.pages)] = req.pages
            ltok[j] = req.last_tok
            clen[j] = req.cache_len
        t0 = time.perf_counter()
        logits, _, _ = self._timed(
            "decode.pstep", self._step,
            self.params, self._kpool, self._vpool, torch.from_numpy(tables),
            torch.from_numpy(ltok), torch.from_numpy(clen))
        lognp = logits.float().cpu().numpy()
        dt = time.perf_counter() - t0
        self._settle()
        self._step_s += dt
        self._m["step_latency"].observe(dt)
        self._last_b_rung, self._last_w_rung = b_rung, w_rung
        self._steps += 1
        self._m["steps"].inc()
        t_sample = time.perf_counter()
        finished = []
        emitted = 0
        for j, req in enumerate(reqs):
            req.cache_len += 1
            if req.input_tail:           # still consuming prompt tail:
                req.last_tok = req.input_tail.popleft()
                continue                 # logits are mid-prompt, discard
            if req.feeding:
                # the step just consumed the final prompt token — its
                # pages now hold the whole prompt: cache them, and fall
                # through to sample this request's FIRST token
                req.feeding = False
                if self._prefix is not None:
                    self._prefix.insert(
                        req.prompt, req.pages[:len(req.prompt) // pt])
            first = not req.generated
            try:
                chaos.maybe_fail("decode.stream", detail=req.id)
                tok = self._sample(lognp[j], req)
            except Exception as exc:
                req.stream._push_error(TypedServeError(
                    ERR_UNAVAILABLE, f"decode stream killed: {exc}"))
                self._m["evictions"].labels(reason="error").inc()
                self._release_pages(req)
                finished.append(req)
                continue
            req.generated.append(tok)
            req.last_tok = tok
            emitted += 1
            self._note_token(req)
            if first:
                self._m["ttft"].observe(time.monotonic() - req.t_submit)
            eos = req.eos_id is not None and tok == req.eos_id
            req.stream._push_token(tok, eos)
            _RING.instant("decode.emit", {"req": req.id})
            if eos or len(req.generated) >= req.max_new \
                    or req.cache_len >= self.cfg.max_seq_len:
                self._finish(req, "eos" if eos else "length")
                self._release_pages(req)
                finished.append(req)
        self._tokens += emitted
        if emitted:
            self._m["tokens"].inc(emitted)
        now = time.perf_counter()
        _RING.complete("decode.sample", t_sample, now, {"reqs": len(reqs)})
        _RING.complete("decode.step", t_tick, now,
                       {"batch": len(reqs), "b_rung": b_rung,
                        "w_rung": w_rung})
        if finished:
            done = {r.id for r in finished}
            self._active = [r for r in reqs if r.id not in done]
            self._update_gauges()

    def _finish(self, req: _Req, reason: str):
        req.stream._push_done()
        self._m["evictions"].labels(reason=reason).inc()
        now = time.monotonic()
        self._spans.record(req.id, {
            "queue": req.t_admit - req.t_submit,
            "prefill": req.prefill_s,
            "decode": now - req.t_admit,
        }, extra={"tokens": len(req.generated),
                  "prompt_len": len(req.prompt)})

    def _dist(self, row: np.ndarray, req: _Req) -> np.ndarray:
        """The request's sampling distribution over the vocab (its
        temperature/top-k transform of one logit row)."""
        logits = row.astype(np.float64) / max(req.temperature, 1e-6)
        if 0 < req.top_k < logits.shape[0]:
            kth = np.partition(logits, -req.top_k)[-req.top_k]
            logits = np.where(logits >= kth, logits, -np.inf)
        logits -= logits.max()
        p = np.exp(logits)
        p /= p.sum()
        return p

    def _req_rng(self, req: _Req, pos: int):
        """Sampling generator for the token at absolute sequence
        position `pos`. Seeded streams draw from a counter-based RNG
        keyed on (seed, position) — the JAX package's generator, so a
        seeded stream samples draw-for-draw the same tokens in both
        packages, regardless of engine history or batch mates.
        Unseeded requests share the engine RNG."""
        if req.seed is None:
            return self._rng
        return np.random.default_rng((req.seed, pos))

    def _sample(self, row: np.ndarray, req: _Req, pos=None) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(row))
        p = self._dist(row, req)
        if pos is None:
            pos = len(req.prompt) + len(req.generated)
        return int(self._req_rng(req, pos).choice(p.shape[0], p=p))

    def _update_gauges(self):
        n = len(self._active)
        self._m["active"].set(n)
        self._m["occupancy"].set(n / max(self.max_slots, 1))
        self._m["preempted_waiting"].set(len(self._paused))
        ps = self._alloc.stats()
        self._m["page_pool_size"].set(ps["pages_total"])
        self._m["page_in_use"].set(ps["pages_used"])
        self._m["page_shared"].set(ps["pages_shared"])
        self._m["page_fragmentation"].set(ps["fragmentation"])
        if self._prefix is not None:
            self._m["prefix_cached_pages"].set(
                self._prefix.stats()["cached_pages"])
        if self._tm is not None:
            self._tm["resident"].labels(tier="device").set(
                ps["pages_used"])
            self._tm["resident"].labels(tier="host").set(
                ps.get("host_pages_used", 0))


# ------------------------------------------------- speculative decoding

def spec_k_ladder(k_max: int) -> List[int]:
    """Powers of two from 1 up to — and including — `k_max`: the adaptive
    speculation-depth rungs."""
    k_max = int(k_max)
    if k_max <= 1:
        return [1]
    vals, v = [], 1
    while v < k_max:
        vals.append(v)
        v *= 2
    vals.append(k_max)
    return sorted(set(vals))


class SpecDecodeEngine(DecodeEngine):
    """Draft-and-verify speculative decoding over the paged KV pool.

    A draft GPT (same vocab) runs up to k greedy steps per scheduler tick
    in one `gpt_paged_rollout_fns` call over its OWN page pool — same page
    shapes, same `PageAllocator`, same block tables, so one page id names
    one target page AND one draft page. The target then scores every
    drafted position in one `gpt_paged_verify_fns` call, which also writes
    their target K/V rows. Acceptance is sample-then-compare: the
    committed token at each position is the target's own (argmax, or the
    per-(seed, position) sampler over the verify logits) and a draft is
    accepted iff it guessed it, so a speculative stream is token for token
    the plain engine's, greedy and seeded. A rejection is host
    bookkeeping: truncate `cache_len` and drop the block table's stranded
    tail through `PageAllocator.release_range` (stale rows inside kept
    pages are masked by cache_len and overwritten next tick).

    Admission, prefix sharing, eviction, streaming and typed backpressure
    are inherited; copy-on-write copies BOTH pools. Per-slot adaptive k:
    each slot starts at `speculate_k` and walks the `spec_k_ladder` by an
    EMA of its acceptance (halved below 0.35, doubled above 0.8).

    Give the draft as `draft_model` (a training `models.gpt.GPT`, whose
    config, parameters through `framework.param_arrays` and final
    LayerNorm's epsilon are taken, as the JAX engine takes them) or as
    `draft_cfg` + `draft_params` (the port's flat tensor dict; int8
    weights stay int8); `speculate_k` defaults to
    PADDLE_TPU_DECODE_SPECULATE.

    QoS, tiering and the handoff are inherited and move the draft pools
    with the target's: the tier spills and restores, and a handoff
    exports and lands, all four pools of a page (a speculative payload
    lands only in a speculative engine of the same draft shape), and a
    preempted stream stashes its prompt-region pages with their draft
    rows (`_preempt_stash`), so a resumed or handed-off stream drafts
    warm."""

    _req_cls = _SpecReq

    def __init__(self, model=None, *, draft_model=None,
                 draft_cfg: Optional[GPTConfig] = None,
                 draft_params: Optional[Mapping] = None,
                 draft_eps: Optional[float] = None,
                 speculate_k: Optional[int] = None, **kw):
        if draft_model is not None:
            draft_cfg = draft_model.cfg
            draft_params = framework.param_arrays(draft_model)
            draft_eps = draft_model.ln_f._epsilon \
                if draft_eps is None else draft_eps
        if draft_cfg is None or draft_params is None:
            raise ValueError("SpecDecodeEngine needs a draft model or "
                             "(draft_cfg, draft_params)")
        k = int(speculate_k) if speculate_k is not None \
            else int(_flags.env_value("PADDLE_TPU_DECODE_SPECULATE"))
        if k < 1:
            raise ValueError(f"speculate_k must be >= 1, got {k}")
        # validate against the target BEFORE the scheduler thread starts
        tcfg = model.cfg if model is not None else kw.get("cfg")
        if tcfg is not None:
            if draft_cfg.vocab_size != tcfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target "
                    f"vocab {tcfg.vocab_size}")
            if draft_cfg.max_seq_len < tcfg.max_seq_len:
                raise ValueError(
                    f"draft max_seq_len {draft_cfg.max_seq_len} < target "
                    f"max_seq_len {tcfg.max_seq_len}")
        super().__init__(model, **kw)
        self.draft_cfg = draft_cfg
        self.draft_eps = 1e-5 if draft_eps is None else float(draft_eps)
        self._draft_params = {
            n: v.to(self.device) if v.dtype == torch.int8
            else v.to(self.device, torch.float32)
            for n, v in draft_params.items()}
        self.k_ladder = spec_k_ladder(k)
        self._dprefill = gpt_paged_prefill_fns(
            draft_cfg, eps=self.draft_eps, page_tokens=self.page_tokens)
        self._rollout = gpt_paged_rollout_fns(
            draft_cfg, eps=self.draft_eps, page_tokens=self.page_tokens)
        self._verify = gpt_paged_verify_fns(
            self.cfg, eps=self.eps, page_tokens=self.page_tokens)
        self._dkpool = None          # draft pools, lazy like the target's
        self._dvpool = None
        self._spec = {"drafted": 0, "accepted": 0, "draft_steps": 0,
                      "draft_prefills": 0, "rollback_released": 0,
                      "rollout_seconds": 0.0, "verify_seconds": 0.0}

    # ----------------------------------------------------- pool plumbing

    def _owner_for(self, req) -> tuple:
        """Speculative streams own their pages as ``("draft", id)``: one
        page id names a target AND a draft page. Handoff jobs keep the
        base tag."""
        if isinstance(req, _HandoffJob):
            return super()._owner_for(req)
        return ("draft", req.id)

    def _dpool_shape(self):
        c = self.draft_cfg
        return (c.layers, self.num_pages, self.page_tokens, c.heads,
                c.head_dim)

    def _make_pools(self):
        super()._make_pools()
        if self._dkpool is None:
            self._dkpool = kv_pool_zeros(self._dpool_shape(), self.kv_dtype,
                                         self.device)
            self._dvpool = kv_pool_zeros(self._dpool_shape(), self.kv_dtype,
                                         self.device)

    def _pools(self):
        """The tier and the handoff move a page in BOTH models' pools."""
        return (self._kpool, self._vpool, self._dkpool, self._dvpool)

    def _donated_bytes(self) -> Dict[str, int]:
        out = super()._donated_bytes()
        draft = _pool_bytes((self._dkpool, self._dvpool))
        out.update({"decode.dprefill": draft, "decode.droll": draft,
                    "decode.dcow": draft,
                    "decode.verify": out["decode.pstep"]})
        return out

    def _copy_draft_pages(self, old: int, new: int):
        for pool in (self._dkpool, self._dvpool):
            copy_page(pool, old, new)

    def _cow(self, req: _Req, slot: int):
        """Copy-on-write for speculation copies the page in BOTH models'
        pools — one page id names a target page and a draft page — as
        two entry points, "decode.pcow" and "decode.dcow"."""
        old = req.pages[slot]
        super()._cow(req, slot)
        self._timed("decode.dcow", self._copy_draft_pages, old,
                    req.pages[slot])

    # ---------------------------------------------------------- warmup

    def warmup(self, verbose: bool = False) -> int:
        """Base warmup plus the draft and verify surface, run eagerly with
        all-null block tables (every write lands in the null page): the
        draft prefill per prompt rung, and one rollout and one verify per
        k rung at the largest batch and page rungs. The port compiles
        nothing per shape, so that builds every kernel and grows the
        allocator to a tick's peak. Returns the signatures run."""
        n = super().warmup(verbose=False)
        pt = self.page_tokens
        for r in self.kv_ladder:
            self._dprefill(self._draft_params, self._dkpool, self._dvpool,
                           torch.zeros((1, r), dtype=torch.long),
                           torch.zeros((1, -(-r // pt)), dtype=torch.int32),
                           torch.tensor([r]))
        b, w = self.batch_ladder[-1], self.page_ladder[-1]
        tables = torch.zeros((b, w), dtype=torch.int32)
        z = torch.zeros(b, dtype=torch.long)
        for kk in self.k_ladder:
            self._rollout(self._draft_params, self._dkpool,
                          self._dvpool, tables,
                          torch.zeros((b, kk), dtype=torch.long), z)
            self._verify(self.params, self._kpool, self._vpool, tables,
                         torch.zeros((b, kk + 1), dtype=torch.long), z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        n += len(self.kv_ladder) + 2 * len(self.k_ladder)
        if verbose:
            print(f"SPEC DECODE WARMUP sigs={n} k_ladder={self.k_ladder}",
                  flush=True)
        return n

    # ------------------------------------------------------- admission

    def _admit(self, req: _Req) -> bool:
        req.spec_k = self.k_ladder[-1]      # start optimistic, adapt down
        if not super()._admit(req):
            return False
        if not req.feeding:
            # prefill miss: the target panel is in the pages; mirror the
            # prompt into the draft pool so drafting starts warm
            self._draft_prefill(req)
        # prefix hit: the mapped pages already carry the draft rows the
        # original (speculative) prefill wrote
        req.draft_len = req.cache_len
        return True

    def _draft_prefill(self, req: _Req):
        """One draft prefill-into-pages over the committed sequence, into
        the SAME page ids the target panel landed in (no COW check: the
        rows are committed K/V, which every mapper of a shared prefix page
        agrees on)."""
        seq = (req.prompt + req.generated)[:req.cache_len]
        n = -(-len(seq) // self.page_tokens)
        self._timed("decode.dprefill", self._dprefill, self._draft_params,
                    self._dkpool, self._dvpool,
                    torch.tensor([seq], dtype=torch.long),
                    torch.tensor([req.pages[:n]], dtype=torch.int32),
                    torch.tensor([len(seq)]))
        self._spec["draft_prefills"] += 1

    def _preempt_stash(self, req: _Req):
        """Stash only PROMPT-region pages at preemption. Generated-region
        pages may carry draft rows past the commit point (speculation in
        flight); a resume that prefix-mapped them would skip the draft
        re-prefill and let stale draft rows steer the draft chain. The
        resume re-drafts the generated region instead. Rows the draft
        catch-up has not reached yet (`draft_len` lagging `cache_len`)
        are excluded the same way."""
        if self._prefix is not None:
            full = min(req.cache_len, req.draft_len,
                       len(req.prompt)) // self.page_tokens
            if full:
                self._prefix.insert(req.prompt, req.pages[:full])
        req.draft_len = 0

    # ------------------------------------------------------------ tick

    def _step_once(self):
        t_tick = time.perf_counter()
        pt = self.page_tokens
        cap = self.cfg.max_seq_len
        tick_k = max(r.spec_k for r in self._active)
        K1 = tick_k + 1
        # 1. provision every page this tick can write: draft rows
        # [draft_len, draft_len+k) and verify rows [cache_len,
        # cache_len+k]; COW any shared page in that window (both pools)
        victims = []
        for req in self._active:
            lo = min(req.cache_len, req.draft_len) // pt
            hi_row = min(max(req.cache_len + tick_k,
                             req.draft_len + tick_k - 1), cap - 1)
            need = hi_row // pt + 1
            try:
                if need > len(req.pages):
                    req.pages.extend(
                        self._alloc_pages(need - len(req.pages), req))
                for s in range(lo, need):
                    if self._alloc.refcount(req.pages[s]) > 1:
                        t_cow = time.perf_counter()
                        self._cow(req, s)
                        _RING.complete("decode.cow", t_cow,
                                       time.perf_counter(),
                                       {"req": req.id})
            except TypedServeError as err:
                req.stream._push_error(err)
                self._m["evictions"].labels(reason="exhausted").inc()
                self._release_pages(req)
                victims.append(req)
        if victims:
            dead = {r.id for r in victims}
            self._active = [r for r in self._active if r.id not in dead]
            self._update_gauges()
        reqs = self._active
        if not reqs:
            return
        t_draft = time.perf_counter()
        b_rung = next_bucket(len(reqs), self.batch_ladder)
        w_rung = next_bucket(max(len(r.pages) for r in reqs),
                             self.page_ladder)
        tables = np.zeros((b_rung, w_rung), np.int32)   # pad -> null page
        for j, req in enumerate(reqs):
            tables[j, :len(req.pages)] = req.pages
        tables = torch.from_numpy(tables)
        # 2. draft: tick_k greedy steps in ONE rollout call. Step i
        # consumes a committed token the draft has not seen yet (catch-up,
        # via `forced`; its output is discarded) or the slot's own
        # previous draft (forced = -1)
        seqs = [req.prompt + req.generated for req in reqs]
        forced = np.zeros((b_rung, tick_k), np.int64)   # padded rows: 0
        dlen = np.zeros(b_rung, np.int64)
        for j, req in enumerate(reqs):
            dl, seq = req.draft_len, seqs[j]
            dlen[j] = dl
            for i in range(tick_k):
                forced[j, i] = seq[dl + i] if dl + i < len(seq) else -1
        t0 = time.perf_counter()
        drafts, _, _ = self._timed(
            "decode.droll", self._rollout,
            self._draft_params, self._dkpool, self._dvpool, tables,
            torch.from_numpy(forced), torch.from_numpy(dlen))
        dnp = drafts.cpu().numpy()
        t1 = time.perf_counter()
        self._settle()
        self._spec["rollout_seconds"] += t1 - t0
        self._spec["draft_steps"] += tick_k
        self._m["spec_draft_steps"].inc(tick_k)
        chains: List[List[int]] = [[] for _ in reqs]
        for j, req in enumerate(reqs):
            for i in range(tick_k):
                if req.draft_len >= len(seqs[j]) - 1:
                    chains[j].append(int(dnp[j, i]))
                req.draft_len += 1
        t_verify = time.perf_counter()
        _RING.complete("decode.draft", t_draft, t_verify, {"k": tick_k})
        # 3. verify: one multi-token target forward scores (and writes
        # the K/V of) up to K1 positions per slot — the un-consumed
        # committed tokens first, then this tick's drafts
        vtoks = np.zeros((b_rung, K1), np.int64)
        clen = np.zeros(b_rung, np.int64)
        meta = []
        for j, req in enumerate(reqs):
            known = seqs[j][req.cache_len:]
            n_known = min(len(known), K1, cap - req.cache_len)
            nd = min(len(chains[j]), req.spec_k, K1 - n_known)
            row = known[:n_known] + chains[j][:nd]
            vtoks[j, :len(row)] = row
            vtoks[j, len(row):] = row[-1]   # padding rows roll back
            clen[j] = req.cache_len
            meta.append((n_known, nd))
        t2 = time.perf_counter()
        logits, amax, _, _ = self._timed(
            "decode.verify", self._verify,
            self.params, self._kpool, self._vpool, tables,
            torch.from_numpy(vtoks), torch.from_numpy(clen))
        amaxnp = amax.cpu().numpy()
        dt = time.perf_counter() - t2
        self._settle()
        lognp = None   # full logits only cross to the host when sampling
        self._spec["verify_seconds"] += dt
        self._step_s += dt
        self._m["step_latency"].observe(dt)
        self._last_b_rung, self._last_w_rung = b_rung, w_rung
        self._steps += 1
        self._m["steps"].inc()
        t_accept = time.perf_counter()
        _RING.complete("decode.verify", t_verify, t_accept, {"k1": K1})
        # 4. acceptance + rollback, per slot on the host
        finished = []
        for j, req in enumerate(reqs):
            n_known, nd = meta[j]
            drafts_j = chains[j][:nd]
            seq_len_old = len(seqs[j])
            # the sequence fed is prompt + generated (a preempted stream
            # resumes over both)
            mid_prompt = req.feeding \
                and req.cache_len + n_known < seq_len_old
            if req.feeding and not mid_prompt:
                # the verify just consumed the last tail token: the pages
                # now hold the whole sequence
                req.feeding = False
                req.input_tail.clear()
                if self._prefix is not None:
                    self._prefix.insert(
                        req.prompt, req.pages[:len(req.prompt) // pt])
            # a verify that ends inside the prompt tail has scored no
            # output position yet: it commits its rows and emits nothing.
            # (The JAX engine emits a token here, ROADMAP queue 3.)
            emitted, a, i = [], 0, n_known - 1
            while not mid_prompt:
                # sample-then-compare: the committed token comes from the
                # target alone; a draft is accepted iff it guessed it
                if req.temperature <= 0.0:
                    tok = int(amaxnp[j, i])
                else:
                    if lognp is None:
                        lognp = logits.float().cpu().numpy()
                    pos = len(req.prompt) + len(req.generated) \
                        + len(emitted)
                    tok = self._sample(lognp[j, i], req, pos=pos)
                accept = a < nd and tok == drafts_j[a]
                emitted.append(tok)
                if accept:
                    a += 1
                    i += 1
                hit_eos = req.eos_id is not None and tok == req.eos_id
                if (not accept) or hit_eos \
                        or len(req.generated) + len(emitted) >= req.max_new \
                        or req.cache_len + n_known + a >= cap:
                    break
            new_c = req.cache_len + n_known + a
            # rollback: keep pages covering the committed rows and the
            # still-valid draft rows, release the stranded tail
            dl_valid = min(req.draft_len, seq_len_old + a)
            req.draft_len = dl_valid
            keep = -(-max(new_c, dl_valid) // pt)
            if keep < len(req.pages):
                released = self._alloc.release_range(
                    req.pages, keep, owner=self._owner_for(req))
                del req.pages[keep:]
                if released:
                    self._spec["rollback_released"] += released
                    self._m["page_rollback_released"].inc(released)
            req.cache_len = new_c
            if not emitted:
                continue
            req.last_tok = emitted[-1]
            # acceptance accounting + adaptive k
            req.drafted += nd
            req.accepted += a
            self._spec["drafted"] += nd
            self._spec["accepted"] += a
            if nd:
                self._m["spec_accepted"].inc(a)
                self._m["spec_rejected"].inc(nd - a)
                req.accept_ema = 0.5 * req.accept_ema + 0.5 * (a / nd)
                ki = self.k_ladder.index(req.spec_k)
                if req.accept_ema < 0.35 and ki > 0:
                    req.spec_k = self.k_ladder[ki - 1]
                elif req.accept_ema > 0.8 and ki < len(self.k_ladder) - 1:
                    req.spec_k = self.k_ladder[ki + 1]
            req.stream.spec_drafted = req.drafted
            req.stream.spec_accepted = req.accepted
            req.stream.spec_k = req.spec_k
            if self._spec["drafted"]:
                self._m["spec_acceptance"].set(
                    self._spec["accepted"] / self._spec["drafted"])
            # stream the newly committed tokens
            first = not req.generated
            try:
                chaos.maybe_fail("decode.stream", detail=req.id)
            except Exception as exc:
                req.stream._push_error(TypedServeError(
                    ERR_UNAVAILABLE, f"decode stream killed: {exc}"))
                self._m["evictions"].labels(reason="error").inc()
                self._release_pages(req)
                finished.append(req)
                continue
            req.generated.extend(emitted)
            self._tokens += len(emitted)
            self._m["tokens"].inc(len(emitted))
            self._note_token(req, len(emitted))
            done_eos = req.eos_id is not None and emitted[-1] == req.eos_id
            req.stream._push_tokens(emitted, done_eos)
            _RING.instant("decode.emit", {"req": req.id, "n": len(emitted)})
            if first:
                self._m["ttft"].observe(time.monotonic() - req.t_submit)
            if done_eos or len(req.generated) >= req.max_new \
                    or req.cache_len >= cap:
                self._finish(req, "eos" if done_eos else "length")
                self._release_pages(req)
                finished.append(req)
        now = time.perf_counter()
        _RING.complete("decode.accept", t_accept, now, {"reqs": len(reqs)})
        _RING.complete("decode.step", t_tick, now,
                       {"batch": len(reqs), "k": tick_k})
        if finished:
            done = {r.id for r in finished}
            self._active = [r for r in reqs if r.id not in done]
            self._update_gauges()

    def stats(self) -> Dict:
        """The base stats plus ``speculate``: the k ladder, drafted and
        accepted totals and their ratio (as in JAX), and the port's draft
        steps and prefills (the rollout and draft-prefill calls' launch
        counts follow from them), rollback-released page references, and
        the host seconds spent in rollout and verify calls (a verify is
        this engine's step: `step_seconds` counts verify calls only)."""
        st = super().stats()
        sp = dict(self._spec)
        drafted = sp["drafted"]
        st["speculate"] = dict(
            sp, k_max=self.k_ladder[-1], k_ladder=list(self.k_ladder),
            acceptance_rate=round(sp["accepted"] / drafted, 4)
            if drafted else 0.0)
        return st


# ------------------------------------------------------------ artifact

def save_for_decode(params_np: Mapping, cfg: GPTConfig, eps: float,
                    prefix: str, quant: Optional[str] = None):
    """Persist weights for the decode daemon in the JAX package's
    ``paddle_tpu.decode.v1`` format: ``<prefix>.decode.json`` (config,
    eps) + ``<prefix>.decode.npz`` (params, either layout). Artifacts
    written by either package load in both.

    ``quant="int8"`` applies `quant.ptq.quantize_params` before writing
    (int8 weights under their own keys plus fp32 ``::scale`` siblings;
    params that already carry them are written as they are) and records
    ``"quant": "int8"`` in the manifest, as the JAX package does. The
    default fp32 artifact has no ``quant`` key."""
    meta = {"config": dataclasses.asdict(cfg), "eps": float(eps),
            "format": ARTIFACT_FORMAT}
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in params_np.items()}
    if quant is not None:
        if quant != "int8":
            raise ValueError(f"quant={quant!r}: expected None or 'int8'")
        if not is_quantized(arrays):
            arrays = quantize_params(arrays)
        meta["quant"] = "int8"
    elif is_quantized(arrays):
        raise ValueError("params carry ::scale keys: pass quant='int8'")
    with open(prefix + ".decode.json", "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    np.savez(prefix + ".decode.npz", **arrays)


def _load_decode_artifact(prefix: str):
    with open(prefix + ".decode.json") as f:
        meta = json.load(f)
    if meta.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"{prefix}.decode.json: not a decode artifact")
    quant = meta.get("quant")
    if quant not in (None, "int8"):
        raise ValueError(f"{prefix}: quant={quant!r}: expected none or "
                         f"'int8'")
    cfg = GPTConfig(**meta["config"])
    with np.load(prefix + ".decode.npz") as z:
        params = {k: z[k] for k in z.files}
    if (quant == "int8") != is_quantized(params):
        raise ValueError(f"{prefix}: manifest quant={quant!r} but the "
                         f"weights {'do not ' if quant else ''}carry "
                         f"::scale keys")
    return cfg, params, meta.get("eps")


def load_for_decode(prefix: str, device=None,
                    draft_prefix: Optional[str] = None,
                    speculate_k: Optional[int] = None,
                    draft_quant: Optional[bool] = None,
                    **engine_kw) -> DecodeEngine:
    """Load a `save_for_decode` artifact (from either package, fp32 or
    ``quant="int8"``) into a ready engine on `device` (default cuda);
    `engine_kw` goes to the engine (``kv_dtype=``, slots, ...).

    With a draft artifact (`draft_prefix`, or
    PADDLE_TPU_DECODE_DRAFT_MODEL) and a speculation depth (`speculate_k`,
    or PADDLE_TPU_DECODE_SPECULATE >= 1) the result is a
    `SpecDecodeEngine`; otherwise the plain engine — speculation is
    opt-in. `draft_quant` (or PADDLE_TPU_DECODE_DRAFT_QUANT) int8-quantizes
    a still-fp32 draft at load (`quant.ptq.quantize_params`); draft
    numerics move only the acceptance rate, never the target's tokens."""
    dev = resolve_device(device)
    cfg, params, eps = _load_decode_artifact(prefix)
    if draft_prefix is None:
        draft_prefix = _flags.env_value(
            "PADDLE_TPU_DECODE_DRAFT_MODEL") or None
    if speculate_k is None:
        speculate_k = int(_flags.env_value("PADDLE_TPU_DECODE_SPECULATE"))
    if draft_quant is None:
        draft_quant = bool(
            _flags.env_value("PADDLE_TPU_DECODE_DRAFT_QUANT"))
    params = params_from_numpy(cfg, params, dev)
    if draft_prefix and int(speculate_k) >= 1:
        dcfg, dparams, deps = _load_decode_artifact(draft_prefix)
        if draft_quant and not is_quantized(dparams):
            dparams = quantize_params(dparams)
        return SpecDecodeEngine(
            cfg=cfg, params=params, eps=eps, draft_cfg=dcfg,
            draft_params=params_from_numpy(dcfg, dparams, dev),
            draft_eps=deps, speculate_k=int(speculate_k), device=dev,
            **engine_kw)
    return DecodeEngine(cfg=cfg, params=params, eps=eps, device=dev,
                        **engine_kw)


__all__ = ["DecodeEngine", "SpecDecodeEngine", "DecodeStream",
           "spec_k_ladder", "kv_slot_bytes", "kv_page_bytes",
           "kv_fingerprint",
           "kv_capacity_ladder", "default_slot_count", "save_for_decode",
           "load_for_decode"]
