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
  * **metrics**: the JAX engine's ``paddle_tpu_decode_*`` families in
    `observability.metrics.REGISTRY` (tokens, steps, prefills, evictions,
    latency histograms, TTFT, the page pool, the prefix cache, the
    speculation counters), which `inference.serve` exposes on
    ``/metrics``.

Unlike the JAX engine, whose pools are donated and functionally updated,
this engine updates its pools in place, and it runs eagerly (no AOT
cache). Admission is single-tenant FIFO: the JAX engine's weighted-fair
QoS, quotas and preemption (and their metric families), host-RAM
tiering, KV handoff, spans and memz are later slices of the port.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import framework
from ..core import flags as _flags
from ..core.device import resolve_device
from ..memory.page_allocator import PageAllocator, PageExhausted, copy_page
from ..models.gpt import (GPTConfig, gpt_paged_decode_fns,
                          gpt_paged_prefill_fns, gpt_paged_rollout_fns,
                          gpt_paged_verify_fns, params_from_numpy)
from ..observability import counter, gauge, histogram
from ..quant.kv import kv_pool_zeros, validate_kv_dtype
from ..quant.ptq import is_quantized, quantize_params
from .batching import _WARMUP_SIG_CAP, bucket_ladder, next_bucket
from .errors import (ERR_INVALID_ARGUMENT, ERR_RESOURCE_EXHAUSTED,
                     ERR_UNAVAILABLE, TypedServeError)

DEFAULT_MAX_SLOTS = 8          # fallback when device memory stats are absent
DEFAULT_MAX_NEW_TOKENS = 64
HBM_FRACTION = 0.5             # share of free device memory slots may fill
DEFAULT_PAGE_TOKENS = 16       # mirrors PADDLE_TPU_DECODE_PAGE_TOKENS
ARTIFACT_FORMAT = "paddle_tpu.decode.v1"

_REQ_IDS = itertools.count(1)

_METRICS = None


def _decode_metrics():
    """Register (idempotently) and return the paddle_tpu_decode_* families
    this engine keeps: the JAX engine's names, types, help strings and
    label names. Its tenant, preemption and handoff families wait for the
    features that bump them."""
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


def _trie_owner(digest: bytes) -> tuple:
    """Allocator owner tag for a prefix-trie node (short digest hex)."""
    return ("trie", digest.hex()[:12])


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


class _Req:
    __slots__ = ("id", "prompt", "max_new", "temperature", "top_k",
                 "eos_id", "seed", "stream", "cache_len", "last_tok",
                 "generated", "pages", "input_tail", "feeding",
                 "t_submit", "t_admit", "prefill_s")

    def __init__(self, prompt, max_new, temperature, top_k, eos_id,
                 seed=None):
        self.id = next(_REQ_IDS)
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
    walks the trie without storing token arrays. Every entry holds one
    allocator reference; `lookup` retains matched pages on the caller's
    behalf (so an entry evicted a microsecond later cannot free a page
    the caller is about to map).

    Eviction is **leaf-first LRU**: among entries, ones with no live
    child go first (ordered by last-touch tick), and only when every
    candidate is mid-chain does the oldest interior entry go. Forced
    mid-chain removals bump the `orphaned` stat. Single leaf lock; lock
    order is trie -> allocator everywhere. (The JAX trie also tracks
    host-tier handles; tiering is not ported, so every entry here is a
    device page.)"""

    def __init__(self, alloc: PageAllocator, page_tokens: int):
        self._alloc = alloc
        self._pt = int(page_tokens)
        self._lock = threading.Lock()
        # digest -> [page, tick, parent_digest|None]; one ref held each
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
        """Drop one entry (lock held): release its ref, unlink from its
        parent, count stranded descendants."""
        del self._entries[d]
        parent = ent[2]
        if parent is not None and parent in self._kids:
            self._kids[parent] -= 1
            if self._kids[parent] <= 0:
                del self._kids[parent]
        self._orphaned += self._kids.pop(d, 0)
        self._alloc.release(ent[0], owner=_trie_owner(d))

    def lookup(self, prompt: Sequence[int],
               owner: Optional[tuple] = None) -> Tuple[List[int], int]:
        """Longest cached page-aligned prefix of `prompt`. Returns
        (pages, hit_tokens); each returned page has been retained for the
        caller — attributed to `owner` — who owns releasing every one."""
        pages: List[int] = []
        with self._lock:
            self._tick += 1
            for d in self._digests(prompt):
                ent = self._entries.get(d)
                if ent is None:
                    break
                self._alloc.retain(ent[0], owner=owner)
                ent[1] = self._tick
                pages.append(ent[0])
        return pages, len(pages) * self._pt

    def insert(self, prompt: Sequence[int], pages: Sequence[int]):
        """Cache `prompt`'s full pages (pages[i] holds prompt rows
        [i*pt, (i+1)*pt)); already-cached prefixes are left in place."""
        with self._lock:
            self._tick += 1
            prev = None
            for d, p in zip(self._digests(prompt), pages):
                if d not in self._entries:
                    self._alloc.retain(p, owner=_trie_owner(d))
                    self._entries[d] = [int(p), self._tick, prev]
                    if prev is not None and prev in self._entries:
                        self._kids[prev] = self._kids.get(prev, 0) + 1
                prev = d

    def _leaf_key(self, d: bytes, ent: List):
        return (1 if self._kids.get(d) else 0, ent[1])

    def evict(self, n: int) -> int:
        """Release up to `n` entries' pages, leaf-first LRU, re-deriving
        leaf status after every removal (so evicting a whole chain walks
        it tip-to-root instead of orphaning it)."""
        removed = 0
        with self._lock:
            while removed < max(n, 0) and self._entries:
                d, e = min(self._entries.items(),
                           key=lambda x: self._leaf_key(*x))
                self._remove(d, e)
                removed += 1
            self._evictions += removed
        return removed

    def clear(self):
        with self._lock:
            for d, ent in self._entries.items():
                self._alloc.release(ent[0], owner=_trie_owner(d))
            self._entries.clear()
            self._kids.clear()

    def stats(self) -> Dict:
        with self._lock:
            return {"cached_pages": len(self._entries),
                    "evictions": self._evictions,
                    "orphaned": self._orphaned}


class DecodeEngine:
    """Slot-pool continuous batcher over the paged incremental GPT
    forward: fixed device page pool + per-slot block tables, prefix
    sharing with copy-on-write, typed backpressure on exhaustion.

    Give it a `models.gpt.GPTDecoder` as `model`, or `cfg` plus `params`
    (the port's flat tensor dict: `models.gpt.params_from_numpy` carries
    the JAX package's weights across, int8 weights of a quantized artifact
    included, which stay int8). `kv_dtype` ("float32" or "int8", default
    PADDLE_TPU_DECODE_KV_DTYPE) picks the page pool. `device` defaults to
    cuda and raises without a GPU."""

    _req_cls = _Req       # SpecDecodeEngine swaps in _SpecReq

    def __init__(self, model=None, *, cfg: Optional[GPTConfig] = None,
                 params: Optional[Mapping] = None,
                 eps: Optional[float] = None,
                 max_slots: Optional[int] = None,
                 max_new_tokens: int = DEFAULT_MAX_NEW_TOKENS,
                 page_tokens: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_dtype: Optional[str] = None,
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
        self.max_pending = 4 * self.max_slots
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
        self._alloc = PageAllocator(self.num_pages)
        use_prefix = prefix_cache if prefix_cache is not None \
            else bool(_flags.env_value("PADDLE_TPU_DECODE_PREFIX_CACHE"))
        self._prefix = _PrefixCache(self._alloc, self.page_tokens) \
            if use_prefix else None

        self._prefill, self._step = gpt_paged_decode_fns(
            cfg, eps=self.eps, page_tokens=self.page_tokens)
        self._paged_prefill = gpt_paged_prefill_fns(
            cfg, eps=self.eps, page_tokens=self.page_tokens)
        self._rng = np.random.default_rng(0)   # unseeded requests' draws

        self._pending: deque = deque()
        self._active: List[_Req] = []
        self._kpool = None           # [L, P, page_tokens, nh, D] (or the
                                     # int8 (data, scale) pair), lazy
        self._vpool = None
        self._last_b_rung = self.batch_ladder[0]
        self._last_w_rung = self.page_ladder[0]
        self._steps = 0
        self._tokens = 0
        self._step_s = 0.0
        self._counts = {"prefix_hits": 0, "prefix_misses": 0,
                        "prefix_hit_tokens": 0, "cow_copies": 0,
                        "prefills": 0}
        self._m = _decode_metrics()
        self._m["kv_page_bytes"].set(
            kv_page_bytes(cfg, self.page_tokens, self.kv_dtype))
        self._m["kv_quantized"].set(1 if self.kv_dtype == "int8" else 0)
        self._stop = False
        self._cond = threading.Condition()
        self._thread = threading.Thread(
            target=self._loop, name="decode-scheduler", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ API

    def submit(self, prompt: Sequence[int], max_new_tokens=None,
               temperature: float = 0.0, top_k: int = 0,
               eos_id=None, seed=None) -> DecodeStream:
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
        req = self._req_cls(toks, int(max_new_tokens or self.max_new_tokens),
                   float(temperature), int(top_k),
                   None if eos_id is None else int(eos_id),
                   seed=None if seed is None else int(seed))
        with self._cond:
            if self._stop:
                raise TypedServeError(ERR_UNAVAILABLE,
                                      "decode engine stopped")
            if len(self._pending) >= self.max_pending:
                raise TypedServeError(
                    ERR_RESOURCE_EXHAUSTED,
                    f"decode queue full ({self.max_pending} pending)")
            self._pending.append(req)
            self._cond.notify_all()
        return req.stream

    def _pool_shape(self):
        L, nh, D = self.cfg.layers, self.cfg.heads, self.cfg.head_dim
        return (L, self.num_pages, self.page_tokens, nh, D)

    def _pools(self):
        """Every page pool a page id names a page in."""
        return (self._kpool, self._vpool)

    def _ensure_pool(self):
        if self._kpool is None:
            self._kpool = kv_pool_zeros(self._pool_shape(), self.kv_dtype,
                                        self.device)
            self._vpool = kv_pool_zeros(self._pool_shape(), self.kv_dtype,
                                        self.device)

    def warmup(self, verbose: bool = False) -> int:
        """Allocate the pools, build the kernels, and run the decode step
        once per (batch-rung x page-rung) signature (capped), with
        all-null block tables so every write lands in the null page.
        Call before submitting. Returns the number of signatures run."""
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
            "kv_page_bytes": kv_page_bytes(self.cfg, self.page_tokens,
                                           self.kv_dtype),
            "pages": self._alloc.stats(),
            "cow_copies": self._counts["cow_copies"],
            "prefills": self._counts["prefills"],
        }
        if self._prefix is not None:
            st["prefix_cache"] = dict(
                self._prefix.stats(),
                hits=self._counts["prefix_hits"],
                misses=self._counts["prefix_misses"],
                hit_tokens=self._counts["prefix_hit_tokens"])
        return st

    def stop(self):
        """Stop the scheduler; open streams get typed UNAVAILABLE."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=30)
        leftovers = list(self._active) + list(self._pending)
        self._active, self._pending = [], deque()
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
                       and not self._active):
                    self._cond.wait(timeout=0.1)
                if self._stop:
                    return
                # single-tenant FIFO admission into the free slots
                newly = []
                while self._pending \
                        and len(self._active) + len(newly) < self.max_slots:
                    newly.append(self._pending.popleft())
            admitting = list(newly)
            try:
                for req in newly:
                    if self._admit(req):
                        self._active.append(req)
                    admitting.remove(req)
                if newly:
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
                self._update_gauges()

    # ---------------------------------------------------- page plumbing

    def _owner_for(self, req) -> tuple:
        """The owner tag stamped on pages `req` holds (SpecDecodeEngine
        retags its streams ``("draft", id)``)."""
        return ("slot", req.id, "default")

    def _release_pages(self, req: _Req):
        """Drop the slot's reference on every page it maps (exactly one
        ref per block-table entry). Idempotent via the list reset."""
        owner = self._owner_for(req)
        pages, req.pages = req.pages, []
        for p in pages:
            self._alloc.release(p, owner=owner)
        self._update_gauges()

    def _alloc_pages(self, n: int, req: _Req) -> List[int]:
        """Allocate `n` pages for `req`: the pool, then — under pressure —
        LRU-evict cold prefix-cache pages and retry once. Failure is typed
        RESOURCE_EXHAUSTED for THIS request."""
        owner = self._owner_for(req)
        retried = False
        while True:
            try:
                pages = self._alloc.alloc(n, owner=owner)
                break
            except PageExhausted as exc:
                err = exc
            if not retried and self._prefix is not None:
                evicted = self._prefix.evict(
                    max(n - self._alloc.free_count(), 1))
                if evicted:
                    self._m["prefix_evictions"].inc(evicted)
                    retried = True
                    continue
            self._m["page_alloc_failures"].inc()
            raise TypedServeError(
                ERR_RESOURCE_EXHAUSTED,
                f"decode request {req.id}: KV page pool exhausted ({err})"
            ) from err
        self._m["page_allocs"].inc(n)
        return pages

    def _cow(self, req: _Req, slot: int):
        """First write into a shared page: copy it to a fresh page (data
        and scale of an int8 pool) and repoint this slot's block table
        (the other owners keep the original — that's the isolation)."""
        old = req.pages[slot]
        (new,) = self._alloc_pages(1, req)
        for pool in self._pools():
            copy_page(pool, old, new)
        req.pages[slot] = new
        self._alloc.release(old, owner=self._owner_for(req))
        self._counts["cow_copies"] += 1
        self._m["cow"].inc()

    # ------------------------------------------------------- admission

    def _admit(self, req: _Req) -> bool:
        """Give the request KV pages and a first token source.

        Prefix hit: map the cached pages (refcount++), queue the uncached
        prompt tail to be fed through the batched decode step — no
        prefill at all. Miss: prefill the prompt straight into fresh
        pages, deliver the first sampled token immediately. True if the
        request now occupies a decode slot."""
        toks = req.prompt
        plen = len(toks)
        pt = self.page_tokens
        self._ensure_pool()
        req.t_admit = time.monotonic()

        usable, hit_pages = 0, []
        owner = self._owner_for(req)
        if self._prefix is not None:
            hit_pages, hit_tokens = self._prefix.lookup(toks, owner=owner)
            self._m["prefix_lookup_tokens"].inc(plen)
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

        # miss: prefill the whole prompt into freshly allocated pages
        try:
            pages = self._alloc_pages(-(-plen // pt), req)
        except TypedServeError as err:
            req.stream._push_error(err)
            self._m["evictions"].labels(reason="exhausted").inc()
            return False
        req.pages = pages
        t0 = time.perf_counter()
        logits, _, _ = self._paged_prefill(
            self.params, self._kpool, self._vpool,
            torch.tensor([toks], dtype=torch.long),
            torch.tensor([pages], dtype=torch.int32),
            torch.tensor([plen], dtype=torch.long))
        row = logits[0].float().cpu().numpy()
        req.prefill_s = time.perf_counter() - t0
        self._counts["prefills"] += 1
        self._m["prefills"].inc()
        self._m["prefill_latency"].observe(req.prefill_s)
        self._m["ttft"].observe(time.monotonic() - req.t_submit)
        tok = self._sample(row, req)
        req.cache_len = plen
        req.last_tok = tok
        req.generated.append(tok)
        self._tokens += 1
        self._m["tokens"].inc()
        if self._prefix is not None:
            self._prefix.insert(toks, pages[:plen // pt])
        eos = req.eos_id is not None and tok == req.eos_id
        req.stream._push_token(tok, eos)
        if eos or len(req.generated) >= req.max_new \
                or req.cache_len >= self.cfg.max_seq_len:
            self._finish(req, "eos" if eos else "length")
            self._release_pages(req)
            return False
        return True

    # ------------------------------------------------------------ step

    def _step_once(self):
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
                    self._cow(req, slot)
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
        logits, _, _ = self._step(
            self.params, self._kpool, self._vpool, torch.from_numpy(tables),
            torch.from_numpy(ltok), torch.from_numpy(clen))
        lognp = logits.float().cpu().numpy()
        dt = time.perf_counter() - t0
        self._step_s += dt
        self._m["step_latency"].observe(dt)
        self._last_b_rung, self._last_w_rung = b_rung, w_rung
        self._steps += 1
        self._m["steps"].inc()
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
            tok = self._sample(lognp[j], req)
            req.generated.append(tok)
            req.last_tok = tok
            emitted += 1
            if first:
                self._m["ttft"].observe(time.monotonic() - req.t_submit)
            eos = req.eos_id is not None and tok == req.eos_id
            req.stream._push_token(tok, eos)
            if eos or len(req.generated) >= req.max_new \
                    or req.cache_len >= self.cfg.max_seq_len:
                self._finish(req, "eos" if eos else "length")
                self._release_pages(req)
                finished.append(req)
        self._tokens += emitted
        if emitted:
            self._m["tokens"].inc(emitted)
        if finished:
            done = {r.id for r in finished}
            self._active = [r for r in reqs if r.id not in done]
            self._update_gauges()

    def _finish(self, req: _Req, reason: str):
        req.stream._push_done()
        self._m["evictions"].labels(reason=reason).inc()

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
        ps = self._alloc.stats()
        self._m["page_pool_size"].set(ps["pages_total"])
        self._m["page_in_use"].set(ps["pages_used"])
        self._m["page_shared"].set(ps["pages_shared"])
        self._m["page_fragmentation"].set(ps["fragmentation"])
        if self._prefix is not None:
            self._m["prefix_cached_pages"].set(
                self._prefix.stats()["cached_pages"])


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
    PADDLE_TPU_DECODE_SPECULATE. The JAX engine's preemption stash and
    tiering hooks are not ported: this engine has neither feature."""

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
        page id names a target AND a draft page."""
        return ("draft", req.id)

    def _dpool_shape(self):
        c = self.draft_cfg
        return (c.layers, self.num_pages, self.page_tokens, c.heads,
                c.head_dim)

    def _ensure_pool(self):
        super()._ensure_pool()
        if self._dkpool is None:
            self._dkpool = kv_pool_zeros(self._dpool_shape(), self.kv_dtype,
                                         self.device)
            self._dvpool = kv_pool_zeros(self._dpool_shape(), self.kv_dtype,
                                         self.device)

    def _pools(self):
        """Copy-on-write copies the page in BOTH models' pools."""
        return (self._kpool, self._vpool, self._dkpool, self._dvpool)

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
            self._rollout(self._draft_params, self._dkpool, self._dvpool,
                          tables, torch.zeros((b, kk), dtype=torch.long), z)
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
        self._dprefill(self._draft_params, self._dkpool, self._dvpool,
                       torch.tensor([seq], dtype=torch.long),
                       torch.tensor([req.pages[:n]], dtype=torch.int32),
                       torch.tensor([len(seq)]))
        self._spec["draft_prefills"] += 1

    # ------------------------------------------------------------ tick

    def _step_once(self):
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
                        self._cow(req, s)
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
        drafts, _, _ = self._rollout(
            self._draft_params, self._dkpool, self._dvpool, tables,
            torch.from_numpy(forced), torch.from_numpy(dlen))
        dnp = drafts.cpu().numpy()
        t1 = time.perf_counter()
        self._spec["rollout_seconds"] += t1 - t0
        self._spec["draft_steps"] += tick_k
        self._m["spec_draft_steps"].inc(tick_k)
        chains: List[List[int]] = [[] for _ in reqs]
        for j, req in enumerate(reqs):
            for i in range(tick_k):
                if req.draft_len >= len(seqs[j]) - 1:
                    chains[j].append(int(dnp[j, i]))
                req.draft_len += 1
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
        logits, amax, _, _ = self._verify(
            self.params, self._kpool, self._vpool, tables,
            torch.from_numpy(vtoks), torch.from_numpy(clen))
        amaxnp = amax.cpu().numpy()
        dt = time.perf_counter() - t2
        lognp = None   # full logits only cross to the host when sampling
        self._spec["verify_seconds"] += dt
        self._step_s += dt
        self._m["step_latency"].observe(dt)
        self._last_b_rung, self._last_w_rung = b_rung, w_rung
        self._steps += 1
        self._m["steps"].inc()
        # 4. acceptance + rollback, per slot on the host
        finished = []
        for j, req in enumerate(reqs):
            n_known, nd = meta[j]
            drafts_j = chains[j][:nd]
            seq_len_old = len(seqs[j])
            mid_prompt = req.feeding \
                and req.cache_len + n_known < len(req.prompt)
            if req.feeding and not mid_prompt:
                # the verify just consumed the last prompt-tail token: the
                # pages now hold the whole prompt
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
            req.generated.extend(emitted)
            self._tokens += len(emitted)
            self._m["tokens"].inc(len(emitted))
            done_eos = req.eos_id is not None and emitted[-1] == req.eos_id
            req.stream._push_tokens(emitted, done_eos)
            if first:
                self._m["ttft"].observe(time.monotonic() - req.t_submit)
            if done_eos or len(req.generated) >= req.max_new \
                    or req.cache_len >= cap:
                self._finish(req, "eos" if done_eos else "length")
                self._release_pages(req)
                finished.append(req)
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
           "kv_capacity_ladder", "default_slot_count", "save_for_decode",
           "load_for_decode"]
