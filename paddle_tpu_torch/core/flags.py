"""The subset of paddle_tpu's flags that the port reads, with the same
names, defaults and parsing, in the JAX package's two kinds:

  * process-global ``FLAGS_*`` (`define_flag`, `get_flags`, `set_flags`):
    each has a default that the environment variable ``FLAGS_<name>``
    overrides when the flag is defined, and `set_flags` changes later;
  * the PADDLE_TPU_* environment-flag catalog (`env_value(name)`): an
    unset, empty or unparsable variable yields the default, and an
    uncatalogued name raises, exactly as in the JAX package's
    `core/flags.py`.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class _Flag:
    name: str
    default: Any
    doc: str
    parser: Callable[[str], Any]
    value: Any


_REGISTRY: Dict[str, _Flag] = {}
_LOCK = threading.Lock()


def _parser_for(default):
    if isinstance(default, bool):
        return _parse_bool
    if isinstance(default, int):
        return int
    if isinstance(default, float):
        return float
    return str


def define_flag(name, default, doc=""):
    """Declare one FLAGS_<name> (default, doc); the environment variable
    FLAGS_<name>, read now, overrides the default."""
    parser = _parser_for(default)
    env = os.environ.get("FLAGS_" + name)
    value = parser(env) if env is not None else default
    with _LOCK:
        _REGISTRY[name] = _Flag(name, default, doc, parser, value)
    return value


def _key(n):
    key = n[6:] if n.startswith("FLAGS_") else n
    if key not in _REGISTRY:
        raise KeyError(f"Flag {n!r} is not defined")
    return key


def get_flags(flags):
    """paddle.get_flags: a name (-> its value) or a list of names (-> a
    {name: value} dict); the ``FLAGS_`` prefix is optional."""
    if isinstance(flags, str):
        return _REGISTRY[_key(flags)].value
    return {n: _REGISTRY[_key(n)].value for n in flags}


def set_flags(flags: Dict[str, Any]):
    """paddle.set_flags: string values are parsed as the environment's."""
    for n, v in flags.items():
        f = _REGISTRY[_key(n)]
        f.value = f.parser(v) if isinstance(v, str) else v


@dataclass
class _EnvFlag:
    name: str
    default: Any
    doc: str
    parser: Callable[[str], Any]


_ENV_REGISTRY: Dict[str, _EnvFlag] = {}


def _parse_bool(s):
    if isinstance(s, bool):
        return s
    return str(s).lower() in ("1", "true", "yes", "on")


def define_env_flag(name, default, doc, parser=None):
    """Declare one PADDLE_TPU_* environment knob (name, default, doc)."""
    _ENV_REGISTRY[name] = _EnvFlag(name, default, doc,
                                   parser or _parser_for(default))


def env_raw(name) -> Optional[str]:
    """Unparsed environment value for a catalogued flag (None when unset),
    for call sites with a spec grammar the parser cannot express."""
    if name not in _ENV_REGISTRY:
        raise KeyError(f"Env flag {name!r} is not in the catalog")
    return os.environ.get(name)


def env_value(name) -> Any:
    """Parsed value of a catalogued flag; unset/empty/unparsable -> default."""
    flag = _ENV_REGISTRY.get(name)
    if flag is None:
        raise KeyError(f"Env flag {name!r} is not in the catalog")
    raw = os.environ.get(name)
    if raw is None or not str(raw).strip():
        return flag.default
    try:
        return flag.parser(raw)
    except (ValueError, TypeError):
        return flag.default


define_env_flag(
    "PADDLE_TPU_CHAOS", "",
    "Deterministic fault-injection schedule for the chaos harness "
    "(testing/chaos.py), e.g. 'page.migrate:2:RuntimeError'. Unset "
    "disables injection.")
define_env_flag(
    "PADDLE_TPU_DECODE_BUCKETS", "",
    "Decode-engine batch bucket ladder override, space/comma-separated "
    "ints (inference/decode.py); empty uses powers of two up to max_slots.")
define_env_flag(
    "PADDLE_TPU_DECODE_DRAFT_MODEL", "",
    "Draft-model artifact prefix for speculative decoding "
    "(inference/decode.py): a save_for_decode() prefix whose GPT shares "
    "the target's vocab. Empty disables speculation unless --draft-model "
    "is passed to serve.")
define_env_flag(
    "PADDLE_TPU_DECODE_DRAFT_QUANT", False,
    "Int8-quantize the speculative-decoding DRAFT weights at "
    "load_for_decode when the draft artifact is still fp32 "
    "(quant/ptq.py). Draft numerics only move the acceptance rate, "
    "never the target token stream.")
define_env_flag(
    "PADDLE_TPU_DECODE_HANDOFF", False,
    "Enable the decode engine's cross-process KV-page handoff endpoints "
    "for disaggregated prefill/decode serving (inference/decode.py "
    "export_kv/import_kv): a prefill worker ships a prompt's full KV "
    "pages to a decode worker, which admits the stream as a prefix-cache "
    "hit. Implied on by serve --role prefill/decode; enabling it implies "
    "the prefix cache.")
define_env_flag(
    "PADDLE_TPU_DECODE_HOST_PAGES", 0,
    "Host-RAM KV tier capacity in pages for the paged decode engine "
    "(memory/migration.py): under pool pressure cold pages spill to a "
    "preallocated (pinned, on a GPU) host arena and refetch on demand, "
    "turning device memory into a cache over a larger KV store. 0 "
    "disables tiering; enabling it implies the prefix cache.")
define_env_flag(
    "PADDLE_TPU_DECODE_KV_DTYPE", "float32",
    "Decode KV page-pool dtype: 'float32', or 'int8' for quantized "
    "pages (quant/kv.py) — int8 payload plus one fp32 scale per "
    "(token row, head), cutting page memory ~4x at the cost of ~1/254 "
    "relative rounding error per K/V row.")
define_env_flag(
    "PADDLE_TPU_DECODE_PAGE_TOKENS", 16,
    "KV-cache page size in tokens for the paged decode engine "
    "(inference/decode.py, memory/page_allocator.py).")
define_env_flag(
    "PADDLE_TPU_DECODE_PREEMPT", True,
    "Allow the decode engine to preempt the lowest-priority active slot "
    "to host when a strictly higher-priority request cannot be admitted "
    "(inference/decode.py). The victim's pages are released, its state "
    "stays host-side, and it resumes token-identically when pressure "
    "drops. Off = priorities only order the queue.")
define_env_flag(
    "PADDLE_TPU_DECODE_PREFIX_CACHE", True,
    "Enable copy-on-write prefix sharing in the paged decode engine: "
    "page-aligned prompt prefixes are cached in a hash trie and mapped "
    "(refcount++) into later requests with the same head.")
define_env_flag(
    "PADDLE_TPU_DECODE_SPECULATE", 0,
    "Speculation depth k for draft-and-verify decoding "
    "(inference/decode.py): the draft model runs up to k greedy steps "
    "per scheduler tick and the target verifies k+1 positions in one "
    "forward. 0 (default) decodes one token per step; requires a draft "
    "model (PADDLE_TPU_DECODE_DRAFT_MODEL or --draft-model).")
define_env_flag(
    "PADDLE_TPU_MAX_REQUEST_BYTES", 1 << 28,
    "Per-request wire payload budget in bytes for serve frames "
    "(inference/serve.py); default 256 MiB.")
define_env_flag(
    "PADDLE_TPU_MEMZ_OOM_DUMPS", 4,
    "OOM forensic dumps retained by the memory plane "
    "(observability/memz.py) and served at /memz?oom=1 — each captures "
    "the pool's per-owner rollups, fragmentation map, and allocation "
    "ring tail at the moment a PageExhausted fired.")
define_env_flag(
    "PADDLE_TPU_MEMZ_RING_CAPACITY", 4096,
    "Capacity of the memz allocation event ring "
    "(observability/memz.py): alloc/retain/release/exhausted events "
    "from every page pool, overwritten on wrap. 0 disables recording.")
define_env_flag(
    "PADDLE_TPU_METRICS_PORT", None,
    "Admin-plane port for /metrics,/healthz,/statusz,/varz,/alertz,"
    "/tracez,/profilez,/memz (inference/serve.py). 0 = ephemeral port; "
    "unset disables the admin server.", parser=int)
define_env_flag(
    "PADDLE_TPU_SERVE_IDLE_TIMEOUT", 600.0,
    "Seconds an idle client connection is kept open before the server "
    "closes it (inference/serve.py).")
define_env_flag(
    "PADDLE_TPU_SERVE_MAX_QUEUE", 0,
    "Admission-control watermark: queued requests past this are shed "
    "with RESOURCE_EXHAUSTED (inference/batching.py). 0 disables "
    "shedding.")
define_env_flag(
    "PADDLE_TPU_SERVE_REQUEST_TIMEOUT", 120.0,
    "Server-side per-request deadline in seconds (inference/serve.py).")
define_env_flag(
    "PADDLE_TPU_SERVE_ROLE", "unified",
    "Serving-topology role of a decode worker (inference/serve.py "
    "--role): 'unified' (prefill + decode, the default), 'prefill' "
    "(prompt forward + KV export) or 'decode' (KV import + token "
    "streaming). Non-unified roles imply PADDLE_TPU_DECODE_HANDOFF.")
define_env_flag(
    "PADDLE_TPU_SLO_AVAILABILITY", 0.999,
    "Availability SLO target fraction for burn-rate alerts "
    "(observability/slo.py).")
define_env_flag(
    "PADDLE_TPU_SLO_BURN", "2,10",
    "Burn-rate alert factors 'warn,firing' (observability/slo.py).")
define_env_flag(
    "PADDLE_TPU_SLO_LATENCY_TARGET", 0.99,
    "Fraction of requests that must beat PADDLE_TPU_SLO_P99_MS "
    "(observability/slo.py).")
define_env_flag(
    "PADDLE_TPU_SLO_P99_MS", 0.0,
    "Latency SLO threshold in milliseconds; 0 disables the latency "
    "objective (observability/slo.py).")
define_env_flag(
    "PADDLE_TPU_SLO_TENANTS", "",
    "Comma-separated tenant names that get per-tenant availability "
    "objectives on /alertz (observability/slo.py), e.g. 'batch,search'; "
    "empty registers no per-tenant objectives.")
define_env_flag(
    "PADDLE_TPU_SLO_WINDOWS", "60,300",
    "Burn-rate evaluation windows 'short,long' in seconds "
    "(observability/slo.py).")
define_env_flag(
    "PADDLE_TPU_STALL_DUMP", "",
    "Directory for flight-recorder stall dumps (observability/"
    "flight_recorder.py); empty disables the watchdog.")
define_env_flag(
    "PADDLE_TPU_STALL_TIMEOUT", 60.0,
    "Seconds without a heartbeat before the flight recorder declares a "
    "stall and dumps thread stacks (observability/flight_recorder.py).")
define_env_flag(
    "PADDLE_TPU_TENANT_QUOTA", "",
    "Per-tenant service-rate quotas, 'tenant:rate,...' with '*' for "
    "unlisted tenants: tokens/second in the decode engine "
    "(inference/batching.py tenant_quotas). A tenant in quota debt is "
    "deferred — queued, never dropped. Empty or 0 = unlimited.")
define_env_flag(
    "PADDLE_TPU_TENANT_WEIGHTS", "",
    "Per-tenant fair-share weights, 'tenant:weight,...' with '*' for "
    "unlisted tenants (inference/batching.py tenant_weights). Admission "
    "picks the most-underserved tenant by tokens_served/weight; unlisted "
    "tenants weigh 1.0.")

define_env_flag(
    "PADDLE_TPU_TRACEZ_CAPACITY", 65536,
    "Event capacity of the per-process tracez ring (observability/"
    "tracez.py); oldest events are overwritten when full. 0 disables "
    "event recording entirely.")
define_env_flag(
    "PADDLE_TPU_TRACE_FILE", "",
    "JSONL sink for sampled request traces (observability/spans.py); "
    "empty writes them to stderr.")
define_env_flag(
    "PADDLE_TPU_TRACE_MAX_BYTES", 64 << 20,
    "Size cap in bytes for the JSONL trace file (observability/spans.py): "
    "at the cap the file rotates to <path>.1, keeping the live file plus "
    "one predecessor. <= 0 disables rotation.")
define_env_flag(
    "PADDLE_TPU_TRACE_SAMPLE", 0.0,
    "Request-trace sampling rate clamped to [0,1] (observability/spans.py); "
    "0 disables sampling.")
define_env_flag(
    "PADDLE_TPU_VARZ_CAPACITY", 400,
    "Ring-buffer capacity (snapshot count) for /varz time-series history "
    "(observability/timeseries.py), min 8.")
define_env_flag(
    "PADDLE_TPU_VARZ_INTERVAL", 10.0,
    "Sampler period in seconds for /varz time-series history "
    "(observability/timeseries.py), min 0.05.")

define_flag("use_pallas_attention", True,
            "Route qualifying scaled_dot_product_attention calls (no mask, "
            "no dropout, seq_len >= pallas_attention_min_seq) to the flash "
            "attention kernels.")
define_flag("pallas_attention_min_seq", 512,
            "Route sdpa to the flash kernels only at seq_len >= this. The "
            "value is the JAX package's, kept so the routing matches it; it "
            "was chosen on a TPU and has not been re-measured on the GPU.")
define_flag("amp_dtype", "bfloat16",
            "Reduced precision dtype for AMP (amp.auto_cast's default).")
