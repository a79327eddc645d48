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
from typing import Any, Callable, Dict


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
    "PADDLE_TPU_METRICS_PORT", None,
    "Admin-plane port for /metrics, /healthz and /statusz "
    "(inference/serve.py). 0 = ephemeral port; unset disables the admin "
    "server.", parser=int)
define_env_flag(
    "PADDLE_TPU_SERVE_IDLE_TIMEOUT", 600.0,
    "Seconds an idle client connection is kept open before the server "
    "closes it (inference/serve.py).")
define_env_flag(
    "PADDLE_TPU_SERVE_REQUEST_TIMEOUT", 120.0,
    "Server-side per-request deadline in seconds (inference/serve.py).")

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
