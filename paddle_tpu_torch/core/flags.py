"""The subset of paddle_tpu's PADDLE_TPU_* environment-flag catalog that
the port reads, with the same names, defaults and parsing.

`env_value(name)` returns the parsed value of a catalogued flag; an unset,
empty or unparsable variable yields the default, and an uncatalogued name
raises, exactly as in the JAX package's `core/flags.py`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict


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
    if parser is None:
        if isinstance(default, bool):
            parser = _parse_bool
        elif isinstance(default, int):
            parser = int
        elif isinstance(default, float):
            parser = float
        else:
            parser = str
    _ENV_REGISTRY[name] = _EnvFlag(name, default, doc, parser)


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
    "PADDLE_TPU_MAX_REQUEST_BYTES", 1 << 28,
    "Per-request wire payload budget in bytes for serve frames "
    "(inference/serve.py); default 256 MiB.")
define_env_flag(
    "PADDLE_TPU_SERVE_IDLE_TIMEOUT", 600.0,
    "Seconds an idle client connection is kept open before the server "
    "closes it (inference/serve.py).")
define_env_flag(
    "PADDLE_TPU_SERVE_REQUEST_TIMEOUT", 120.0,
    "Server-side per-request deadline in seconds (inference/serve.py).")
