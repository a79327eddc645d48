"""Shape-bucket ladders and tenant QoS maps for the decode engine (from
paddle_tpu's `inference/batching.py`; the one-shot DynamicBatcher is not
ported).

The engine pads its batch and block-table width to rungs of these
ladders, so the set of step shapes stays small and fixed. The tenant
helpers parse the weighted-fair and quota specs
(PADDLE_TPU_TENANT_WEIGHTS / PADDLE_TPU_TENANT_QUOTA) the engine's
admission reads."""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..core import flags as _flags

__all__ = ["bucket_ladder", "next_bucket", "max_queue_default",
           "parse_tenant_map", "tenant_weights", "tenant_quotas"]

_WARMUP_SIG_CAP = 64          # cross-product guard for many dynamic dims


def parse_tenant_map(spec, default: float = 0.0):
    """Parse a ``tenant:value,tenant2:value`` spec into a dict. A ``*``
    entry sets the value for unlisted tenants (exposed under the ``"*"``
    key); malformed entries are skipped — a QoS config typo must not
    take the daemon down."""
    out = {"*": float(default)}
    for part in str(spec or "").replace(";", ",").split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        name, _, val = part.rpartition(":")
        try:
            out[name.strip()] = float(val)
        except ValueError:
            continue
    return out


def tenant_weights(spec=None) -> dict:
    """Per-tenant fair-share weights (``PADDLE_TPU_TENANT_WEIGHTS``);
    unlisted tenants weigh 1.0, non-positive entries degrade to 1.0."""
    raw = _flags.env_value("PADDLE_TPU_TENANT_WEIGHTS") \
        if spec is None else spec
    out = parse_tenant_map(raw, default=1.0)
    return {t: (w if w > 0 else 1.0) for t, w in out.items()}


def tenant_quotas(spec=None) -> dict:
    """Per-tenant service-rate quotas (``PADDLE_TPU_TENANT_QUOTA``):
    tokens/second for the decode engine. 0 (the default) means
    unlimited."""
    raw = _flags.env_value("PADDLE_TPU_TENANT_QUOTA") \
        if spec is None else spec
    out = parse_tenant_map(raw, default=0.0)
    return {t: max(q, 0.0) for t, q in out.items()}


def max_queue_default() -> int:
    """Admission-control watermark (``PADDLE_TPU_SERVE_MAX_QUEUE``):
    queued requests past this are shed with ``RESOURCE_EXHAUSTED``
    instead of waiting out (and then blowing) the request deadline.
    0 disables shedding."""
    return int(_flags.env_value("PADDLE_TPU_SERVE_MAX_QUEUE"))


def bucket_ladder(max_batch: int, env: Optional[str] = None) -> List[int]:
    """The padded-shape ladder: the ints of `env` if it is non-empty,
    else powers of two up to (and including) ``max_batch``."""
    spec = env or ""
    if spec.strip():
        vals = sorted({int(t) for t in spec.replace(",", " ").split()})
        if not vals or vals[0] <= 0:
            raise ValueError(
                f"bucket ladder must be positive ints, got {spec!r}")
        return vals
    vals, v = [], 1
    while v < max_batch:
        vals.append(v)
        v *= 2
    vals.append(int(max_batch))
    return sorted(set(vals))


def next_bucket(n: int, ladder: Sequence[int]) -> int:
    """Smallest rung >= n; beyond the top the ladder continues by powers
    of two so oversized requests still land on a bounded shape set."""
    for v in ladder:
        if v >= n:
            return v
    v = ladder[-1]
    while v < n:
        v *= 2
    return v
