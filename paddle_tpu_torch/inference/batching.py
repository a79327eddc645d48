"""Shape-bucket ladders for the decode engine (from paddle_tpu's
`inference/batching.py`; the one-shot DynamicBatcher is not ported).

The engine pads its batch and block-table width to rungs of these
ladders, so the set of step shapes stays small and fixed."""
from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["bucket_ladder", "next_bucket"]

_WARMUP_SIG_CAP = 64          # cross-product guard for many dynamic dims


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
