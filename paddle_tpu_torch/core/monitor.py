"""Stat registry + device memory counters.

Port of paddle_tpu's `core/monitor.py`. The named-counter surface
(stat_inc / stat_set / ...) is backed by the observability metrics
registry — every stat lands as a ``paddle_tpu_monitor_stat{name="..."}``
gauge sample, so framework and user instrumentation shows up on the same
``/metrics`` scrape as the serving counters. Device memory numbers come
from the CUDA caching allocator (``torch.cuda.memory_stats``) and the
driver (``torch.cuda.mem_get_info``) instead of PJRT, under the JAX
package's keys: ``bytes_in_use`` (allocated bytes), ``peak_bytes_in_use``
(the allocator's peak) and ``bytes_limit`` (the card's total memory),
keyed ``"cuda:<index>"``. Every probe returns empty / zero — never raises
— when no GPU is visible (a CPU process).
"""
from __future__ import annotations

from typing import Dict, Optional

from ..observability import metrics as _metrics

__all__ = ["stat_inc", "stat_set", "stat_get", "stat_reset", "all_stats",
           "device_memory_stats", "all_device_memory_stats", "hbm_usage"]

_STATS = _metrics.gauge(
    "paddle_tpu_monitor_stat",
    "Named framework counters (StatRegistry parity surface: "
    "core.monitor.stat_inc/stat_set).",
    labelnames=("name",))


def stat_inc(name: str, value: int = 1) -> int:
    return int(_STATS.labels(name=str(name)).inc(int(value)))


def stat_set(name: str, value: int):
    _STATS.labels(name=str(name)).set(int(value))


def stat_get(name: str, default: int = 0) -> int:
    v = _STATS.value(name=str(name))
    return default if v is None else int(v)


def stat_reset(name: Optional[str] = None):
    if name is None:
        _STATS.clear()
    else:
        _STATS.remove(name=str(name))


def all_stats() -> Dict[str, int]:
    return {labels["name"]: int(child.get())
            for labels, child in _STATS.samples()}


def _cuda_stats(index: int) -> Dict[str, int]:
    import torch
    st = torch.cuda.memory_stats(index)
    _, total = torch.cuda.mem_get_info(index)
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total)}


def _cuda_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def device_memory_stats(device=None) -> Dict[str, int]:
    """The card's memory counters (bytes_in_use, peak_bytes_in_use,
    bytes_limit) for `device` (a ``torch.device``, ``"cuda:i"`` or an
    index; default the first card). Returns ``{}`` when no GPU is visible
    or `device` is not a CUDA device, so a CPU process never raises; a
    visible card whose probe fails raises, so no caller takes a failed
    probe for an empty card."""
    if _cuda_count() == 0:
        return {}
    if device is None:
        index = 0
    elif isinstance(device, int):
        index = device
    else:
        import torch
        dev = torch.device(device)
        if dev.type != "cuda":
            return {}
        index = dev.index or 0
    return _cuda_stats(index)


def all_device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{"cuda:i": memory stats} over every visible card, for the scrape
    collectors and `/statusz`: as in the JAX package, a card that cannot
    report comes back as an empty dict (its gauges go missing rather
    than failing the scrape), and a process with no GPU gets ``{}``."""
    try:
        n = _cuda_count()
    except Exception:
        return {}
    out = {}
    for i in range(n):
        try:
            out[f"cuda:{i}"] = _cuda_stats(i)
        except Exception:
            out[f"cuda:{i}"] = {}
    return out


def hbm_usage(device=None):
    """(bytes_in_use, bytes_limit) — the STAT_GPU_MEM analog. (0, 0) when
    the runtime has nothing to report."""
    st = device_memory_stats(device)
    return st.get("bytes_in_use", 0), st.get("bytes_limit", 0)
