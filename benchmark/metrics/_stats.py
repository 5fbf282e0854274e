"""Arithmetic the readers share."""

from __future__ import annotations

import math
from typing import Optional, Sequence

from benchmark.counts import PEAK_FLOPS


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` % of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def mean_ms(values: Optional[Sequence[float]]) -> Optional[float]:
    """The mean of spans in seconds, in milliseconds."""
    return 1e3 * sum(values) / len(values) if values else None


def device_ms_per_unit(record, kind: str) -> Optional[float]:
    """Device milliseconds per step or frame in kernels of ``kind``."""
    tr = record.get("trace")
    if tr is None or not tr.device:
        return None
    return 1e3 * tr.kind_s(kind) / tr.units


def idle_percent(record) -> Optional[float]:
    tr = record.get("trace")
    if tr is None or not tr.device:
        return None
    return 100.0 * tr.idle_share()


def mfu_percent(record, flops_key: str, units_key: str) -> Optional[float]:
    """The counted FLOPs of every step or frame of the window over the
    window, against the card's dense bf16 peak."""
    flops = record.get(flops_key)
    if not flops:
        return None
    return 100.0 * flops * record[units_key] / record["window_s"] / PEAK_FLOPS
