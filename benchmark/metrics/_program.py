"""What the readers of the program's own tracing share: its device spans
as ``neusky_torch/utils/profiling.py::snapshot`` gives them, kept by a
window loop under ``record["program"]``."""

from __future__ import annotations

import statistics
from typing import Optional


def replay_span_ms(record, path: str) -> Optional[float]:
    """The median of the device milliseconds of the span ``path`` over the
    window's sampled graph replays; None without the program's tables (a
    run untraced or off the card) or where the program has no such span."""
    snap = record.get("program")
    if not snap:
        return None
    row = snap.get("device", {}).get("replay", {}).get("spans", {}).get(path)
    return statistics.median(row["recent_ms"]) if row and row["recent_ms"] else None
