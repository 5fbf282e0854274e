"""The 90th percentile of every frame in the window, from the call to the
host-side image."""

from benchmark.metrics._stats import percentile


def read(record):
    return percentile(record["frame_ms"], 90) if record.get("frame_ms") else None
