"""The whole frame's share of the card's peak: the FLOPs of a frame's
forward matrix products, counted on the reference, times the window's
frames, over the window, against 989 TFLOP/s."""

from benchmark.metrics._stats import mfu_percent


def read(record):
    return mfu_percent(record, "flops_per_frame", "frames") if record["kind"] == "view" else None
