"""The whole training step's share of the card's peak: the FLOPs of the
step's matrix products (forward and backward, no recompute), counted on
the reference at the configuration's shapes, times the window's steps,
over the window, against 989 TFLOP/s (dense bf16, whatever precision
runs)."""

from benchmark.metrics._stats import mfu_percent


def read(record):
    return mfu_percent(record, "flops_per_step", "steps") if record["kind"] == "train" else None
