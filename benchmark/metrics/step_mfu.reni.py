"""The RENI training step's share of the card's peak: the FLOPs of the
folded decoder's matrix products a step, forward and backward
(``reni_counts.step_flops`` from the configuration's shapes), times the
window's steps, over the window, against 989 TFLOP/s (dense bf16,
whatever precision runs)."""

from benchmark.metrics._stats import mfu_percent


def read(record):
    return mfu_percent(record, "flops_per_step", "steps")
