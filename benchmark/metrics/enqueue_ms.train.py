"""Host milliseconds a step in the trainer's step call (the draws, the
static copies and the replay's launch), from the benchmark's span around
each call in the window."""

from benchmark.metrics._stats import mean_ms


def read(record):
    return mean_ms(record["spans"].get("train_step"))
