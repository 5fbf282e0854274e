"""The share of rank 0's profiled mesh steps' interval in which its card
ran nothing: one minus the union of its busy intervals over the
interval."""

from benchmark.metrics._stats import idle_percent


def read(record):
    return idle_percent(record)
