"""The share of the profiled RENI steps' interval in which the device ran
nothing: one minus the union of its busy intervals over the interval."""

from benchmark.metrics._stats import idle_percent


def read(record):
    return idle_percent(record)
