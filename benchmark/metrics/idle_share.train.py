"""The share of the profiled steps' interval in which the device ran
nothing: one minus the union of its busy intervals over the interval."""

from benchmark.metrics._stats import idle_percent


def read(record):
    return idle_percent(record) if record["kind"] == "train" else None
