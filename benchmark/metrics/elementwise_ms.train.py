"""Device milliseconds a profiled step in kernels of the elementwise kind
(``trace.KERNEL_KINDS``)."""

from benchmark.metrics._stats import device_ms_per_unit


def read(record):
    return device_ms_per_unit(record, "elementwise") if record["kind"] == "train" else None
