"""Device milliseconds a profiled step in matrix-product kernels
(``trace.KERNEL_KINDS``)."""

from benchmark.metrics._stats import device_ms_per_unit


def read(record):
    return device_ms_per_unit(record, "matmul") if record["kind"] == "train" else None
