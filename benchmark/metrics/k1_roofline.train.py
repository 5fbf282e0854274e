"""K1's share of its roofline: the least time of a step's K1 launches
(``counts.k1_step_bound_ms``, bytes at 3.35 TB/s) over the device time a
profiled step spent in the kernel its source names."""

KERNEL = "scatter_levels_kernel"


def read(record):
    tr, bound = record.get("trace"), record.get("k1_bound_ms_per_step")
    if tr is None or not bound:
        return None
    k1_ms = 1e3 * tr.name_s(KERNEL) / tr.units
    return 100.0 * bound / k1_ms if k1_ms > 0 else None
