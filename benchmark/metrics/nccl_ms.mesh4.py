"""Device milliseconds a profiled mesh step of rank 0 spends in NCCL's
kernels (the names that begin with ``nccl``: the step's coalesced
all-reduce of the gradients and losses, replayed inside its graph)."""


def read(record):
    tr = record.get("trace")
    if tr is None or not tr.device:
        return None
    return 1e3 * sum(e - s for n, s, e in tr.device if n.startswith("nccl")) / tr.units
