"""The largest memory the allocator held on the card over set-up and the
window, graph pools included (``torch.cuda.max_memory_reserved``)."""


def read(record):
    return record["peak_mem_bytes"] / 2**30 if record["peak_mem_bytes"] else None
