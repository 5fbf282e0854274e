"""Counted rays of every training step completed in the window, over the
window."""


def read(record):
    return record["rays"] / record["window_s"] if record["kind"] == "train" else None
