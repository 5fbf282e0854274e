"""Rays of every frame completed in the window, over the window."""


def read(record):
    return record["rays"] / record["window_s"] if record["kind"] == "view" else None
