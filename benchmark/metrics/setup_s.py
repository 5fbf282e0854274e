"""Seconds from the start of the process to the start of the window:
imports, scene, weights, model, warm-up and capture."""


def read(record):
    return record["window_start"] - record["process_start"]
