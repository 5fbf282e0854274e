"""Host milliseconds a step in ``DataManager.next_train`` (the pixel
sampler, the sky rays and the copies to the card), from the benchmark's
span around each call in the window."""

from benchmark.metrics._stats import mean_ms


def read(record):
    return mean_ms(record["spans"].get("next_train"))
