"""Device milliseconds a RENI training step spends in ``reni_step/backward``
(the decoder's and the posteriors' gradients): the median over the
window's sampled replays, from the program's own device span."""

from benchmark.metrics._program import replay_span_ms


def read(record):
    return replay_span_ms(record, "reni_step/backward")
