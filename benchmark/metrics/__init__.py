"""One reader a metric, found by the metric's name: ``<name>.py`` defines
``read(record) -> float | None``, where ``record`` is what a window loop
returned (``loops/``).  A reader that finds nothing to read returns None
and the metric is left out of the line."""
