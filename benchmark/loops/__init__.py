"""Window loops: ``run(cell, config, seeds, seconds, traced, device)``
sets a cell up, measures its window and checks what the window produced
against the reference, and returns the run's record for the metric
readers (``metrics/``)."""
