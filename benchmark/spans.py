"""Host spans from the benchmark's own side: a method of a program object
wrapped so that each call's wall time is kept (and, under the profiler,
labelled ``bench.<method>``)."""

from __future__ import annotations

import time
from typing import Dict, List


class Recorder:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.durations: Dict[str, List[float]] = {}
        self._wrapped: List = []

    def wrap(self, obj, name: str) -> None:
        """Time every call of ``obj.<name>`` (an instance attribute shadows
        the method until :meth:`unwrap`)."""
        if not self.enabled:
            return
        from torch.profiler import record_function

        inner = getattr(obj, name)
        out = self.durations.setdefault(name, [])
        label = f"bench.{name}"

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with record_function(label):
                result = inner(*args, **kwargs)
            out.append(time.perf_counter() - t0)
            return result

        setattr(obj, name, timed)
        self._wrapped.append((obj, name, name in vars(obj), inner))

    def unwrap(self) -> None:
        for obj, name, own, inner in reversed(self._wrapped):
            if own:
                setattr(obj, name, inner)
            else:
                delattr(obj, name)
        self._wrapped = []
