"""Profiling (mirror of ``neusky_tpu/utils/profiling.py``): a per-function
wall-clock table, as nerfstudio's ``profiler.time_function`` keeps on the
reference pipeline's entry points, and a ``torch.profiler`` trace of a
block, written as a Chrome trace (open it in ``chrome://tracing`` or
Perfetto; the JAX package writes an XLA trace there)."""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch

_TIMINGS: Dict[str, list] = defaultdict(list)


def time_function(fn):
    """Decorator: accumulate wall-clock timings per function name."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _TIMINGS[fn.__qualname__].append(time.perf_counter() - t0)
        return out

    return wrapper


def profiler_summary() -> Dict[str, Dict[str, float]]:
    """Per-function {calls, total_s, mean_s} table (ns-train style)."""
    return {name: {"calls": len(times), "total_s": sum(times), "mean_s": sum(times) / len(times)}
            for name, times in _TIMINGS.items()}


def reset_profiler():
    _TIMINGS.clear()


@contextlib.contextmanager
def trace_context(logdir: str = "outputs/trace"):
    """Trace the enclosed block with ``torch.profiler`` (host ops, and the
    card's kernels where CUDA is available) and write it to
    ``<logdir>/trace_<pid>_<n>.json`` on exit; yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len(list(out.glob(f"trace_{os.getpid()}_*.json")))
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{n}.json"))


@contextlib.contextmanager
def count_visibility_queries(model):
    """Count the (point, direction) queries ``model.compute_visibility``
    hands the DDF inside the block (a rank's share on a ``dirs`` mesh
    axis): ``counts[0]`` of the list it yields."""
    counts, inside = [0], [False]
    apply, vis = model.ddf.apply, model.compute_visibility

    def counted_apply(p, o, d):
        if inside[0]:
            counts[0] += o.shape[0]
        return apply(p, o, d)

    def counted_vis(*a, **k):
        inside[0] = True
        try:
            return vis(*a, **k)
        finally:
            inside[0] = False

    model.ddf.apply, model.compute_visibility = counted_apply, counted_vis
    try:
        yield counts
    finally:
        del model.ddf.apply, model.compute_visibility
