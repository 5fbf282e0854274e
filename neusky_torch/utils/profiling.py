"""Profiling (mirror of ``neusky_tpu/utils/profiling.py``): a per-function
wall-clock table, as nerfstudio's ``profiler.time_function`` keeps on the
reference pipeline's entry points, and a ``torch.profiler`` trace of a
block, written as a Chrome trace (open it in ``chrome://tracing`` or
Perfetto; the JAX package writes an XLA trace there).

The port's own tracing, off by default (:func:`enable`, :func:`enabled`,
:func:`reset`):

- **Spans.**  ``with span(name):`` at the port's layer boundaries.  Off, it
  returns one shared no-op context after a single flag check.  On, it opens
  a ``torch.profiler.record_function`` range (so a trace shows the span on
  the profiler's clock beside the device's work) and adds its wall time to
  the table, keyed by its path (the open spans' names joined by ``/``),
  with its calls, total and self time (the span less the part its children
  cover).
- **Device spans.**  A span given a CUDA ``device``, and every span opened
  inside one, also records a pair of timing events on the current stream
  (``torch.cuda.Event(enable_timing=True, external=True)``).  Under a
  stream capture they become event-record nodes of the graph, timed again
  on every replay; :class:`~neusky_torch.parallel.graphs.CapturedStep`
  holds them (:func:`capturing`).  Events are read only once the last of
  them reports complete (``Event.query()``), at points the host reaches
  anyway (before the graph's next replay, at the trainer's log read, at the
  viewer's copy to the host, in :func:`snapshot`), so reading adds no wait;
  a replay whose events the next replay overwrites before they completed is
  not sampled.  Each sample is kept as offsets from its first event; eager
  and replayed samples are kept apart.  Device paths join the device spans'
  names alone (``step/scene/visibility``).
- **Counters.**  ``count(name, n)``, keyed by the innermost open span's
  path.  A count made while a graph is captured is taken back and made
  again on each replay (:func:`counts_taken_back`), so a counter counts work
  that ran.  Counters count with tracing off too (K1's launches,
  ``ops/hashgrid_cuda.py::launches``, are read by tests and the card's
  smoke run); :data:`totals` reads a counter summed over its paths.  With
  tracing on, ``host.syncs`` counts the host–device synchronisations the
  program makes, from ``torch.cuda.set_sync_debug_mode("warn")``'s warnings,
  which are counted and not shown.

A span entered while autograd runs a backward (on its worker thread, or in
a checkpointed recomputation) records nothing: that time counts in the
span around the ``backward()`` call, once.  Tables are aggregated by path,
so their size does not grow with the steps; each device path keeps its
:data:`RECENT` latest samples for a median.
"""

from __future__ import annotations

import collections
import collections.abc
import contextlib
import functools
import os
import threading
import time
import warnings
import weakref
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# path (or time_function's qualified name) → [calls, total_s, self_s]
_TIMINGS: Dict[str, list] = {}
# counter name → path of the innermost open span ("" outside spans or with tracing off) → count
_COUNTS: Dict[str, Dict[str, int]] = collections.defaultdict(lambda: collections.defaultdict(int))

RECENT = 4096  # latest samples kept per device path
SYNCS = "host.syncs"
_SYNC_WARNING = "called a synchronizing CUDA operation"
_SYNC_NOTICE = "Synchronization debug mode is a prototype"  # shown once as the mode turns on

_on = False
_local = threading.local()
_lock = threading.RLock()


def time_function(fn):
    """Decorator: accumulate wall-clock timings per function name."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _add_time(fn.__qualname__, time.perf_counter() - t0, 0.0)
        return out

    return wrapper


def _add_time(key: str, total: float, children: float) -> None:
    with _lock:
        row = _TIMINGS.setdefault(key, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += total
        row[2] += total - children


def profiler_summary() -> Dict[str, Dict[str, float]]:
    """Per-function {calls, total_s, mean_s} table (ns-train style): the
    ``time_function`` rows and the spans' paths."""
    return {name: {"calls": row[0], "total_s": row[1], "mean_s": row[1] / row[0]} for name, row in _TIMINGS.items()}


def reset_profiler():
    _TIMINGS.clear()


# ---------------------------------------------------------------------------
# the switch


def enable(on: bool = True) -> None:
    """Turn the port's tracing on or off.  On a card, on also turns on
    CUDA's sync debug mode to count ``host.syncs``, and off restores it."""
    global _on
    if on == _on:
        return
    _on = on
    if torch.cuda.is_available():
        _SyncCounter.install() if on else _SyncCounter.uninstall()


def enabled() -> bool:
    return _on


def reset() -> None:
    """Empty every table: the spans', the counters' (K1's launch count
    too) and the device samples; pending samples are dropped."""
    with _lock:
        _TIMINGS.clear()
        _COUNTS.clear()
        for table in _DEVICE.values():
            table.clear()
        _EAGER.clear()
        for g in list(_GRAPHS):
            g.pending = False


# ---------------------------------------------------------------------------
# spans


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, device: Optional[torch.device] = None):
    """A context over a part of the program; see the module docstring.
    ``device``: the part's work runs on it (a device span; spans opened
    inside one are device spans on its device)."""
    if not _on:
        return _NO_SPAN
    return _Span(name, device)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _path() -> str:
    s = getattr(_local, "stack", None)
    return s[-1].path if s else ""


class _Span:
    __slots__ = ("name", "device", "path", "dpath", "t0", "children", "rf", "row", "skip")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.device = name, device

    def __enter__(self):
        self.skip = torch._C._current_graph_task_id() != -1  # autograd runs a backward
        if self.skip:
            return self
        stack = _stack()
        parent = stack[-1] if stack else None
        self.path = f"{parent.path}/{self.name}" if parent else self.name
        if parent is not None and parent.dpath is not None:
            self.device, self.dpath = parent.device, f"{parent.dpath}/{self.name}"
        else:
            self.dpath = self.name if self.device is not None else None
        stack.append(self)
        self.children = 0.0
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.row = None
        if self.dpath is not None and torch.device(self.device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True, external=True)
            start.record()
            self.row = _group().begin(self.dpath, start)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.skip:
            return False
        dt = time.perf_counter() - self.t0
        if self.row is not None:
            end = torch.cuda.Event(enable_timing=True, external=True)
            end.record()
            group = _group()
            group.end(self.row, end)
            if self.dpath == self.name and group is not getattr(_local, "capture", None):
                group.close()  # an eager root: its sample waits to be read
        self.rf.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].children += dt
        _add_time(self.path, dt, self.children)
        return False


# ---------------------------------------------------------------------------
# device samples


class _Table:
    """Device samples of one kind (eager or replayed), by device path."""

    def __init__(self):
        self.samples = 0
        self.rows: Dict[str, list] = {}  # path → [calls, total_ms, self_ms, recent per-sample ms]

    def clear(self) -> None:
        self.samples = 0
        self.rows.clear()

    def add(self, spans: List[Tuple[str, float, float]]) -> None:
        """One sample: (path, start, end) of each span, ms from its first
        event.  Self time is a span less its direct children inside it."""
        per: Dict[str, float] = {}
        for path, s, e in spans:
            inner = sum(ce - cs for cp, cs, ce in spans
                        if cp.rpartition("/")[0] == path and cs >= s and ce <= e)
            row = self.rows.setdefault(path, [0, 0.0, 0.0, collections.deque(maxlen=RECENT)])
            row[0] += 1
            row[1] += e - s
            row[2] += e - s - inner
            per[path] = per.get(path, 0.0) + e - s
        for path, ms in per.items():
            self.rows[path][3].append(ms)
        self.samples += 1

    def plain(self) -> Dict:
        return {"samples": self.samples,
                "spans": {p: {"calls": r[0], "total_ms": r[1], "self_ms": r[2], "recent_ms": list(r[3])}
                          for p, r in self.rows.items()}}


_DEVICE = {"replay": _Table(), "eager": _Table()}


class GraphEvents:
    """The device spans' events of one group: an eager root span's, or the
    spans captured into one graph.  ``spans``: [path, start, end] in the
    order they were entered; ``last``: the event recorded last."""

    def __init__(self):
        self.spans: List[list] = []
        self.last: Optional[torch.cuda.Event] = None
        self.pending = False

    def begin(self, path: str, start) -> list:
        row = [path, start, None]
        self.spans.append(row)
        return row

    def end(self, row: list, end) -> None:
        row[2] = end
        self.last = end

    def read(self) -> Optional[List[Tuple[str, float, float]]]:
        """The sample as (path, start ms, end ms) from the first event, or
        None while the last event has not completed."""
        if self.last is None or not self.last.query():
            return None
        first = self.spans[0][1]
        at = lambda e: 0.0 if e is first else first.elapsed_time(e)  # noqa: E731
        return [(p, at(s), at(e)) for p, s, e in self.spans]

    def close(self) -> None:
        """An eager group is complete: queue it to be read."""
        with _lock:
            _EAGER.append(self)
        _local.eager = GraphEvents()

    def collect(self) -> None:
        """The last replay's sample, if its events have completed (a graph
        about to be replayed again, whose events the replay overwrites)."""
        if self.pending:
            sample = self.read()
            self.pending = False
            if sample is not None:
                with _lock:
                    _DEVICE["replay"].add(sample)

    def replayed(self) -> None:
        self.pending = True


_EAGER: "collections.deque[GraphEvents]" = collections.deque(maxlen=RECENT)
_GRAPHS: "weakref.WeakSet[GraphEvents]" = weakref.WeakSet()


def _group() -> GraphEvents:
    g = getattr(_local, "capture", None)
    if g is not None:
        return g
    if getattr(_local, "eager", None) is None:
        _local.eager = GraphEvents()
    return _local.eager


@contextlib.contextmanager
def capturing() -> Iterator[GraphEvents]:
    """Collect the events of the device spans entered in the block (a
    graph capture on this thread) → the group, to be replayed with the
    graph: call its ``collect()`` before each replay and ``replayed()``
    after it.  Empty where tracing is off."""
    g = GraphEvents()
    prev = getattr(_local, "capture", None)
    _local.capture = g
    try:
        yield g
    finally:
        _local.capture = prev
    if g.spans:
        with _lock:
            _GRAPHS.add(g)


def collect() -> None:
    """Read every sample whose events have completed, without waiting."""
    for g in list(_GRAPHS):
        g.collect()
    with _lock:
        while _EAGER:
            sample = _EAGER[0].read()
            if sample is None:
                break
            _EAGER.popleft()
            _DEVICE["eager"].add(sample)


# ---------------------------------------------------------------------------
# counters


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` at the innermost open span's path."""
    with _lock:
        _COUNTS[name][_path() if _on else ""] += n


class _Totals(collections.abc.MutableMapping):
    """Each counter summed over its paths (0 for a name never counted);
    setting one replaces its paths by that total at no path (``launches[
    KERNEL_NAME] = 0`` zeroes K1's count)."""

    def __getitem__(self, name: str) -> int:
        return sum(_COUNTS.get(name, {}).values())

    def __setitem__(self, name: str, n: int) -> None:
        with _lock:
            _COUNTS[name] = collections.defaultdict(int, {"": n})

    def __delitem__(self, name: str) -> None:
        with _lock:
            del _COUNTS[name]

    def __iter__(self):
        return iter(list(_COUNTS))

    def __len__(self) -> int:
        return len(_COUNTS)


totals = _Totals()


@contextlib.contextmanager
def counts_taken_back() -> Iterator[Dict[str, int]]:
    """The counts made in the block are taken back and left in the dict it
    yields, by counter name (a capture records work without running it; the
    caller makes them again on each replay)."""
    with _lock:
        before = {k: dict(v) for k, v in _COUNTS.items()}
    made: Dict[str, int] = {}
    try:
        yield made
    finally:
        with _lock:
            for name, paths in list(_COUNTS.items()):
                old = before.get(name, {})
                for path, n in list(paths.items()):
                    d = n - old.get(path, 0)
                    if d:
                        made[name] = made.get(name, 0) + d
                        if n - d:
                            paths[path] = n - d
                        else:
                            del paths[path]
                if not paths:
                    del _COUNTS[name]


class _SyncCounter:
    """``host.syncs`` from CUDA's sync debug mode: its warnings are counted
    at the innermost span and not shown."""

    prev_mode = 0
    prev_show = None

    @classmethod
    def install(cls) -> None:
        cls.prev_mode = torch.cuda.get_sync_debug_mode()
        cls.prev_show = warnings.showwarning
        warnings.filterwarnings("always", message=_SYNC_WARNING)

        def show(message, category, filename, lineno, file=None, line=None):
            text = str(message)
            if _SYNC_WARNING in text:
                count(SYNCS)
            elif _SYNC_NOTICE not in text:
                cls.prev_show(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")

    @classmethod
    def uninstall(cls) -> None:
        torch.cuda.set_sync_debug_mode(cls.prev_mode)
        warnings.showwarning = cls.prev_show
        warnings.filters[:] = [f for f in warnings.filters if getattr(f[1], "pattern", None) != _SYNC_WARNING]
        getattr(warnings, "_filters_mutated", lambda: None)()


# ---------------------------------------------------------------------------
# reading


def snapshot() -> Dict:
    """The tables as plain data, after reading every completed sample:
    ``host`` (path → calls, total_s, self_s; ``time_function``'s rows too),
    ``counters`` (name → path → count) and ``device`` (``replay`` and
    ``eager``: samples, and path → calls, total_ms, self_ms, recent_ms)."""
    collect()
    with _lock:
        return {
            "host": {p: {"calls": r[0], "total_s": r[1], "self_s": r[2]} for p, r in _TIMINGS.items()},
            "counters": {name: dict(paths) for name, paths in _COUNTS.items()},
            "device": {kind: table.plain() for kind, table in _DEVICE.items()},
        }


@contextlib.contextmanager
def trace_context(logdir: str = "outputs/trace"):
    """Trace the enclosed block with ``torch.profiler`` (host ops, and the
    card's kernels where CUDA is available) and write it to
    ``<logdir>/trace_<pid>_<n>.json`` on exit; yields ``logdir``.  With
    tracing on (:func:`enable`) the program's spans are ranges of it."""
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
    axis), by the plain query or the fused kernel alike, the forward's
    alone (a checkpoint's recomputation is not a query): ``counts[0]`` of
    the list it yields."""
    counts = [0]
    query = model._ddf_query

    def counted(p, origins, directions):
        counts[0] += origins.shape[0]
        return query(p, origins, directions)

    model._ddf_query = counted
    try:
        yield counts
    finally:
        del model._ddf_query
