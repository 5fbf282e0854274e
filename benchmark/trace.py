"""The traced part of a run: ``torch.profiler`` over a few steps or frames,
reduced to device-busy intervals, device time by kernel kind and the
breakdown that the result line carries.

The busy share is the union of the device's intervals (kernels, copies,
fills) within the profiled interval, never a sum of durations: kernels of
two streams overlap, and their sum can pass the interval."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

WINDOW_LABEL = "bench.profiled"

# device-op name fragments → kind, first match wins (as the program's
# chip_smoke.py::KERNEL_KINDS)
KERNEL_KINDS = (
    ("K1", ("scatter_levels_kernel",)),
    ("NCCL", ("nccl",)),
    ("matmul", ("gemm", "gemv", "Kernel2", "xmma")),
    ("layer_norm", ("layer_norm",)),
    ("sin/cos (SIREN)", ("sin_kernel", "cos_kernel")),
    ("gather/scatter", ("index", "gather", "scatter")),
    ("reduce/scan/sort", ("reduce", "scan", "cumsum", "cumprod", "sort", "softmax")),
    ("copy/fill", ("copy", "fill", "Memcpy", "Memset")),
    ("elementwise", ("elementwise", "Functor")),
)


def kind_of(name: str) -> str:
    return next((k for k, keys in KERNEL_KINDS if any(s in name for s in keys)), "other")


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals covering exactly what ``intervals`` cover."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class Trace:
    """Times in seconds.  ``device``: (name, start, end) of every device
    operation of the ``units`` steps or frames profiled; ``host``: (name,
    start, end) of the host's operations; ``window``: (start, end) of the
    interval over which the busy and idle shares are taken."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    units: int

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window
        return [(max(s, w0), min(e, w1)) for s, e in union([(s, e) for _, s, e in self.device]) if e > w0 and s < w1]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def kind_s(self, kind: str) -> float:
        return sum(e - s for n, s, e in self.device if kind_of(n) == kind)

    def name_s(self, fragment: str) -> float:
        return sum(e - s for n, s, e in self.device if fragment in n)

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:200], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest intervals of the window in which the device ran
        nothing, each named by the innermost host operation running at its
        middle."""
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy() for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (s + e) / 2
            covering = [(hs, n) for n, hs, he in self.host if hs <= mid <= he]
            out.append([max(covering)[1][:200] if covering else "host: no operation recorded", e - s])
        return out

    def breakdown(self) -> Dict[str, List]:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def profile(fn: Callable[[], int], device, unit_label: str) -> Trace:
    """``fn()`` (which returns the steps or frames it ran) under the
    profiler, with the device synchronised before it and at its end.  The
    device time of every unit counts; the busy and idle shares are taken
    from where the second unit's host span ``unit_label``
    (``spans.Recorder``'s label of the call that begins a step or frame)
    begins to the end: the first unit starts on a device left idle by the
    synchronise, which no step of a running loop does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_LABEL):
            torch.cuda.synchronize(device)
            units = fn()
            torch.cuda.synchronize(device)
    dev, host, window, starts = [], [], None, []
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.name, s, t))
        elif e.name == WINDOW_LABEL:
            window = (s, t)
        else:
            host.append((e.name, s, t))
            if e.name == unit_label:
                starts.append(s)
    if window is None or len(starts) != units or units < 2:
        raise RuntimeError(f"the profiler recorded {len(starts)} of {units} '{unit_label}' spans and "
                           f"{'a' if window else 'no'} window")
    return Trace(dev, host, (sorted(starts)[1], window[1]), units)
