"""Captured functions: a training step, a fit step or a forward run as one
CUDA graph replay a call, the port's counterpart of JAX's one jitted
executable a call (``jax.jit(step_fn, donate_argnums=(0, 1))``,
``neusky_tpu/parallel/mesh.py:80-115``; the trainers', fits', render
chunk's and LPIPS's ``jax.jit`` in ``neusky_tpu/engine/``).

:class:`CapturedStep` wraps ``fn(params, step, *inputs)``: the eager
function with its random draws passed in (``models/pipeline.py::draw_step``
and the trainers' own ``draw_step``), so that it reads nothing from the
host and draws nothing.  ``step`` is a float, a 0-d tensor or None (``fn``
then gets None).  A call:

1. checks the params: with an ``optimizer`` (a step that updates them in
   place, as JAX donates them) they must be the tensors of the first call,
   and other params raise; without one (a forward) the graph reads its own
   copy of the first call's params, into which a call copies the params it
   is given unless they are the last call's tensors and nothing has written
   them since, so one graph serves every call of a shared function (the
   render of every image, whatever tree its params come in) and copies
   once per params tree, not once a call;
2. checks that ``inputs`` (and a forward's params) have the first call's
   structure, shapes, dtypes and devices, and raises otherwise: it never
   runs a changed call eagerly;
3. copies the inputs into static buffers and the step into a static 0-d
   float32 tensor;
4. the first call runs ``fn`` eagerly on a side stream, a real call (it
   creates the Adam state and cuBLAS's and cuDNN's handles, fills the
   per-device constant caches and loads K1); the next call captures ``fn``
   into a ``torch.cuda.CUDAGraph`` with a private memory pool of its own
   (its wall time is ``capture_s``) and every call from then on replays it;
5. returns copies of the graph's static outputs: nothing waits for the
   card unless the caller reads them.

A capture drops the optimizer's gradients and collects garbage first,
and a capture that fails raises.  An
optimizer's ``generation`` (``GroupedAdam`` moves it when its state is
loaded anew; an optimizer without one never moves) makes the next call
warm up and capture again over the new state tensors.  Calls are
serialised by a lock (the viewer renders from its server's threads).

A mesh rank's step (``collectives=True``: :mod:`~neusky_torch.parallel.
mesh` over NCCL) holds its ``all_reduce`` calls in its graph: NCCL runs
them on a stream the capture joins.  The eager first call meets every
communicator the step uses (NCCL makes one at its first collective, which
a capture cannot do); the capture runs in ``"thread_local"`` mode (NCCL's
watchdog thread queries events while this thread captures); and the ranks
capture and replay in lockstep, since each makes the same calls in the
same order: the same first calls, the same ``generation`` moves (every
rank loads the checkpoint), the same structure checks.  A rank whose
capture fails raises and never runs the step eagerly; the others then
wait in a replayed collective, which no time limit of the process group
watches, until ``launch.run_ranks`` stops every rank as the failed one
exits.  Gloo's collectives run on the host and cannot be captured.

Counters (``utils/profiling.py::count``; K1's launch counter,
``ops/hashgrid_cuda.py``, counts Python calls of its wrapper) count work
that ran: a capture records work without running it, so the counts it made
are taken back and made again on each replay.  ``graph.replays`` counts the
replays.  With the port's tracing on, a call's host parts are spans
(``graph.warmup``; ``graph.capture`` with ``graph.gc``;
``graph.copy_inputs``; ``graph.replay``), and the device spans entered
while ``fn`` is captured are timed on every replay: their events are read
before the next replay where the last replay has completed.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
import weakref
from typing import Any, Callable, List, Optional

import torch

from neusky_torch.tree import tree_leaves
from neusky_torch.utils import profiling
from neusky_torch.utils.profiling import span

# calls of the steps that update their params in place: a replay writes them
# without moving their version counters, so a forward reads this count to
# tell that params it already holds were written
writes = 0


def flatten(tree, leaves: List[torch.Tensor]):
    """Append the tensors of ``tree`` (dicts, lists, tuples, dataclasses
    such as ``RayBundle`` and ``Cameras``; other values are constants) to
    ``leaves`` → its structure: a hashable value, equal for two trees of
    the same keys, constants, shapes, dtypes and devices."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("dict", tuple(tree), tuple(flatten(v, leaves) for v in tree.values()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(flatten(v, leaves) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree) if f.init)
        return (type(tree), names, tuple(flatten(getattr(tree, n), leaves) for n in names))
    return ("constant", tree)


def unflatten(spec, leaves) -> Any:
    """The tree of structure ``spec`` over the tensors of the iterator
    ``leaves`` (the inverse of :func:`flatten`)."""
    kind = spec[0]
    if kind == "tensor":
        return next(leaves)
    if kind == "constant":
        return spec[1]
    if kind == "dict":
        return {k: unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    if kind in (list, tuple):
        return kind(unflatten(s, leaves) for s in spec[1])
    return kind(**{n: unflatten(s, leaves) for n, s in zip(spec[1], spec[2])})


def use_graph(graphed: Optional[bool], device: torch.device, eager_reason: Optional[str] = None) -> bool:
    """Whether a factory given ``graphed`` captures on ``device``: None
    captures on a CUDA device (unless ``eager_reason`` says why the call
    runs eagerly there: a gloo mesh), False runs eagerly, True captures and
    raises with an ``eager_reason`` or on the CPU."""
    if graphed is None:
        return device.type == "cuda" and eager_reason is None
    if graphed and eager_reason is not None:
        raise ValueError(f"graphed=True {eager_reason}")
    if graphed and device.type != "cuda":
        raise ValueError(f"graphed=True needs a CUDA device, not {device}")
    return bool(graphed)


class CapturedStep:
    """``fn(params, step, *inputs)`` run as one CUDA graph replay a call;
    see the module docstring.  ``optimizer``: what ``fn`` steps (a
    ``GroupedAdam`` or a capturable ``torch.optim.Adam``), or None for a
    forward.  ``collectives``: ``fn`` runs NCCL collectives (a mesh rank's
    step; see the module docstring)."""

    def __init__(self, fn: Callable, optimizer=None, collectives: bool = False):
        self.fn = fn
        self.optimizer = optimizer
        self.collectives = collectives
        self.capture_s: Optional[float] = None
        self.replays = 0
        self._lock = threading.Lock()
        self._params: Optional[List[torch.Tensor]] = None
        self._n_params = 0
        self._seen: Optional[tuple] = None
        self._spec = None
        self._static: List[torch.Tensor] = []
        self._static_params = None
        self._static_inputs: tuple = ()
        self._step: Optional[torch.Tensor] = None
        self._reset()

    def _generation_now(self) -> int:
        return getattr(self.optimizer, "generation", 0)

    def _reset(self) -> None:
        """Drop the graph: the next calls warm up and capture again."""
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out_spec = None
        self._out: List[torch.Tensor] = []
        self._counts = {}
        self._events: Optional[profiling.GraphEvents] = None
        self._warm = False
        self._generation = self._generation_now()

    def _check(self, params, step, inputs) -> List[torch.Tensor]:
        flat: List[torch.Tensor] = []
        if self.optimizer is None:  # a forward: its params are inputs, the first of them
            p_spec = flatten(params, flat)
            self._n_params = len(flat)
            # flatten((params, step is None, inputs), flat), the params' count taken between
            spec = (tuple, (p_spec, flatten(step is None, flat), flatten(inputs, flat)))
            leaves: List[torch.Tensor] = []
        else:
            spec = flatten((step is None, inputs), flat)
            leaves = tree_leaves(params)
            if self._params is None:
                self._params = leaves
            elif len(leaves) != len(self._params) or any(a is not b for a, b in zip(leaves, self._params)):
                raise ValueError("a captured step takes the params it was first called with (it updates those "
                                 "tensors in place); build a new step for other params")
        if self._spec is None:
            if not flat + leaves or any(t.device.type != "cuda" for t in flat + leaves):
                raise ValueError("a captured step takes CUDA tensors only")
            self._spec = spec
            self._static = [t.detach().clone() for t in flat]
            static = unflatten(spec, iter(self._static))
            if self.optimizer is None:
                self._static_params, _, self._static_inputs = static
            else:
                self._static_params, self._static_inputs = params, static[1]
            if step is not None:
                self._step = torch.zeros((), dtype=torch.float32, device=(flat + leaves)[0].device)
        elif spec != self._spec:
            raise ValueError("a captured step's inputs changed structure, shape, dtype, device or a constant "
                             f"since its first call:\n  now   {spec}\n  first {self._spec}")
        return flat

    def __call__(self, params, step, *inputs):
        with self._lock:
            return self._call(params, step, inputs)

    def _call(self, params, step, inputs):
        global writes
        flat = self._check(params, step, inputs)
        if self._generation_now() != self._generation:
            self._reset()
        start = self._n_params if self._params_seen(flat[:self._n_params]) else 0
        with span("graph.copy_inputs"), torch.no_grad():
            for static, t in zip(self._static[start:], flat[start:]):
                if static is not t:
                    static.copy_(t)
            if isinstance(step, torch.Tensor):
                self._step.copy_(step)
            elif step is not None:
                self._step.fill_(float(step))
        if self.optimizer is not None:
            writes += 1
        if not self._warm:
            self._warm = True
            with span("graph.warmup"):
                return self._run_on_side_stream()
        if self.graph is None:
            self._capture()
        if self._events is not None:
            self._events.collect()
        with span("graph.replay"):
            self.graph.replay()
            self.replays += 1
            profiling.count("graph.replays")
            for name, n in self._counts.items():
                profiling.count(name, n)
            if self._events is not None:
                self._events.replayed()
        return unflatten(self._out_spec, (t.clone() for t in self._out))

    def _params_seen(self, leaves: List[torch.Tensor]) -> bool:
        """Whether a forward's param ``leaves`` are the tensors of its last
        call, unwritten since (no version counter and no :data:`writes`
        moved), so that the graph's copy of them is current.  Inference
        tensors keep no version counter and are always copied."""
        if not leaves or any(t.is_inference() for t in leaves):
            self._seen = None
            return False
        stamp = (writes, tuple(t._version for t in leaves))
        seen = (self._seen is not None and self._seen[0] == stamp and len(self._seen[1]) == len(leaves)
                and all(r() is t for r, t in zip(self._seen[1], leaves)))
        self._seen = (stamp, [weakref.ref(t) for t in leaves])
        return seen

    def _device(self) -> torch.device:
        return self._static[0].device if self._static else self._params[0].device

    def _run_on_side_stream(self):
        main = torch.cuda.current_stream(self._device())
        side = torch.cuda.Stream(self._device())
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(self._static_params, self._step, *self._static_inputs)
        main.wait_stream(side)
        return out

    def _capture(self) -> None:
        stream = torch.cuda.current_stream(self._device())
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with span("graph.capture"):
            # the eager call's gradients go first: the step makes its own
            # (every step function zeroes them before its backward), and
            # blocks freed only inside the capture would keep the eager
            # call's segments reserved beside the graph's pool
            zero_grad = getattr(self.optimizer, "zero_grad", None)
            if zero_grad is not None:
                zero_grad()
            # torch.cuda.graph empties the allocator's cache before it
            # captures but no longer collects garbage: the memory pools of
            # graphs in a dead reference cycle would stay reserved, and a
            # capture short of memory fails
            with span("graph.gc"):
                gc.collect()
            # NCCL's watchdog thread queries the events of the collectives it
            # tracks; under the default "global" mode a query from another
            # thread while this one captures invalidates the capture
            mode = "thread_local" if self.collectives else "global"
            try:
                with profiling.counts_taken_back() as counts, profiling.capturing() as events, \
                        torch.cuda.graph(graph, capture_error_mode=mode):
                    out = self.fn(self._static_params, self._step, *self._static_inputs)
            except Exception as e:
                torch.cuda.set_stream(stream)  # a failed capture_end leaves the capture stream current
                raise RuntimeError("capturing the step as a CUDA graph failed (it is not run eagerly instead)") from e
        self.capture_s = time.perf_counter() - t0
        self._out = []
        self.graph, self._out_spec, self._counts = graph, flatten(out, self._out), counts
        self._events = events if events.spans else None
