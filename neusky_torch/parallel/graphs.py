"""Captured steps: a training or eval-latent step run as one CUDA graph
replay a call, the port's counterpart of JAX's one jitted executable a step
(``jax.jit(step_fn, donate_argnums=(0, 1))``, ``neusky_tpu/parallel/mesh.py:80-115``).

:class:`CapturedStep` wraps ``fn(params, step, *inputs)``: the eager step
with its random draws passed in (``models/pipeline.py::draw_step``), so
that it reads nothing from the host and draws nothing.  A call:

1. checks that ``params`` are the tensors of the first call (the graph
   reads and updates them in place, as JAX donates them) and that
   ``inputs`` have the first call's structure, shapes, dtypes and devices,
   and raises otherwise: it never runs a changed call eagerly;
2. copies the inputs into static buffers and the step (a float or a 0-d
   tensor) into a static 0-d float32 tensor;
3. the first call runs ``fn`` eagerly on a side stream, a real step (it
   creates the Adam state and cuBLAS's handles, and loads K1); the next
   call captures ``fn`` into a ``torch.cuda.CUDAGraph`` (its wall time is
   ``capture_s``) and every call from then on replays it;
4. returns copies of the graph's static outputs: nothing waits for the
   card unless the caller reads them.

A capture that fails raises.  The optimizer's ``generation`` moves when
its state is loaded anew (``GroupedAdam.load_state_dict``): the next call
then warms up and captures again over the new state tensors.

K1's launch counter (``ops/hashgrid_cuda.py``) counts Python calls of its
wrapper.  A capture records K1's launches without running them, so the
count it made is taken back and added once per replay: the counter counts
launches that ran.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import torch

from neusky_torch.ops import hashgrid_cuda
from neusky_torch.tree import tree_leaves


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


class CapturedStep:
    """``fn(params, step, *inputs)`` run as one CUDA graph replay a call;
    see the module docstring.  ``optimizer`` is the ``GroupedAdam`` that
    ``fn`` steps."""

    def __init__(self, fn: Callable, optimizer):
        self.fn = fn
        self.optimizer = optimizer
        self.capture_s: Optional[float] = None
        self.replays = 0
        self._params: Optional[List[torch.Tensor]] = None
        self._spec = None
        self._static: List[torch.Tensor] = []
        self._static_inputs: tuple = ()
        self._step: Optional[torch.Tensor] = None
        self._reset()

    def _reset(self) -> None:
        """Drop the graph: the next calls warm up and capture again."""
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out_spec = None
        self._out: List[torch.Tensor] = []
        self._launches = {}
        self._warm = False
        self._generation = self.optimizer.generation

    def _check(self, params, inputs) -> List[torch.Tensor]:
        leaves = tree_leaves(params)
        if self._params is None:
            self._params = leaves
        elif len(leaves) != len(self._params) or any(a is not b for a, b in zip(leaves, self._params)):
            raise ValueError("a captured step takes the params it was first called with (it updates those "
                             "tensors in place); build a new step for other params")
        flat: List[torch.Tensor] = []
        spec = flatten(inputs, flat)
        if self._spec is None:
            if any(t.device.type != "cuda" for t in flat + leaves):
                raise ValueError("a captured step takes CUDA tensors only")
            self._spec = spec
            self._static = [t.detach().clone() for t in flat]
            self._static_inputs = unflatten(spec, iter(self._static))
            self._step = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        elif spec != self._spec:
            raise ValueError("a captured step's inputs changed structure, shape, dtype, device or a constant "
                             f"since its first call:\n  now   {spec}\n  first {self._spec}")
        return flat

    def __call__(self, params, step, *inputs):
        flat = self._check(params, inputs)
        if self.optimizer.generation != self._generation:
            self._reset()
        with torch.no_grad():
            for static, t in zip(self._static, flat):
                if static is not t:
                    static.copy_(t)
            if isinstance(step, torch.Tensor):
                self._step.copy_(step)
            else:
                self._step.fill_(float(step))
        if not self._warm:
            self._warm = True
            return self._run_on_side_stream(params)
        if self.graph is None:
            self._capture(params)
        self.graph.replay()
        self.replays += 1
        for name, n in self._launches.items():
            hashgrid_cuda.launches[name] += n
        return unflatten(self._out_spec, (t.clone() for t in self._out))

    def _run_on_side_stream(self, params):
        main = torch.cuda.current_stream(self._step.device)
        side = torch.cuda.Stream(self._step.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(params, self._step, *self._static_inputs)
        main.wait_stream(side)
        return out

    def _capture(self, params) -> None:
        before = dict(hashgrid_cuda.launches)
        stream = torch.cuda.current_stream(self._step.device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                out = self.fn(params, self._step, *self._static_inputs)
        except Exception as e:
            torch.cuda.set_stream(stream)  # a failed capture_end leaves the capture stream current
            raise RuntimeError("capturing the step as a CUDA graph failed (it is not run eagerly instead)") from e
        finally:
            captured = {k: hashgrid_cuda.launches[k] - before.get(k, 0) for k in hashgrid_cuda.launches}
            hashgrid_cuda.launches.update(before)
        self.capture_s = time.perf_counter() - t0
        self._out = []
        self.graph, self._out_spec, self._launches = graph, flatten(out, self._out), captured
