"""Training steps, alone or as one rank of a device mesh (mirror of
``neusky_tpu/parallel/mesh.py``): value and grad of the loss, then the
optimizer update.

The mesh replaces the reference's DDP (``neusky_pipeline.py:197-200``) as
JAX's does, on ``torch.distributed``: a ``DeviceMesh`` with JAX's axis
names, ``("data",)`` or ``("data", "dirs")``, one process a rank.  Each rank
holds the whole parameters (:func:`replicate`) and its ``data`` shard of
the batch's rays (:func:`shard_batch`); the ranks of a ``dirs`` group hold
the same rays and split the visibility queries over the light directions
(``NeuSkyModel.set_mesh``).  A mesh step computes JAX's global-view step,
which is the one-process step on the whole batch:

- every scene and DDF loss is a plain mean, and the shards are equal, so
  the mean over ranks of each rank's loss is the global loss; the terms on
  inputs every rank holds whole (the DDF fit's vMF rays, drawn inside the
  step; the density grid; the sigmoid loss) are the same on every rank;
- so after the backward ``.grad`` is averaged over every rank of the mesh,
  with the losses, in one coalesced ``all_reduce`` a step
  (:func:`~neusky_torch.parallel.collectives.average_grads`); the
  visibility's gather sums its cotangent over the ``dirs`` group, which
  this average divides back;
- the draws are the global batch's, every rank drawing the same and
  keeping its rows (``NeuSkyModel.draw``), and the stochastic table
  gradients hash the global lanes.

The backend is the caller's: ``nccl`` with a card a rank, ``gloo`` on the
CPU or where ranks share a card (gloo runs ``all_reduce`` and
``broadcast`` on CUDA tensors, the only collectives used).

``graphed`` on the three step factories plays the part of JAX's jit with
donated buffers: True runs the step as one CUDA graph replay a call
(:class:`~neusky_torch.parallel.graphs.CapturedStep`: the draws made
eagerly by :func:`~neusky_torch.models.pipeline.draw_step` and copied in,
the params updated in place), False eagerly, op by op from Python, and
None (the default) captures on a CUDA device and runs eagerly elsewhere
(:func:`_graphed`).  A rank of a mesh over NCCL captures its step with
its collectives, as JAX compiles one program per device; over gloo the
mesh step runs eagerly (gloo's collectives run on the host and cannot be
captured).  ``graphed=True`` on the CPU or with a gloo mesh raises, and so
does a graphed step given other params or inputs of another structure
than its first call's.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from neusky_torch.engine.optimizers import GroupedAdam
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import (
    PipelineConfig,
    ddf_fit_loss_fn,
    draw_step,
    eval_latent_loss_fn,
    scene_loss_fn,
    train_loss_fn,
)
from neusky_torch.parallel.collectives import average_grads, mesh_axis
from neusky_torch.parallel.graphs import CapturedStep, use_graph
from neusky_torch.tree import tree_leaves
from neusky_torch.utils.profiling import span

BACKENDS = ("nccl", "gloo")
PG_TIMEOUT_S = 600.0  # a collective waits this long for a rank that failed


def check_backend(backend: str, world_size: int) -> None:
    """Raise unless ``backend`` can run ``world_size`` ranks on this host:
    NCCL needs a card a rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"nccl runs one rank a card: {world_size} ranks, {torch.cuda.device_count()} cards "
                         "(ranks that share a card take gloo)")


def make_mesh(
    world_size: int,
    dirs: int = 1,
    *,
    backend: str,
    rank: int,
    init_method: str,
    device=None,
) -> DeviceMesh:
    """Start this rank's process group (``backend``, ``init_method`` such as
    ``file:///tmp/x/store``, ``rank`` of ``world_size``) and return the mesh
    over all ranks: ``("data",)`` of size ``world_size``, or with ``dirs`` >
    1 ``("data", "dirs")`` of shape ``(world_size // dirs, dirs)``, rank =
    data · dirs + dirs coordinate.  With NCCL ``device`` (this rank's card)
    becomes the current device."""
    check_backend(backend, world_size)
    if world_size % dirs:
        raise ValueError(f"{world_size} ranks do not split into 'dirs' groups of {dirs}")
    if backend == "nccl":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    shape, names = ((world_size // dirs, dirs), ("data", "dirs")) if dirs > 1 else ((world_size,), ("data",))
    ranks = torch.arange(world_size).reshape(shape)
    return DeviceMesh("cuda" if backend == "nccl" else "cpu", ranks, mesh_dim_names=names)


def _map_tensors(fn: Callable, tree, key: str = ""):
    """``fn(key, tensor)`` over the tensors of a batch or params tree
    (dicts, dataclasses such as ``RayBundle``, lists); ``key`` is the
    top-level key above each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(key, tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v, key or k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v, key) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_tensors(fn, getattr(tree, f.name), key)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def replicate(tree, mesh: Optional[DeviceMesh]):
    """Every tensor of ``tree`` broadcast from rank 0 (in place where the
    tensor is contiguous, so the parameters an optimizer holds are
    replicated as they stand) → the tree."""
    if mesh is None:
        return tree

    def bcast(_, t):
        t = t if t.is_contiguous() else t.contiguous()
        with torch.no_grad():
            dist.broadcast(t, src=0)
        return t

    return _map_tensors(bcast, tree)


def shard_batch(batch, mesh: Optional[DeviceMesh]):
    """This rank's rows of ``batch`` by JAX's ``_batch_spec`` rule: a
    tensor whose leading axis is divisible by the ``data`` size is cut into
    that many equal shards and this rank keeps shard ``data coordinate``;
    ``image_indices``, ``cameras`` and scalars stay whole.  Raises unless
    the ``data`` size divides the scene rays (``ray_bundle`` or
    ``pixel_coords``): the model takes a rank's rays as an equal shard of
    the global batch, for its draws and hash lanes."""
    axis = mesh_axis(mesh, "data")
    if axis is None or axis[1] == 1:
        return batch
    coord, size = axis
    rays = batch["ray_bundle"].origins if "ray_bundle" in batch else batch.get("pixel_coords")
    if rays is not None and rays.shape[0] % size:
        raise ValueError(f"the 'data' size {size} does not divide the batch's {rays.shape[0]} scene rays")

    def shard(key, t):
        if key in ("image_indices", "cameras") or t.dim() == 0 or t.shape[0] % size or t.shape[0] < size:
            return t
        n = t.shape[0] // size
        return t[coord * n:(coord + 1) * n]

    return _map_tensors(shard, batch)


def _trainable(params):
    return [t for t in tree_leaves(params) if t.requires_grad]


def _finish(params, mesh, total, loss_dict):
    """Average ``.grad`` (and the losses) over ``mesh``'s ranks → (total,
    loss dict), detached."""
    scalars = {"total_loss": total, **{k: v for k, v in loss_dict.items()}}
    if mesh is not None:
        scalars = average_grads(_trainable(params), scalars)
    scalars = {k: v.detach() for k, v in scalars.items()}
    return scalars.pop("total_loss"), scalars


def _backend(model: NeuSkyModel, mesh) -> Optional[str]:
    """The backend of the process group a step's collectives run on (on
    the factory's mesh, else the model's: :func:`make_mesh` spans the
    default group), or None without a mesh."""
    return None if mesh is None and model.mesh is None else dist.get_backend()


def _graphed(graphed: Optional[bool], device: torch.device, backend: Optional[str]) -> bool:
    """Whether a step factory given ``graphed`` captures its step on
    ``device`` as a rank of a mesh over ``backend`` (None: no mesh): None
    captures on a CUDA device alone or over NCCL, False never, True
    always, and raises on the CPU or over another backend than NCCL."""
    eager = None if backend in (None, "nccl") else (
        f"with a {backend} mesh: {backend}'s collectives run on the host and cannot be captured in a CUDA graph, "
        "so its mesh step runs eagerly")
    return use_graph(graphed, device, eager)


def _graph_train_step(step_fn, model, pipeline_config, optimizer, split: bool, collectives: bool) -> Callable:
    """``step_fn`` captured: each call makes the step's draws eagerly
    (:func:`draw_step`: on a ``data`` axis the global draws, cut to this
    rank's rows), then replays; ``.captured`` is the :class:`CapturedStep`."""
    captured = CapturedStep(lambda params, step, batch, draws: step_fn(params, batch, step, draws), optimizer,
                            collectives=collectives)

    def graphed_step(params, batch, step, draws: Optional[dict] = None, generator: Optional[torch.Generator] = None):
        with span("engine.draws"):
            draws = draw_step(model, pipeline_config, batch, generator, split, draws)
        return captured(params, step, batch, draws)

    graphed_step.captured = captured
    return graphed_step


def make_train_step(model: NeuSkyModel, pipeline_config: PipelineConfig, optimizer: GroupedAdam,
                    mesh: Optional[DeviceMesh] = None, graphed: Optional[bool] = None) -> Callable:
    """``step_fn(params, batch, step, draws=None, generator=None) → aux``;
    parameters are updated in place; ``step`` is a float or a 0-d tensor.
    With ``mesh`` (the model's, see ``NeuSkyModel.set_mesh``) ``batch`` is
    this rank's shard (:func:`shard_batch`), ``draws`` and ``generator``
    the global step's, and the aux losses and metrics are the global
    batch's.  ``graphed``: None captures the step as a CUDA graph on the
    card, alone or as a rank of an NCCL mesh, True asks for that (and
    raises on the CPU or with a gloo mesh), False runs it eagerly
    (:func:`_graphed`)."""

    def step_fn(params, batch, step, draws: Optional[dict] = None, generator: Optional[torch.Generator] = None):
        with span("step", model.device):
            optimizer.zero_grad()
            total, aux = train_loss_fn(model, pipeline_config, params, batch, step, draws, generator)
            with span("backward"):
                total.backward()
            total, loss_dict = _finish(params, mesh, total, aux["loss_dict"])
            with span("adam"):
                optimizer.step()
            return {**aux, "loss_dict": loss_dict, "total_loss": total}

    backend = _backend(model, mesh)
    if _graphed(graphed, model.device, backend):
        return _graph_train_step(step_fn, model, pipeline_config, optimizer, False, backend is not None)
    return step_fn


def make_train_step_split(model: NeuSkyModel, pipeline_config: PipelineConfig, optimizer: GroupedAdam,
                          mesh: Optional[DeviceMesh] = None, graphed: Optional[bool] = None) -> Callable:
    """The step in two gradient passes, as JAX's split step: the scene
    loss's backward first (its graph is freed), then the DDF fit's, which
    renders its own ground truth (never the fused pass); the two gradients
    sum in ``.grad`` before one optimizer update (with ``mesh``, one
    average over the ranks before it).  It draws as the fused step does
    (the scene's draws, then ``draws["ddf"]``), so both compute the same
    step; the split lowers the peak memory.  Same signature and
    ``graphed`` as :func:`make_train_step`."""
    fit_ddf = model.config.fit_visibility_field and model.ddf is not None

    def step_fn(params, batch, step, draws: Optional[dict] = None, generator: Optional[torch.Generator] = None):
        with span("step", model.device):
            optimizer.zero_grad()
            draws = dict(draws or {})
            ddf_draws = draws.pop("ddf", None)
            total, aux = scene_loss_fn(model, params, batch, step, draws, generator)
            with span("backward"):
                total.backward()
            total = total.detach()
            loss_dict = {k: v.detach() for k, v in aux["loss_dict"].items()}
            metrics = dict(aux["metrics"])
            if fit_ddf:
                ddf_total, ddf_aux = ddf_fit_loss_fn(model, pipeline_config, params, batch, ddf_draws, generator)
                with span("backward"):
                    ddf_total.backward()
                total = total + ddf_total.detach()
                loss_dict.update((k, v.detach()) for k, v in ddf_aux["loss_dict"].items())
                metrics.update(ddf_aux["metrics"])
            total, loss_dict = _finish(params, mesh, total, loss_dict)
            with span("adam"):
                optimizer.step()
            return {"loss_dict": loss_dict, "metrics": metrics, "total_loss": total}

    backend = _backend(model, mesh)
    if _graphed(graphed, model.device, backend):
        return _graph_train_step(step_fn, model, pipeline_config, optimizer, True, backend is not None)
    return step_fn


def make_eval_latent_step(model: NeuSkyModel, optimizer: GroupedAdam, mesh: Optional[DeviceMesh] = None,
                          graphed: Optional[bool] = None) -> Callable:
    """One step of test-time latent fitting: ``step_fn(params, batch, step,
    rotation=None) → total loss`` (detached), the eval group updated in
    place by ``optimizer`` (:func:`build_eval_latent_optimizer`).  With
    ``mesh`` every rank takes the whole batch (JAX replicates it) and the
    gradient is averaged over the ranks, so the eval latents stay equal on
    every rank.  ``graphed`` as :func:`make_train_step`'s (the eval step
    draws nothing)."""

    def step_fn(params, batch, step, rotation: Optional[torch.Tensor] = None):
        optimizer.zero_grad()
        total = eval_latent_loss_fn(model, params, batch, step, rotation)
        total.backward()
        total, _ = _finish(params, mesh, total, {})
        optimizer.step()
        return total

    backend = _backend(model, mesh)
    if not _graphed(graphed, model.device, backend):
        return step_fn
    captured = CapturedStep(lambda params, step, batch, rotation: step_fn(params, batch, step, rotation), optimizer,
                            collectives=backend is not None)

    def graphed_step(params, batch, step, rotation: Optional[torch.Tensor] = None):
        return captured(params, step, batch, rotation)

    graphed_step.captured = captured
    return graphed_step
