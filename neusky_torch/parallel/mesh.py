"""Single-device steps (mirror of ``neusky_tpu/parallel/mesh.py``
``make_train_step``, ``make_train_step_split`` and ``make_eval_latent_step``
without a mesh): value and grad of the loss, then the optimizer update."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from neusky_torch.engine.optimizers import GroupedAdam
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import (
    PipelineConfig,
    ddf_fit_loss_fn,
    eval_latent_loss_fn,
    scene_loss_fn,
    train_loss_fn,
)


def make_train_step(model: NeuSkyModel, pipeline_config: PipelineConfig, optimizer: GroupedAdam) -> Callable:
    """``step_fn(params, batch, step, draws=None, generator=None) → aux``;
    parameters are updated in place."""

    def step_fn(params, batch, step, draws: Optional[dict] = None, generator: Optional[torch.Generator] = None):
        optimizer.zero_grad()
        total, aux = train_loss_fn(model, pipeline_config, params, batch, step, draws, generator)
        total.backward()
        optimizer.step()
        aux = dict(aux)
        aux["loss_dict"] = {k: v.detach() for k, v in aux["loss_dict"].items()}
        aux["total_loss"] = total.detach()
        return aux

    return step_fn


def make_train_step_split(model: NeuSkyModel, pipeline_config: PipelineConfig, optimizer: GroupedAdam) -> Callable:
    """The step in two gradient passes, as JAX's split step: the scene
    loss's backward first (its graph is freed), then the DDF fit's, which
    renders its own ground truth (never the fused pass); the two gradients
    sum in ``.grad`` before one optimizer update.  It draws as the fused
    step does (the scene's draws, then ``draws["ddf"]``), so both compute
    the same step; the split lowers the peak memory.  Same signature as
    :func:`make_train_step`."""
    fit_ddf = model.config.fit_visibility_field and model.ddf is not None

    def step_fn(params, batch, step, draws: Optional[dict] = None, generator: Optional[torch.Generator] = None):
        optimizer.zero_grad()
        draws = dict(draws or {})
        ddf_draws = draws.pop("ddf", None)
        total, aux = scene_loss_fn(model, params, batch, step, draws, generator)
        total.backward()
        total = total.detach()
        loss_dict = {k: v.detach() for k, v in aux["loss_dict"].items()}
        metrics = dict(aux["metrics"])
        if fit_ddf:
            ddf_total, ddf_aux = ddf_fit_loss_fn(model, pipeline_config, params, batch, ddf_draws, generator)
            ddf_total.backward()
            total = total + ddf_total.detach()
            loss_dict.update((k, v.detach()) for k, v in ddf_aux["loss_dict"].items())
            metrics.update(ddf_aux["metrics"])
        optimizer.step()
        return {"loss_dict": loss_dict, "metrics": metrics, "total_loss": total}

    return step_fn


def make_eval_latent_step(model: NeuSkyModel, optimizer: GroupedAdam) -> Callable:
    """One step of test-time latent fitting: ``step_fn(params, batch, step,
    rotation=None) → total loss`` (detached), the eval group updated in
    place by ``optimizer`` (:func:`build_eval_latent_optimizer`)."""

    def step_fn(params, batch, step, rotation: Optional[torch.Tensor] = None):
        optimizer.zero_grad()
        total = eval_latent_loss_fn(model, params, batch, step, rotation)
        total.backward()
        optimizer.step()
        return total.detach()

    return step_fn
