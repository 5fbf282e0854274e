"""Single-device train step (mirror of
``neusky_tpu/parallel/mesh.py::make_train_step`` without a mesh): value
and grad of ``train_loss_fn``, then the optimizer update."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from neusky_torch.engine.optimizers import GroupedAdam
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import PipelineConfig, train_loss_fn


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
