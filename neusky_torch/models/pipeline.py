"""Training loss of one step (mirror of ``neusky_tpu/models/pipeline.py``),
scene half: with ``ddf=None`` (the only setting ported so far)
``train_loss_fn`` is ``scene_loss_fn``.  The device is the model's
(``NeuSkyModel(config, device="cuda")``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from neusky_torch.core.rays import RayBundle
from neusky_torch.models.neusky import NeuSkyModel


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    stop_sdf_gradients: bool = False
    least_squares_global_scale: bool = False
    visibility_accumulation_mask_threshold: float = 0.0
    visibility_train_sampler: Optional[Any] = None
    """Placeholder until the DDF slice ports ``DDFSamplerConfig``."""
    num_sky_rays: int = 256


def batch_ray_bundle(batch: Dict[str, Any]) -> RayBundle:
    """The batch's scene rays — materialised, or generated from
    (cam_idx, pixel_coords) and the batch's cameras."""
    if "ray_bundle" in batch:
        return batch["ray_bundle"]
    return batch["cameras"].generate_rays_at(batch["cam_idx"], batch["pixel_coords"])


def _scene_losses(model: NeuSkyModel, params, outputs, batch):
    loss_dict = model.loss_dict(params, outputs, batch, train=True)
    metrics = model.metrics_dict(params, outputs, batch)
    total = torch.zeros((), device=model.device)
    for v in loss_dict.values():
        total = total + v
    return total, {"loss_dict": loss_dict, "metrics": metrics}


def scene_loss_fn(
    model: NeuSkyModel,
    params,
    batch: Dict[str, Any],
    step: float,
    draws: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Scene half of the joint step: NeuSky forward + scene losses."""
    outputs = model.forward(
        params, batch_ray_bundle(batch), batch["image_indices"], batch["ray_image_idx"],
        step=step, train=True, draws=draws, generator=generator,
    )
    return _scene_losses(model, params, outputs, batch)


def train_loss_fn(
    model: NeuSkyModel,
    pipeline_config: PipelineConfig,
    params,
    batch: Dict[str, Any],
    step: float,
    draws: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One step's scalar loss + aux (loss dict, metrics).  ``draws`` are
    the scene forward's explicit random draws (``NeuSkyModel.draw``)."""
    if model.config.fit_visibility_field:
        raise NotImplementedError("the DDF-fit half is not ported yet")
    return scene_loss_fn(model, params, batch, step, draws, generator)
