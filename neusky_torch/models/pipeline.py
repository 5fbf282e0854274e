"""Training loss of one step (mirror of ``neusky_tpu/models/pipeline.py``):
the scene half (NeuSky forward and scene losses) plus, when the visibility
field is fitted, the DDF-fit half: a fresh batch of vMF rays from the
bounding sphere is rendered against the SDF as ground truth, and the DDF is
fit to it (depth, SDF level set, multi-view and sky-ray losses).  The two
sum into one scalar, so one backward pass covers the SDF↔DDF coupling.
The device is the model's (``NeuSkyModel(config, device="cuda")``).

Randomness: ``draws`` holds the scene forward's draws
(:meth:`NeuSkyModel.draw`) and, under ``"ddf"``, the DDF half's
(:func:`draw_ddf_fit`); whatever is missing comes from ``generator``.

With ``fused_ddf_gt_pass`` (and the SDF gradients not stopped) the scene
forward and the ground-truth render are one proposal and field pass over
the scene and vMF rays (:meth:`NeuSkyModel.forward_with_ddf_gt`); its
draws are then those of one ``forward`` over both, and the DDF half draws
only the vMF rays and the multi-view points.

:func:`draw_step` makes every draw of one step ahead of it, in the step's
own order, so a step given them draws nothing (the captured step draws
eagerly and copies them in).  ``step`` is a float or a 0-d tensor (a
captured step's device input).

``eval_latent_loss_fn`` is the loss of the test-time eval-latent fit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from neusky_torch.core.rays import RayBundle
from neusky_torch.core.spherical import draw_sphere_uniforms
from neusky_torch.models.ddf_model import ddf_loss_dict, ddf_train_outputs
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig, draw_vmf, vmf_ddf_samples
from neusky_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    stop_sdf_gradients: bool = False
    least_squares_global_scale: bool = False
    visibility_accumulation_mask_threshold: float = 0.0
    visibility_train_sampler: DDFSamplerConfig = DDFSamplerConfig(
        num_samples_on_sphere=8, num_rays_per_sample=128,
        only_sample_upper_hemisphere=True, concentration=20.0,
    )
    num_sky_rays: int = 256


def batch_ray_bundle(batch: Dict[str, Any]) -> RayBundle:
    """The batch's scene rays — materialised, or generated from
    (cam_idx, pixel_coords) and the batch's cameras."""
    if "ray_bundle" in batch:
        return batch["ray_bundle"]
    return batch["cameras"].generate_rays_at(batch["cam_idx"], batch["pixel_coords"])


def batch_sky_bundle(batch: Dict[str, Any]) -> Optional[RayBundle]:
    """The batch's sky rays (for the DDF's sky-ray loss), or None."""
    if "sky_ray_bundle" in batch:
        return batch["sky_ray_bundle"]
    if "sky_cam_idx" in batch:
        return batch["cameras"].generate_rays_at(batch["sky_cam_idx"], batch["sky_pixel_coords"])
    return None


def _sum(loss_dict, device) -> torch.Tensor:
    total = torch.zeros((), device=device)
    for v in loss_dict.values():
        total = total + v
    return total


def _scene_losses(model: NeuSkyModel, params, outputs, batch):
    with span("losses"):
        loss_dict = model.loss_dict(params, outputs, batch, train=True)
        metrics = model.metrics_dict(params, outputs, batch)
        return _sum(loss_dict, model.device), {"loss_dict": loss_dict, "metrics": metrics}


def scene_loss_fn(
    model: NeuSkyModel,
    params,
    batch: Dict[str, Any],
    step,
    draws: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Scene half of the joint step: NeuSky forward + scene losses."""
    with span("scene"):
        outputs = model.forward(
            params, batch_ray_bundle(batch), batch["image_indices"], batch["ray_image_idx"],
            step=step, train=True, draws=draws, generator=generator,
        )
        return _scene_losses(model, params, outputs, batch)


def draw_ddf_fit(
    model: NeuSkyModel, pipeline_config: PipelineConfig, draws: Optional[dict],
    generator: Optional[torch.Generator], with_gt: bool = True,
) -> dict:
    """Complete the DDF half's draws (the JAX key tree ``split(k_ddf, 3)``
    = (k_vis_sample, k_vis_gt, k_ddf)): ``vmf`` (the vMF rays,
    :func:`draw_vmf`), ``gt`` (the ground-truth pass's stochastic table
    gradients, :meth:`NeuSkyModel.draw_ddf_gt`; not with ``with_gt=False``,
    the fused pass) and ``multi_view_u`` (the multi-view loss's sphere
    points)."""
    s = pipeline_config.visibility_train_sampler
    n = s.num_samples_on_sphere * s.num_rays_per_sample
    d = dict(draws or {})
    if "vmf" not in d:
        d["vmf"] = draw_vmf(s, generator, model.device)
    if with_gt:
        d["gt"] = model.draw_ddf_gt(d.get("gt"), generator, n)
    if "multi_view_u" not in d:
        d["multi_view_u"] = draw_sphere_uniforms(n, generator, model.device)
    return d


def ddf_fit_loss_fn(
    model: NeuSkyModel,
    pipeline_config: PipelineConfig,
    params,
    batch: Dict[str, Any],
    draws: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
    vis_bundle: Optional[RayBundle] = None,
    gt: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """DDF-fit half: vMF sphere rays rendered against the SDF as ground
    truth (un-annealed, no jitter), then the DDF losses and the DDF depth
    PSNR.  ``vis_bundle`` and ``gt`` from the fused pass skip the draw of
    the rays and the separate render."""
    with span("ddf_fit"):
        d = draw_ddf_fit(model, pipeline_config, draws, generator, with_gt=gt is None)
        r = model.config.ddf_radius
        if vis_bundle is None:
            vis_bundle = vmf_ddf_samples(pipeline_config.visibility_train_sampler, d["vmf"], ddf_sphere_radius=r)
        if gt is None:
            gt = model.generate_ddf_ground_truth(
                params, vis_bundle, mask_threshold=pipeline_config.visibility_accumulation_mask_threshold,
                stop_gradients=pipeline_config.stop_sdf_gradients, draws=d["gt"],
            )
        ddf_batch = dict(gt)
        sky_bundle = batch_sky_bundle(batch)
        if sky_bundle is not None:
            ddf_batch["sky_ray_bundle"] = sky_bundle
        field_params = params["fields"]
        ddf_outputs = ddf_train_outputs(
            model.ddf, params["ddf_field"], vis_bundle, ddf_batch,
            sdf_at_pos_fn=lambda p: model.field.sdf_only(field_params, p),
            stop_sdf_gradients=pipeline_config.stop_sdf_gradients,
            multi_view_u=d["multi_view_u"],
        )
        vis_losses = ddf_loss_dict(model.config.ddf, ddf_outputs, ddf_batch, r)
        m = ddf_batch["mask"].reshape(-1, 1)
        pred_d = ddf_outputs["expected_termination_dist"].reshape(-1, 1) * m
        gt_d = ddf_batch["termination_dist"].reshape(-1, 1) * m
        mse = torch.mean((pred_d - gt_d) ** 2)
        metrics = {"ddf_depth_psnr": (-10.0 * torch.log10(torch.clamp(mse / r**2, min=1e-10))).detach()}
        return _sum(vis_losses, model.device), {"loss_dict": vis_losses, "metrics": metrics}


def _fused_gt_pass(model: NeuSkyModel, pipeline_config: PipelineConfig) -> bool:
    """Whether the joint step runs the fused ground-truth pass."""
    fit_ddf = model.config.fit_visibility_field and model.ddf is not None
    return fit_ddf and model.config.fused_ddf_gt_pass and not pipeline_config.stop_sdf_gradients


def draw_step(
    model: NeuSkyModel,
    pipeline_config: PipelineConfig,
    batch: Dict[str, Any],
    generator: Optional[torch.Generator],
    split: bool = False,
    draws: Optional[dict] = None,
) -> dict:
    """Every draw one training step makes (``draws`` completed), in the
    order the eager step makes them, so the step given the result draws
    nothing from ``generator`` and computes what it computes unhelped.
    The fused step (:func:`train_loss_fn`) with the fused ground-truth
    pass: the DDF half's vMF rays and multi-view points, then the draws of
    one ``forward`` over the scene and vMF rays; otherwise, and in the
    split step (``split``): the scene forward's draws, then ``"ddf"``
    (:func:`draw_ddf_fit`) when the visibility field is fitted.  The
    eval-latent step draws nothing."""
    d = dict(draws or {})
    ddf = d.pop("ddf", None)
    n = batch["ray_bundle"].num_rays if "ray_bundle" in batch else batch["pixel_coords"].shape[0]
    if _fused_gt_pass(model, pipeline_config) and not split:
        ddf = draw_ddf_fit(model, pipeline_config, ddf, generator, with_gt=False)
        s = pipeline_config.visibility_train_sampler
        d = model.draw(d, generator, n, s.num_samples_on_sphere * s.num_rays_per_sample)
    else:
        d = model.draw(d, generator, n)
        if model.config.fit_visibility_field and model.ddf is not None:
            ddf = draw_ddf_fit(model, pipeline_config, ddf, generator)
    return {**d, "ddf": ddf} if ddf is not None else d


def train_loss_fn(
    model: NeuSkyModel,
    pipeline_config: PipelineConfig,
    params,
    batch: Dict[str, Any],
    step,
    draws: Optional[dict] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One step's scalar loss + aux (loss dict, metrics): the scene half,
    plus the DDF-fit half when ``fit_visibility_field`` and the model has a
    DDF."""
    fit_ddf = model.config.fit_visibility_field and model.ddf is not None
    draws = dict(draws or {})
    ddf_draws = draws.pop("ddf", None)
    if _fused_gt_pass(model, pipeline_config):
        d = draw_ddf_fit(model, pipeline_config, ddf_draws, generator, with_gt=False)
        vis_bundle = vmf_ddf_samples(pipeline_config.visibility_train_sampler, d["vmf"],
                                     ddf_sphere_radius=model.config.ddf_radius)
        with span("scene"):
            outputs, gt = model.forward_with_ddf_gt(
                params, batch_ray_bundle(batch), batch["image_indices"], batch["ray_image_idx"], vis_bundle,
                step=step, train=True, draws=draws, generator=generator,
                gt_mask_threshold=pipeline_config.visibility_accumulation_mask_threshold,
            )
            total, aux = _scene_losses(model, params, outputs, batch)
        ddf_total, ddf_aux = ddf_fit_loss_fn(model, pipeline_config, params, batch, d, generator,
                                             vis_bundle=vis_bundle, gt=gt)
    else:
        total, aux = scene_loss_fn(model, params, batch, step, draws, generator)
        if fit_ddf:
            ddf_total, ddf_aux = ddf_fit_loss_fn(model, pipeline_config, params, batch, ddf_draws, generator)
    if fit_ddf:
        total = total + ddf_total
        aux = {
            "loss_dict": {**aux["loss_dict"], **ddf_aux["loss_dict"]},
            "metrics": {**aux["metrics"], **ddf_aux["metrics"]},
        }
    return total, aux


def eval_latent_loss_fn(
    model: NeuSkyModel,
    params,
    batch: Dict[str, Any],
    step,
    rotation: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Loss of test-time latent fitting: the eval-mode forward with the sky
    decoded from the eval latents, then the RGB and sky-pixel terms only.
    Only the leaves the caller lets require gradients receive them (the
    eval group, :func:`~neusky_torch.engine.eval_loop.fit_eval_latents`)."""
    outputs = model.forward(
        params, batch_ray_bundle(batch), batch["image_indices"], batch["ray_image_idx"],
        step=step, train=False, fitting_eval_latents=True, rotation=rotation,
    )
    return _sum(model.loss_dict(params, outputs, batch, train=False, fitting_eval_latents=True), model.device)
