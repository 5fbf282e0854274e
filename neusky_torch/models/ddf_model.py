"""DDF model and its losses (mirror of ``neusky_tpu/models/ddf_model.py``).

Directions are rotated into a local frame at each sphere point, so the
field sees them independently of the position.  The SDF coupling (the SDF
at the predicted termination point) is passed in as a function.  Besides
the depth and level-set terms, two auxiliary query sets: the multi-view
loss (from a random second sphere point, the predicted distance toward a
known surface point may not exceed the true one) and the sky-ray loss
(rays known to hit the sky give exact distances back to the camera).
``ddf_predicted_normals`` reads surface normals off the field's gradient
(no training path calls it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from neusky_torch.core.rays import RayBundle
from neusky_torch.core.spherical import draw_sphere_uniforms, random_points_on_unit_sphere, ray_sphere_intersection
from neusky_torch.device import device_constant
from neusky_torch.fields.ddf import DDFFieldConfig, DirectionalDistanceField
from neusky_torch.models import losses as L
from neusky_torch.ops import ddf_film_cuda


@dataclasses.dataclass(frozen=True)
class DDFLossConfig:
    depth_l1: bool = True
    depth_l2: bool = False
    sdf_l1: bool = False
    sdf_l2: bool = True
    prob_hit: bool = False
    normal: bool = False
    multi_view: bool = True
    sky_ray: bool = True


@dataclasses.dataclass(frozen=True)
class DDFModelConfig:
    field: DDFFieldConfig = DDFFieldConfig()
    losses: DDFLossConfig = DDFLossConfig()
    loss_coefficients: tuple = (
        ("depth_l1_loss", 1.0),
        ("depth_l2_loss", 0.0),
        ("sdf_l1_loss", 1.0),
        ("sdf_l2_loss", 0.01),
        ("prob_hit_loss", 0.01),
        ("normal_loss", 1.0),
        ("multi_view_loss", 0.01),
        ("sky_ray_loss", 1.0),
    )
    include_depth_loss_scene_center_weight: bool = True
    scene_center_weight_exp: float = 3.0
    scene_center_weight_include_z: bool = False
    mask_to_circumference: bool = False
    inverse_depth_weight: bool = False
    log_depth: bool = False
    compute_normals: bool = False


def get_localised_transforms(positions: torch.Tensor) -> torch.Tensor:
    """Local frame at each sphere point with [0, 1, 0] facing the origin:
    positions [M, 3] → [M, 3, 3] whose columns are (x, y, z) local.  At the
    poles, where up × inward vanishes, x falls back to the world x axis."""
    p = -positions
    up = device_constant((0.0, 0.0, 1.0), p.dtype, p.device)
    x_local = torch.cross(up.expand_as(p), p, dim=-1)
    x_norm = torch.linalg.norm(x_local, dim=-1, keepdim=True)
    x_axis = device_constant((1.0, 0.0, 0.0), p.dtype, p.device)
    x_local = torch.where(x_norm > 1e-6, x_local / torch.clamp(x_norm, min=1e-12), x_axis)
    z_local = torch.cross(p, x_local, dim=-1)
    z_local = z_local / torch.clamp(torch.linalg.norm(z_local, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([x_local, p, z_local], dim=-1)


def localise_directions(positions: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """World directions in the local frame of each position."""
    return torch.einsum("mjl,mj->ml", get_localised_transforms(positions), directions)


class DDFModel:
    """``apply(params, origins, world directions)`` localises the
    directions and queries the field.  Parameters: ``{"params": {"field":
    ...}}`` (the flax tree of the JAX ``DDFModel``)."""

    def __init__(self, config: DDFModelConfig, ddf_radius: float = 1.0):
        self.config = config
        self.ddf_radius = ddf_radius
        self.field = DirectionalDistanceField(config.field, ddf_radius)

    def init(self, generator, device):
        return {"params": {"field": self.field.init(generator, device)}}

    def local_directions(self, origins: torch.Tensor, directions_world: torch.Tensor) -> torch.Tensor:
        """The field's direction input: world directions in the local frame
        of each origin on the DDF sphere."""
        return localise_directions(origins / self.ddf_radius, directions_world)

    def apply(self, params, origins: torch.Tensor, directions_world: torch.Tensor) -> dict:
        return self.field(params["params"]["field"], origins, self.local_directions(origins, directions_world))

    def fused_query(self, params) -> Callable:
        """``(origins, world directions) → expected_termination_dist`` [M]
        by the fused forward kernel (``ops/ddf_film_cuda.py``), with no
        autograd.  The weights are packed once, here.  Only for a field the
        kernel computes: the caller decides where it engages
        (``models/neusky.py::NeuSkyModel._fuses_ddf``)."""
        packed = ddf_film_cuda.pack(params["params"]["field"]["net"])

        def query(origins: torch.Tensor, directions_world: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                local = self.local_directions(origins, directions_world)
                return ddf_film_cuda.film_forward(packed, origins.contiguous(), local.contiguous(),
                                                  self.field.distance_scale)

        return query


def scene_center_distance_weight(config: DDFModelConfig, origins: torch.Tensor, ddf_radius: float) -> torch.Tensor:
    """Depth-loss weight 1 − (d / r)^exp: rays from near the scene's axis
    (or centre, with ``scene_center_weight_include_z``) count more."""
    xyz = origins if config.scene_center_weight_include_z else origins[..., :2]
    d = torch.linalg.norm(xyz, dim=-1) / ddf_radius
    return 1.0 - d**config.scene_center_weight_exp


def ddf_predicted_normals(model: DDFModel, params, origins: torch.Tensor, directions_world: torch.Tensor) -> torch.Tensor:
    """Surface normals from ∂(Σ termination distance)/∂origins through the
    localised query: the gradient normalised (``+1e-12`` under the root)
    and oriented against the ray.  ``[M, 3]``; no graph is kept."""
    with torch.enable_grad():
        o = origins.detach().requires_grad_(True)
        dist = model.apply(params, o, directions_world)["expected_termination_dist"].sum()
        (grads,) = torch.autograd.grad(dist, o)
    n_hat = grads / torch.sqrt(torch.sum(grads**2, dim=-1, keepdim=True) + 1e-12)
    return torch.sign(-torch.sum(n_hat * directions_world, dim=-1, keepdim=True)) * n_hat


def ddf_train_outputs(
    model: DDFModel,
    params,
    ray_bundle: RayBundle,
    batch: dict,
    sdf_at_pos_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    stop_sdf_gradients: bool = True,
    multi_view_u: Optional[tuple] = None,
) -> dict:
    """The DDF's training forward: the field on the batch's rays plus the
    multi-view and sky-ray query sets.  ``multi_view_u`` is the explicit
    draw of the multi-view loss's second sphere points (the two [M]
    uniforms of ``core.spherical.random_points_on_unit_sphere``); without
    it they are drawn from torch's default generator."""
    cfg = model.config
    origins = ray_bundle.origins
    dirs = ray_bundle.directions
    out = model.apply(params, origins, dirs)
    expected = out["expected_termination_dist"]
    outputs = {"expected_termination_dist": expected}
    if "probability_of_hit" in out:
        outputs["expected_probability_of_hit"] = out["probability_of_hit"]
    if cfg.include_depth_loss_scene_center_weight:
        outputs["distance_weight"] = scene_center_distance_weight(cfg, origins, model.ddf_radius)

    if (cfg.losses.sdf_l1 or cfg.losses.sdf_l2) and sdf_at_pos_fn is not None:
        term_points = origins + dirs * expected[..., None]
        if stop_sdf_gradients:
            with torch.no_grad():
                sdf_at_term = sdf_at_pos_fn(term_points.detach())
        else:
            sdf_at_term = sdf_at_pos_fn(term_points)
        outputs["sdf_at_termination"] = sdf_at_term.reshape(-1, 1)

    if cfg.losses.multi_view and "termination_dist" in batch:
        gt_points = origins + dirs * batch["termination_dist"].reshape(-1, 1)
        if multi_view_u is None:
            multi_view_u = draw_sphere_uniforms(gt_points.shape[0], None, gt_points.device)
        pts = random_points_on_unit_sphere(*multi_view_u)
        sphere_pts = torch.cat([pts[:, :2], torch.abs(pts[:, 2:])], dim=-1) * model.ddf_radius
        to_gt = gt_points - sphere_pts
        dist_to_gt = torch.linalg.norm(to_gt, dim=-1)
        dir_to_gt = to_gt / torch.clamp(dist_to_gt[..., None], min=1e-12)
        mv = model.apply(params, sphere_pts, dir_to_gt)
        outputs["multi_view_expected_termination_dist"] = mv["expected_termination_dist"]
        outputs["multi_view_termination_dist"] = dist_to_gt

    if cfg.losses.sky_ray and "sky_ray_bundle" in batch:
        srb: RayBundle = batch["sky_ray_bundle"]
        pts = ray_sphere_intersection(srb.origins, srb.directions, model.ddf_radius)
        sky = model.apply(params, pts, -srb.directions)
        outputs["sky_ray_expected_termination_dist"] = sky["expected_termination_dist"]
        outputs["sky_ray_termination_dist"] = torch.linalg.norm(srb.origins - pts, dim=-1)
    return outputs


def ddf_loss_dict(config: DDFModelConfig, outputs: dict, batch: dict, ddf_radius: float) -> dict:
    """The DDF loss terms, scaled by ``config.loss_coefficients``."""
    lc = config.losses
    ld = {}
    expected = outputs["expected_termination_dist"].reshape(-1, 1)
    mask = batch["mask"].reshape(-1, 1)
    gt = batch["termination_dist"].reshape(-1, 1)
    dw = outputs.get("distance_weight")
    if dw is not None and config.include_depth_loss_scene_center_weight:
        dw = dw.reshape(-1, 1)
    else:
        dw = None
    for name, use_l2, on in (("depth_l1_loss", False, lc.depth_l1), ("depth_l2_loss", True, lc.depth_l2)):
        if on:
            ld[name] = L.ddf_depth_loss(
                expected, gt, mask, ddf_radius, mask_to_circumference=config.mask_to_circumference,
                distance_weight=dw, inverse_depth_weight=config.inverse_depth_weight, use_l2=use_l2,
            )
    if "sdf_at_termination" in outputs:
        if lc.sdf_l1:
            ld["sdf_l1_loss"] = L.ddf_sdf_level_loss(outputs["sdf_at_termination"], mask, use_l2=False)
        if lc.sdf_l2:
            ld["sdf_l2_loss"] = L.ddf_sdf_level_loss(outputs["sdf_at_termination"], mask, use_l2=True)
    if lc.prob_hit and "expected_probability_of_hit" in outputs:
        ld["prob_hit_loss"] = L.ddf_prob_hit_loss(outputs["expected_probability_of_hit"].reshape(-1, 1), mask)
    if lc.multi_view and "multi_view_expected_termination_dist" in outputs:
        ld["multi_view_loss"] = L.ddf_multi_view_loss(
            outputs["multi_view_expected_termination_dist"], outputs["multi_view_termination_dist"]
        )
    if lc.sky_ray and "sky_ray_expected_termination_dist" in outputs:
        ld["sky_ray_loss"] = L.ddf_sky_ray_loss(
            outputs["sky_ray_expected_termination_dist"], outputs["sky_ray_termination_dist"]
        )
    return L.scale_loss_dict(ld, dict(config.loss_coefficients))
