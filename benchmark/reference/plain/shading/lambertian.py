"""Lambertian and Blinn-Phong compositing with per-direction visibility
(mirror of ``neusky_tpu/shading/lambertian.py``).  The Lambertian keeps the
reference's count-normalisation quirk: the n·l sum is divided by the
number of lit directions, not by a solid-angle weight; Blinn-Phong sums raw
contributions, as the reference does."""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.plain.core.colour import linear_to_sRGB


def lambertian_composite(
    albedos: torch.Tensor,  # [N, S, 3]
    normals: torch.Tensor,  # [N, S, 3]
    light_directions: torch.Tensor,  # [D, 3]
    light_colours: torch.Tensor,  # [N, D, 3]
    visibility: Optional[torch.Tensor],  # [N, S, D] or [N, 1, D] or None
    background_illumination: torch.Tensor,  # [N, 3]
    weights: torch.Tensor,  # [N, S, 1]
    clip_output: bool = False,
) -> torch.Tensor:
    """sRGB pixel colour: per sample Σ_d albedo · clamp(n·l_d)/count_lit ·
    vis_d · L_d, volume-composited over the sky background."""
    dot = torch.clamp(torch.einsum("nsi,di->nsd", normals, light_directions), 0.0, 1.0)
    count = torch.sum((dot > 0).to(dot.dtype), dim=-1, keepdim=True)
    count = torch.where(count > 0, count, torch.ones_like(count))
    dot = dot / count
    if visibility is not None:
        dot = dot * visibility
    radiance = albedos * torch.einsum("nsd,ndc->nsc", dot, light_colours)
    comp_rgb = torch.sum(weights * radiance, dim=-2)
    acc = torch.sum(weights, dim=-2)
    comp_rgb = linear_to_sRGB(comp_rgb + background_illumination * (1.0 - acc))
    return _eval_clip(comp_rgb) if clip_output else comp_rgb


def _eval_clip(comp_rgb: torch.Tensor) -> torch.Tensor:
    # JAX's clip, derivative included: half the gradient at a bound,
    # where the straight-through sRGB clamp puts saturated pixels (min
    # and max split ties; torch.clamp passes all of it).  The eval
    # latent fit differentiates through here.
    return torch.minimum(torch.maximum(comp_rgb, torch.zeros_like(comp_rgb)), torch.ones_like(comp_rgb))


def blinn_phong_composite(
    albedos: torch.Tensor,  # [N, S, 3]
    normals: torch.Tensor,  # [N, S, 3]
    light_directions: torch.Tensor,  # [D, 3]
    light_colours: torch.Tensor,  # [N, D, 3]
    visibility: Optional[torch.Tensor],  # [N, S, D] or [N, 1, D] or None
    background_illumination: torch.Tensor,  # [N, 3]
    weights: torch.Tensor,  # [N, S, 1]
    shininess: torch.Tensor,  # [N, S, 1]
    view_dirs_world: torch.Tensor,  # [N, 3]
    clip_output: bool = False,
) -> torch.Tensor:
    """sRGB pixel colour: per sample Σ_d vis_d · L_d · (albedo · clamp(n·l_d)
    + max(clamp(n·h_d), 1e-6)^shininess) with h_d the half vector of l_d
    and the view direction, no count normalisation; volume-composited over
    the sky background."""
    h = light_directions[None, :, :] + view_dirs_world[:, None, :]  # [N, D, 3]
    h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True), min=1e-12)
    dot_nl = torch.clamp(torch.einsum("nsi,di->nsd", normals, light_directions), 0.0, 1.0)
    dot_nh = torch.clamp(torch.einsum("nsi,ndi->nsd", normals, h), 0.0, 1.0)
    lit = light_colours[:, None, :, :]  # [N, 1, D, 3]
    if visibility is not None:
        lit = lit * visibility[..., None]
    diffuse = albedos[:, :, None, :] * dot_nl[..., None]  # [N, S, D, 3]
    specular = torch.pow(torch.clamp(dot_nh, min=1e-6), shininess)[..., None]  # [N, S, D, 1]
    radiance = torch.sum(lit * (diffuse + specular), dim=2)  # [N, S, 3]
    comp_rgb = torch.sum(weights * radiance, dim=-2)
    acc = torch.sum(weights, dim=-2)
    comp_rgb = linear_to_sRGB(comp_rgb + background_illumination * (1.0 - acc))
    return _eval_clip(comp_rgb) if clip_output else comp_rgb
