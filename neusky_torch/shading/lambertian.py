"""Lambertian compositing with per-direction visibility (mirror of
``neusky_tpu/shading/lambertian.py::lambertian_composite``), keeping the
reference's count-normalisation quirk: the n·l sum is divided by the
number of lit directions, not by a solid-angle weight."""

from __future__ import annotations

from typing import Optional

import torch

from neusky_torch.core.colour import linear_to_sRGB


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
    if clip_output:
        comp_rgb = torch.clamp(comp_rgb, 0.0, 1.0)
    return comp_rgb
