"""Ray containers and volume-rendering reductions (mirror of
``neusky_tpu/core/rays.py``).

N = number of rays, S = samples per ray.  RayBundle fields are ``[N, ...]``;
RaySamples fields are ``[N, S, ...]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RayBundle:
    origins: torch.Tensor  # [N, 3]
    directions: torch.Tensor  # [N, 3] unit norm
    pixel_area: torch.Tensor  # [N, 1]
    camera_indices: torch.Tensor  # [N, 1] int32
    nears: torch.Tensor  # [N, 1]
    fars: torch.Tensor  # [N, 1]
    directions_norm: torch.Tensor  # [N, 1]

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def replace(self, **kw) -> "RayBundle":
        return dataclasses.replace(self, **kw)

    @classmethod
    def create(
        cls,
        origins: torch.Tensor,
        directions: torch.Tensor,
        pixel_area: Optional[torch.Tensor] = None,
        camera_indices: Optional[torch.Tensor] = None,
        nears: Optional[torch.Tensor] = None,
        fars: Optional[torch.Tensor] = None,
        directions_norm: Optional[torch.Tensor] = None,
    ) -> "RayBundle":
        n = origins.shape[0]
        kw = dict(dtype=origins.dtype, device=origins.device)
        if pixel_area is None:
            pixel_area = torch.ones((n, 1), **kw)
        if camera_indices is None:
            camera_indices = torch.zeros((n, 1), dtype=torch.int32, device=origins.device)
        if nears is None:
            nears = torch.zeros((n, 1), **kw)
        if fars is None:
            fars = torch.full((n, 1), 1e4, **kw)
        if directions_norm is None:
            directions_norm = torch.ones((n, 1), **kw)
        return cls(
            origins=origins,
            directions=directions,
            pixel_area=pixel_area,
            camera_indices=camera_indices.to(torch.int32),
            nears=nears,
            fars=fars,
            directions_norm=directions_norm,
        )

    def slice(self, start: int, size: int) -> "RayBundle":
        """Rays ``start`` … ``start + size`` (fewer at the end)."""
        return RayBundle(**{f.name: getattr(self, f.name)[start:start + size] for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class RaySamples:
    origins: torch.Tensor  # [N, S, 3]
    directions: torch.Tensor  # [N, S, 3]
    starts: torch.Tensor  # [N, S, 1] euclidean distance along the ray
    ends: torch.Tensor  # [N, S, 1]
    pixel_area: torch.Tensor  # [N, S, 1]
    camera_indices: torch.Tensor  # [N, S, 1] int32
    deltas: torch.Tensor  # [N, S, 1]
    spacing_starts: torch.Tensor  # [N, S, 1] s-domain
    spacing_ends: torch.Tensor  # [N, S, 1]

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    @property
    def num_samples(self) -> int:
        return self.origins.shape[1]

    def start_positions(self) -> torch.Tensor:
        """Positions at frustum starts — the field-evaluation points."""
        return self.origins + self.directions * self.starts


def weights_and_transmittance_from_alphas(alphas: torch.Tensor):
    """NeuS compositing: ``alphas`` [N, S, 1] → (weights [N, S, 1],
    transmittance [N, S+1, 1]) with ``T_i = Π_{j<i}(1 − a_j + 1e-7)``."""
    t = torch.cumprod(
        torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-7], dim=-2),
        dim=-2,
    )
    weights = alphas * t[:, :-1]
    return weights, t


def weights_from_densities(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """NeRF compositing weights from densities (proposal fields)."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    acc = torch.cumsum(delta_density[:, :-1], dim=-2)
    acc = torch.cat([torch.zeros_like(acc[:, :1]), acc], dim=-2)
    transmittance = torch.exp(-acc)
    weights = alphas * transmittance
    return torch.nan_to_num(weights)


def render_weighted_sum(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return torch.sum(weights * values, dim=-2)


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    return torch.sum(weights, dim=-2)


def render_depth(weights: torch.Tensor, ray_samples: RaySamples) -> torch.Tensor:
    """Expected point-to-point depth, clipped to the sample range."""
    steps = (ray_samples.starts + ray_samples.ends) / 2.0
    eps = 1e-10
    depth = torch.sum(weights * steps, dim=-2) / (torch.sum(weights, dim=-2) + eps)
    return torch.clamp(depth, steps.amin(dim=-2), steps.amax(dim=-2))


def render_normal(weights: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Plain weighted sum of normals, no normalisation."""
    return torch.sum(weights * normals, dim=-2)


def render_rgb_with_background(
    weights: torch.Tensor, rgb: torch.Tensor, background_color: torch.Tensor
) -> torch.Tensor:
    comp = torch.sum(weights * rgb, dim=-2)
    acc = torch.sum(weights, dim=-2)
    return comp + background_color * (1.0 - acc)
