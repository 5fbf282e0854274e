"""DDF training rays on the bounding sphere (mirror of
``neusky_tpu/sampling/ddf_sampler.py``): positions uniform on the sphere
(the upper hemisphere by default), directions either uniform in the
inward hemisphere or von Mises-Fisher around the inward normal, drawn by
the exact 3D inverse CDF of the vMF cosine (no rejection loop).

Randomness is explicit (``draw_*`` build the draws from a generator):

- ``sphere_u``: the two [P] uniforms of the sphere positions;
- ``vmf_u``: [P, M] uniforms in [1e-7, 1) of the vMF cosine;
- ``vmf_z``: [P, M, 3] standard normals of the tangent directions;
- ``dir_u``: the two [P·M] uniforms of the uniform sampler's directions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from benchmark.reference.plain.core.rays import RayBundle
from benchmark.reference.plain.core.spherical import (
    draw_sphere_uniforms,
    random_inward_facing_directions,
    random_points_on_unit_sphere,
)


@dataclasses.dataclass(frozen=True)
class DDFSamplerConfig:
    num_samples_on_sphere: int = 8
    num_rays_per_sample: int = 128
    only_sample_upper_hemisphere: bool = True
    concentration: float = 20.0  # vMF kappa


def draw_vmf(config: DDFSamplerConfig, generator: Optional[torch.Generator], device) -> dict:
    """The draws one :func:`vmf_ddf_samples` call consumes."""
    p, m = config.num_samples_on_sphere, config.num_rays_per_sample
    return {
        "sphere_u": draw_sphere_uniforms(p, generator, device),
        "vmf_u": torch.rand((p, m), generator=generator, device=device) * (1.0 - 1e-7) + 1e-7,
        "vmf_z": torch.randn((p, m, 3), generator=generator, device=device),
    }


def draw_uniform(config: DDFSamplerConfig, generator: Optional[torch.Generator], device) -> dict:
    """The draws one :func:`uniform_ddf_samples` call consumes."""
    p, m = config.num_samples_on_sphere, config.num_rays_per_sample
    return {"sphere_u": draw_sphere_uniforms(p, generator, device),
            "dir_u": draw_sphere_uniforms(p * m, generator, device)}


def _positions_on_sphere(sphere_u, upper_only: bool) -> torch.Tensor:
    p = random_points_on_unit_sphere(*sphere_u)
    if upper_only:
        p = torch.cat([p[:, :2], torch.abs(p[:, 2:])], dim=-1)
    return p


def sample_vmf(mean_directions: torch.Tensor, kappa: float, u: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """vMF(μ, κ) samples on S² for each mean direction [P, 3], from the
    uniforms ``u`` [P, M] (the cosine W = 1 + log(u + (1 − u)·e^(−2κ))/κ)
    and the normals ``z`` [P, M, 3] (a uniform tangent direction).
    Returns [P, M, 3]."""
    mu = mean_directions / torch.linalg.norm(mean_directions, dim=-1, keepdim=True)
    w = 1.0 + torch.log(u + (1.0 - u) * math.exp(-2.0 * kappa)) / kappa
    w = torch.clamp(w, -1.0, 1.0)
    z = z - torch.sum(z * mu[:, None, :], dim=-1, keepdim=True) * mu[:, None, :]
    z = z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True), min=1e-12)
    sin_theta = torch.sqrt(torch.clamp(1.0 - w**2, min=0.0))
    x = z * sin_theta[..., None] + w[..., None] * mu[:, None, :]
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def _build_bundle(positions: torch.Tensor, directions: torch.Tensor, radius: float) -> RayBundle:
    """positions [P, 3] on the unit sphere, directions [P, M, 3] → a flat
    bundle of P·M rays with origins on the sphere of ``radius``."""
    m = directions.shape[1]
    return RayBundle.create(origins=torch.repeat_interleave(positions * radius, m, dim=0),
                            directions=directions.reshape(-1, 3))


def uniform_ddf_samples(config: DDFSamplerConfig, d: dict, ddf_sphere_radius: float = 1.0) -> RayBundle:
    """Directions uniform in the inward hemisphere of each sphere point;
    ``d`` from :func:`draw_uniform`."""
    positions = _positions_on_sphere(d["sphere_u"], config.only_sample_upper_hemisphere)
    dirs = random_inward_facing_directions(*d["dir_u"], config.num_rays_per_sample, normals=-positions)
    return _build_bundle(positions, dirs, ddf_sphere_radius)


def vmf_ddf_samples(config: DDFSamplerConfig, d: dict, ddf_sphere_radius: float = 1.0) -> RayBundle:
    """vMF directions around the inward normal of each sphere point; those
    outside the inward hemisphere are negated.  ``d`` from :func:`draw_vmf`."""
    positions = _positions_on_sphere(d["sphere_u"], config.only_sample_upper_hemisphere)
    dirs = sample_vmf(-positions, config.concentration, d["vmf_u"], d["vmf_z"])
    dots = torch.sum(dirs * (-positions)[:, None, :], dim=-1, keepdim=True)
    dirs = torch.where(dots < 0, -dirs, dirs)
    return _build_bundle(positions, dirs, ddf_sphere_radius)
