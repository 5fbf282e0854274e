"""Colliders and scene contraction (mirror of ``neusky_tpu/core/scene.py``)."""

from __future__ import annotations

import torch

from benchmark.reference.plain.core.rays import RayBundle


def aabb_collider(ray_bundle: RayBundle, aabb: torch.Tensor, near_plane: float = 0.05) -> RayBundle:
    """nears/fars from the ray/AABB intersection."""
    o, d = ray_bundle.origins, ray_bundle.directions
    tiny = torch.where(d >= 0, torch.full_like(d, 1e-10), torch.full_like(d, -1e-10))
    inv_d = 1.0 / torch.where(d.abs() < 1e-10, tiny, d)
    t0 = (aabb[0] - o) * inv_d
    t1 = (aabb[1] - o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1, keepdim=True)
    t_far = torch.maximum(t0, t1).amin(dim=-1, keepdim=True)
    t_near = torch.clamp(t_near, min=near_plane)
    t_far = torch.maximum(t_far, t_near + 1e-6)
    return ray_bundle.replace(nears=t_near, fars=t_far)


def sphere_collider(
    ray_bundle: RayBundle,
    radius: float = 1.0,
    near_plane: float = 0.05,
) -> RayBundle:
    """nears/fars from the ray/sphere intersection; misses get a degenerate
    (near ≈ far) interval."""
    o, d = ray_bundle.origins, ray_bundle.directions
    b = 2.0 * torch.sum(o * d, dim=-1, keepdim=True)
    c = torch.sum(o * o, dim=-1, keepdim=True) - radius**2
    disc = b**2 - 4.0 * c
    hit = disc > 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    nears = (-b - sq) / 2.0
    fars = (-b + sq) / 2.0
    near_fill = torch.full_like(nears, near_plane)
    nears = torch.where(hit, torch.clamp(nears, min=near_plane), near_fill)
    fars = torch.where(hit, torch.maximum(fars, nears + 1e-6), near_fill + 1e-6)
    return ray_bundle.replace(nears=nears, fars=fars)


def contract_l2(positions: torch.Tensor) -> torch.Tensor:
    """mip-NeRF-360 scene contraction with the L2 norm."""
    mag = torch.linalg.norm(positions, dim=-1, keepdim=True)
    safe = torch.clamp(mag, min=1e-12)
    contracted = (2.0 - 1.0 / safe) * (positions / safe)
    return torch.where(mag <= 1.0, positions, contracted)


def contract_linf(positions: torch.Tensor) -> torch.Tensor:
    """Scene contraction with the L-infinity norm."""
    mag = positions.abs().amax(dim=-1, keepdim=True)
    safe = torch.clamp(mag, min=1e-12)
    contracted = (2.0 - 1.0 / safe) * (positions / safe)
    return torch.where(mag <= 1.0, positions, contracted)


def contraction_to_unit_cube(positions: torch.Tensor, order: str = "l2") -> torch.Tensor:
    """Contract (range [-2, 2]) then rescale to [0, 1]³ for grid encodings."""
    c = contract_l2(positions) if order == "l2" else contract_linf(positions)
    return (c + 2.0) / 4.0
