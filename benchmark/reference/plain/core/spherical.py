"""Sphere math (mirror of ``neusky_tpu/core/spherical.py``): ray/sphere
intersection, look-at frames, rotations about z, random rotations, random points and
directions on the sphere, and the icosphere."""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


def sph2cart(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """(azimuth θ, polar angle φ from +z) → unit vectors [..., 3], z-up."""
    return torch.stack(
        [torch.sin(phi) * torch.cos(theta), torch.sin(phi) * torch.sin(theta), torch.cos(phi)], dim=-1
    )


def draw_sphere_uniforms(
    num_points: int, generator: Optional[torch.Generator], device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two [num_points] uniforms :func:`random_points_on_unit_sphere`
    consumes (the JAX ``uniform(k_t)`` and ``uniform(k_p)`` of
    ``split(rng)``)."""
    return (torch.rand((num_points,), generator=generator, device=device),
            torch.rand((num_points,), generator=generator, device=device))


def random_points_on_unit_sphere(u_theta: torch.Tensor, u_phi: torch.Tensor) -> torch.Tensor:
    """Uniform points on S² from explicit uniforms: θ = 2π·u_θ,
    cos φ = 2·u_φ − 1.  Returns [N, 3]."""
    theta = 2.0 * math.pi * u_theta
    phi = torch.arccos(2.0 * u_phi - 1.0)
    return sph2cart(theta, phi)


def random_inward_facing_directions(
    u_theta: torch.Tensor, u_phi: torch.Tensor, num_directions: int, normals: torch.Tensor
) -> torch.Tensor:
    """For each normal [P, 3], ``num_directions`` directions in its
    hemisphere: uniform points on the sphere (uniforms of length
    P·num_directions), negated where they face away.  Returns [P, D, 3]."""
    dirs = random_points_on_unit_sphere(u_theta, u_phi).reshape(normals.shape[0], num_directions, 3)
    dots = torch.sum(normals[:, None, :] * dirs, dim=-1, keepdim=True)
    return torch.where(dots < 0, -dirs, dirs)


def ray_sphere_intersection(positions: torch.Tensor, directions: torch.Tensor, radius) -> torch.Tensor:
    """Intersection of rays with an origin-centred sphere, positive root
    (rays assumed to start inside); the discriminant is clamped to ≥ 0."""
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    b = 2.0 * torch.sum(directions * positions, dim=-1)
    c = torch.sum(positions * positions, dim=-1) - radius**2
    disc = torch.clamp(b**2 - 4.0 * c, min=0.0)
    sq = torch.sqrt(disc)
    t = torch.maximum((-b - sq) / 2.0, (-b + sq) / 2.0)
    return positions + t[..., None] * directions


def _to_f32(x: np.ndarray) -> np.ndarray:
    """Round float64 values to float32 (and keep them as float64)."""
    return x.astype(np.float32).astype(np.float64)


def fused_dot3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 Σ_k a_k·b_k over a last axis of 3, in the order XLA's CPU
    backend computes it (products contracted into fused multiply-adds):
    fma(a₂, b₂, fma(a₁, b₁, a₀·b₀)).  Each fma is emulated in float64,
    where the product of two float32 values is exact."""
    a, b = np.asarray(a, np.float32).astype(np.float64), np.asarray(b, np.float32).astype(np.float64)
    acc = _to_f32(a[..., 0] * b[..., 0])
    acc = _to_f32(a[..., 1] * b[..., 1] + acc)
    return (a[..., 2] * b[..., 2] + acc).astype(np.float32)


def _fused_cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 a × b as XLA's CPU backend computes ``jnp.cross``:
    fma(a_i, b_j, −(a_j·b_i)) per component."""
    a, b = np.asarray(a, np.float32).astype(np.float64), np.asarray(b, np.float32).astype(np.float64)
    return np.stack([(a[..., i] * b[..., j] - _to_f32(a[..., j] * b[..., i])).astype(np.float32)
                     for i, j in ((1, 2), (2, 0), (0, 1))], axis=-1)


def fused_normalize(v: np.ndarray) -> np.ndarray:
    """float32 v / ‖v‖ with the norm as :func:`fused_dot3` computes it."""
    v = np.asarray(v, np.float32)
    return v / np.sqrt(fused_dot3(v, v))[..., None]


def look_at_target(
    camera_positions: np.ndarray, target_positions: np.ndarray, up_vector=(0.0, 0.0, 1.0)
) -> np.ndarray:
    """c2w matrices [..., 4, 4] looking from cameras at targets (OpenGL
    convention: forward = −view direction).  Host-side numpy in float32,
    in the JAX package's float32 order on the CPU (fused multiply-adds in
    the cross products and norms), so the two agree bit for bit."""
    cam = np.asarray(camera_positions, np.float32)
    tgt = np.asarray(target_positions, np.float32)
    up = np.broadcast_to(np.asarray(up_vector, np.float32), cam.shape)
    forward = -fused_normalize(tgt - cam)
    right = fused_normalize(_fused_cross(up, forward))
    actual_up = fused_normalize(_fused_cross(forward, right))
    c2w = np.zeros(cam.shape[:-1] + (4, 4), np.float32)
    c2w[..., :3, 0] = right
    c2w[..., :3, 1] = actual_up
    c2w[..., :3, 2] = forward
    c2w[..., :3, 3] = cam
    c2w[..., 3, 3] = 1.0
    return c2w


def rot_z(gamma) -> torch.Tensor:
    """Rotations about z by ``gamma`` (a scalar or [...], radians) →
    [..., 3, 3] (JAX ``core/spherical.py::rot_z``)."""
    gamma = torch.as_tensor(gamma, dtype=torch.float32)
    c, s = torch.cos(gamma), torch.sin(gamma)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], -1).reshape(*gamma.shape, 3, 3)


def random_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Uniform random SO(3) rotation from ``q`` [4] standard-normal draws
    (a random unit quaternion).  The draw is explicit: the caller passes the
    four normals (``jax.random.normal(key, (4,))`` in the JAX package)."""
    q = q / torch.linalg.norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def draw_rotation_normals(
    generator: Optional[torch.Generator], device: torch.device
) -> torch.Tensor:
    """The four standard normals :func:`random_rotation_matrix` consumes."""
    return torch.randn((4,), generator=generator, device=device)


@lru_cache(maxsize=16)
def icosphere_vertices(order: int) -> np.ndarray:
    """Vertices of an icosphere of subdivision ``order`` (vertex count
    10·order² + 2), deterministic ordering, unit norm, z-up."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    if order <= 1:
        return verts.astype(np.float32)

    vert_list = [v for v in verts]
    key_to_idx = {tuple(np.round(v, 9)): i for i, v in enumerate(vert_list)}

    def get_idx(p):
        p = p / np.linalg.norm(p)
        key = tuple(np.round(p, 9))
        if key not in key_to_idx:
            key_to_idx[key] = len(vert_list)
            vert_list.append(p)

    n = order
    for f in faces:
        a, b, c = verts[f[0]], verts[f[1]], verts[f[2]]
        for i in range(n + 1):
            for j in range(n + 1 - i):
                get_idx((i * a + j * b + (n - i - j) * c) / n)
    return np.stack(vert_list).astype(np.float32)
