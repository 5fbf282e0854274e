"""Sphere math (mirror of ``neusky_tpu/core/spherical.py``): ray/sphere
intersection, look-at frames, random rotations and the icosphere."""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch


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


def look_at_target(
    camera_positions: np.ndarray, target_positions: np.ndarray, up_vector=(0.0, 0.0, 1.0)
) -> np.ndarray:
    """c2w matrices [..., 4, 4] looking from cameras at targets (OpenGL
    convention: forward = −view direction).  Host-side numpy in float32."""
    cam = np.asarray(camera_positions, np.float32)
    tgt = np.asarray(target_positions, np.float32)
    up = np.broadcast_to(np.asarray(up_vector, np.float32), cam.shape)

    def normalize(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    forward = -normalize(tgt - cam)
    right = normalize(np.cross(up, forward))
    actual_up = normalize(np.cross(forward, right))
    c2w = np.zeros(cam.shape[:-1] + (4, 4), np.float32)
    c2w[..., :3, 0] = right
    c2w[..., :3, 1] = actual_up
    c2w[..., :3, 2] = forward
    c2w[..., :3, 3] = cam
    c2w[..., 3, 3] = 1.0
    return c2w


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
