"""Synthetic analytic scene (mirror of ``neusky_tpu/data/synthetic.py``): a
sphere under a sun + ambient sky, rendered in closed form — images, 4-channel
masks (static, fg, ground, sky) and cameras with known geometry.

The cameras and the rendered rays are computed on the host in float32 in
the JAX package's order on the CPU (fused multiply-adds in the cross
products, norms and the camera-to-world product), so the two scenes agree
bit for bit, silhouette pixels included."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from neusky_torch.core.cameras import Cameras, CameraType
from neusky_torch.core.spherical import fused_dot3, fused_normalize, look_at_target


@dataclasses.dataclass(frozen=True)
class SyntheticSceneConfig:
    num_cameras: int = 8
    width: int = 48
    height: int = 48
    sphere_radius: float = 0.4
    sphere_center: tuple = (0.0, 0.0, 0.0)
    camera_distance: float = 1.2
    camera_height: float = 0.35
    albedo: tuple = (0.7, 0.4, 0.3)
    sun_direction: tuple = (0.3, -0.5, 0.8)
    sun_intensity: float = 2.5
    ambient: float = 0.35
    sky_colour: tuple = (0.35, 0.55, 0.95)
    focal: float = 0.0  # ≤ 0 → 0.85 × width
    angle_offset: float = 0.0

    @property
    def focal_px(self) -> float:
        return self.focal if self.focal > 0 else 0.85 * self.width


def _sphere_hit(origins: np.ndarray, dirs: np.ndarray, center, radius):
    oc = origins - np.asarray(center)
    b = 2.0 * np.sum(dirs * oc, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius**2
    disc = b**2 - 4 * c
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
    return (disc > 0) & (t > 0), t


def _render_rays(c2w: np.ndarray, config: SyntheticSceneConfig):
    """(origins, unit directions) [H·W, 3] of one camera (c2w [3, 4]) at the
    pixel centres, row-major: ``Cameras.generate_rays`` in the JAX
    package's float32 order."""
    c = config
    yy, xx = np.meshgrid(np.arange(c.height, dtype=np.float32) + np.float32(0.5),
                         np.arange(c.width, dtype=np.float32) + np.float32(0.5), indexing="ij")
    v, u = yy.reshape(-1), xx.reshape(-1)
    f, cx, cy = np.float32(c.focal_px), np.float32(c.width / 2.0), np.float32(c.height / 2.0)
    dirs_cam = np.stack([(u - cx) / f, -(v - cy) / f, np.full_like(u, -1.0)], axis=-1)
    dirs = fused_dot3(c2w[None, :3, :3], dirs_cam[:, None, :])  # [H·W, 3]
    return np.broadcast_to(c2w[:3, 3], dirs.shape), fused_normalize(dirs)


def generate_synthetic_scene(config: SyntheticSceneConfig) -> Dict[str, object]:
    """``images`` [C, H, W, 3], ``masks`` [C, H, W, 4], ``depths``,
    ``normals`` (numpy) and CPU ``cameras``."""
    c = config
    angles = np.linspace(0, 2 * np.pi, c.num_cameras, endpoint=False) + c.angle_offset
    cam_pos = np.stack(
        [c.camera_distance * np.cos(angles), c.camera_distance * np.sin(angles),
         np.full_like(angles, c.camera_height)],
        axis=-1,
    ).astype(np.float32)
    c2w = look_at_target(cam_pos, np.zeros_like(cam_pos))[..., :3, :]
    n = c.num_cameras
    cameras = Cameras(
        camera_to_worlds=torch.from_numpy(np.ascontiguousarray(c2w)),
        fx=torch.full((n,), c.focal_px), fy=torch.full((n,), c.focal_px),
        cx=torch.full((n,), c.width / 2.0), cy=torch.full((n,), c.height / 2.0),
        width=c.width, height=c.height, camera_type=int(CameraType.PERSPECTIVE),
    )
    sun = np.asarray(c.sun_direction, np.float64)
    sun = sun / np.linalg.norm(sun)
    albedo = np.asarray(c.albedo)
    images, masks, depths, normals_out = [], [], [], []
    for i in range(n):
        o, d = (x.astype(np.float64) for x in _render_rays(c2w[i], c))
        hit, t = _sphere_hit(o, d, c.sphere_center, c.sphere_radius)
        nrm = (o + d * t[..., None] - np.asarray(c.sphere_center)) / c.sphere_radius
        shade = c.ambient + c.sun_intensity * np.maximum(nrm @ sun, 0.0)
        rgb_lin = albedo[None, :] * shade[..., None]
        rgb = np.where(rgb_lin <= 0.0031308, 12.92 * rgb_lin, 1.055 * np.abs(rgb_lin) ** (1 / 2.4) - 0.055)
        rgb = np.clip(rgb, 0, 1)
        img = np.where(hit[..., None], rgb, np.asarray(c.sky_colour)[None, :])
        images.append(img.reshape(c.height, c.width, 3).astype(np.float32))
        hit_img = hit.reshape(c.height, c.width)
        mask = np.zeros((c.height, c.width, 4), np.float32)
        mask[..., 0] = 1.0
        mask[..., 1] = hit_img
        mask[..., 3] = ~hit_img
        masks.append(mask)
        depths.append(np.where(hit, t, 0.0).reshape(c.height, c.width).astype(np.float32))
        normals_out.append(np.where(hit[..., None], nrm, 0.0).reshape(c.height, c.width, 3).astype(np.float32))
    return {
        "images": np.stack(images),
        "masks": np.stack(masks),
        "depths": np.stack(depths),
        "normals": np.stack(normals_out),
        "cameras": cameras,
    }
