"""The cells' scenes: the analytic sphere under a sun and an ambient sky of
the program's ``data/synthetic.py``, copied here so that the inputs are the
benchmark's own, with its look varied by the seed.

The seed moves the ring of cameras, the sun and the albedo; the number of
cameras and their resolution come from the configuration (``assumed``),
so every seed gives the same sizes and the same work.  The arrays are host
numpy; :func:`cameras` turns a camera set into a ``Cameras`` of the module
given (the program's or the reference's)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.reference.plain.core.spherical import fused_dot3, fused_normalize, look_at_target

SPHERE_RADIUS = 0.4
CAMERA_DISTANCE = 1.2
AMBIENT = 0.35
SUN_INTENSITY = 2.5
SKY_COLOUR = (0.35, 0.55, 0.95)
FOCAL_SHARE = 0.85  # focal length in pixels / width


def _rays(c2w: np.ndarray, width: int, height: int):
    yy, xx = np.meshgrid(np.arange(height, dtype=np.float32) + np.float32(0.5),
                         np.arange(width, dtype=np.float32) + np.float32(0.5), indexing="ij")
    v, u = yy.reshape(-1), xx.reshape(-1)
    f, cx, cy = np.float32(FOCAL_SHARE * width), np.float32(width / 2.0), np.float32(height / 2.0)
    dirs_cam = np.stack([(u - cx) / f, -(v - cy) / f, np.full_like(u, -1.0)], axis=-1)
    dirs = fused_dot3(c2w[None, :3, :3], dirs_cam[:, None, :])
    return np.broadcast_to(c2w[:3, 3], dirs.shape), fused_normalize(dirs)


def _camera_ring(rng: np.random.Generator, n: int, height_lo: float, height_hi: float) -> np.ndarray:
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False) + rng.uniform(0, 2 * np.pi / n)
    heights = rng.uniform(height_lo, height_hi, size=n)
    pos = np.stack([CAMERA_DISTANCE * np.cos(angles), CAMERA_DISTANCE * np.sin(angles), heights], -1)
    return look_at_target(pos.astype(np.float32), np.zeros((n, 3), np.float32))[..., :3, :]


def render(c2w: np.ndarray, width: int, height: int, sun: np.ndarray, albedo: np.ndarray) -> Dict[str, np.ndarray]:
    """Images [C, H, W, 3] and masks [C, H, W, 4] (static, fg, ground,
    sky) of cameras ``c2w`` [C, 3, 4]."""
    images, masks = [], []
    for m in c2w:
        o, d = (x.astype(np.float64) for x in _rays(m, width, height))
        oc = o
        b = 2.0 * np.sum(d * oc, axis=-1)
        c = np.sum(oc * oc, axis=-1) - SPHERE_RADIUS ** 2
        disc = b ** 2 - 4 * c
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
        hit = (disc > 0) & (t > 0)
        nrm = (o + d * t[..., None]) / SPHERE_RADIUS
        shade = AMBIENT + SUN_INTENSITY * np.maximum(nrm @ sun, 0.0)
        lin = albedo[None, :] * shade[..., None]
        rgb = np.clip(np.where(lin <= 0.0031308, 12.92 * lin, 1.055 * np.abs(lin) ** (1 / 2.4) - 0.055), 0, 1)
        images.append(np.where(hit[..., None], rgb, np.asarray(SKY_COLOUR)[None]).reshape(height, width, 3))
        mask = np.zeros((height, width, 4), np.float32)
        hit_img = hit.reshape(height, width)
        mask[..., 0] = 1.0
        mask[..., 1] = hit_img
        mask[..., 3] = ~hit_img
        masks.append(mask)
    return {"images": np.stack(images).astype(np.float32), "masks": np.stack(masks)}


def make_scene(seed: int, train_cameras: int, eval_cameras: int, width: int, height: int) -> Dict[str, Dict]:
    """``{"train": split, "eval": split}``, each split ``c2w``, ``focal``,
    ``width``, ``height``, ``images``, ``masks``: the train ring and an eval
    ring above it, lit by one sun (seeded)."""
    rng = np.random.default_rng([seed, 0x5CE4E])
    sun = rng.normal(size=3)
    sun[2] = abs(sun[2]) + 0.3
    sun /= np.linalg.norm(sun)
    albedo = rng.uniform(0.2, 0.8, size=3)
    out = {}
    for name, n, lo, hi in (("train", train_cameras, 0.1, 0.5), ("eval", eval_cameras, 0.5, 0.7)):
        c2w = _camera_ring(rng, n, lo, hi)
        out[name] = {"c2w": np.ascontiguousarray(c2w), "focal": FOCAL_SHARE * width, "width": width,
                     "height": height, **render(c2w, width, height, sun, albedo)}
    return out


def cameras(split: Dict, cameras_module):
    """The split's cameras as ``cameras_module.Cameras`` (CPU tensors)."""
    import torch

    n = split["c2w"].shape[0]
    f, w, h = split["focal"], split["width"], split["height"]
    return cameras_module.Cameras(
        camera_to_worlds=torch.from_numpy(split["c2w"]), fx=torch.full((n,), f), fy=torch.full((n,), f),
        cx=torch.full((n,), w / 2.0), cy=torch.full((n,), h / 2.0), width=w, height=h,
        camera_type=int(cameras_module.CameraType.PERSPECTIVE),
    )
