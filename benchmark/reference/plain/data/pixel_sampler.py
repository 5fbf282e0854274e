"""Host-side pixel sampling into fixed-shape batches (mirror of
``neusky_tpu/data/pixel_sampler.py``, numpy sampler).  Given the same seed
it draws the same pixels as the JAX package's sampler."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PixelSamplerConfig:
    images_per_batch: int = 16
    rays_per_image: int = 64


class PixelSampler:
    """Per-image valid-index tables; batches of U images × R rays drawn
    with a numpy ``Generator``.  Batches are host numpy and carry
    (cam_idx, pixel_coords): the step generates the rays from them (the JAX
    package's ``device_rays`` mode, the only one ported)."""

    def __init__(self, config: PixelSamplerConfig, images: np.ndarray, masks: np.ndarray, seed: int = 0):
        self.config = config
        self.images = images
        self.masks = masks
        self.num_images, self.height, self.width = images.shape[:3]
        self.rng = np.random.default_rng(seed)
        flat = (masks[..., 0] > 0.5).reshape(self.num_images, -1)
        counts = flat.sum(axis=1)
        max_count = int(counts.max())
        self.valid_idx = np.zeros((self.num_images, max_count), np.int64)
        for i in range(self.num_images):
            idx = np.nonzero(flat[i])[0]
            reps = int(np.ceil(max_count / max(len(idx), 1)))
            self.valid_idx[i] = np.tile(idx, reps)[:max_count]
        self.valid_counts = counts
        sky_flat = (masks[..., 3] > 0.5).reshape(self.num_images, -1)
        sky_counts = sky_flat.sum(axis=1)
        self.has_sky = sky_counts.min() > 0
        if self.has_sky:
            max_sky = int(sky_counts.max())
            self.sky_idx = np.zeros((self.num_images, max_sky), np.int64)
            for i in range(self.num_images):
                idx = np.nonzero(sky_flat[i])[0]
                reps = int(np.ceil(max_sky / len(idx)))
                self.sky_idx[i] = np.tile(idx, reps)[:max_sky]

    def _pixels_to_batch(self, image_rows: np.ndarray, flat_pixels: np.ndarray) -> Dict:
        u, r = flat_pixels.shape
        ys = (flat_pixels // self.width).astype(np.float32) + 0.5
        xs = (flat_pixels % self.width).astype(np.float32) + 0.5
        coords = np.stack([ys, xs], axis=-1).reshape(-1, 2)
        cam_idx = np.repeat(image_rows, r).astype(np.int32)
        flat = flat_pixels.reshape(-1)
        return {
            "image_indices": image_rows.astype(np.int32),
            "ray_image_idx": np.repeat(np.arange(u, dtype=np.int32), r),
            "cam_idx": cam_idx,
            "pixel_coords": coords,
            "image": np.ascontiguousarray(self.images.reshape(self.num_images, -1, 3)[cam_idx, flat]),
            "mask": np.ascontiguousarray(self.masks.reshape(self.num_images, -1, 4)[cam_idx, flat]),
        }

    def sample_batch(self) -> Dict:
        c = self.config
        u = min(c.images_per_batch, self.num_images)
        image_rows = self.rng.choice(self.num_images, size=u, replace=(u > self.num_images))
        cols = self.rng.integers(0, self.valid_idx.shape[1], size=(u, c.rays_per_image))
        return self._pixels_to_batch(image_rows, self.valid_idx[image_rows[:, None], cols])

    def sample_sky_rays(self, num_rays: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(cam_idx [K], coords [K, 2]) of sky pixels, or None."""
        if not self.has_sky:
            return None
        rows = self.rng.integers(0, self.num_images, size=num_rays)
        cols = self.rng.integers(0, self.sky_idx.shape[1], size=num_rays)
        flat = self.sky_idx[rows, cols]
        ys = (flat // self.width).astype(np.float32) + 0.5
        xs = (flat % self.width).astype(np.float32) + 0.5
        return rows.astype(np.int32), np.stack([ys, xs], axis=-1)

    def sample_region_batch(self, image_row: int, region: str = "full_image") -> Dict:
        """Eval-latent fitting batch of U·R pixels of one image, drawn
        uniformly from its ``"left_image_half"``, ``"right_image_half"`` or
        (otherwise) ``"full_image"``."""
        c = self.config
        r = c.images_per_batch * c.rays_per_image
        if region == "left_image_half":
            xs = self.rng.integers(0, self.width // 2, size=r)
        elif region == "right_image_half":
            xs = self.rng.integers(self.width // 2, self.width, size=r)
        else:
            xs = self.rng.integers(0, self.width, size=r)
        ys = self.rng.integers(0, self.height, size=r)
        return self._pixels_to_batch(np.asarray([image_row]), (ys * self.width + xs).reshape(1, r))
