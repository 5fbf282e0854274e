"""The NeRF-OSR relighting evaluation protocol's batches (mirror of
``neusky_tpu/data/nerfosr_eval.py``; with the same seed it draws the same
pixels).

- **optimise set**: one holdout image per lighting session
  (``session_holdout_indices``); the eval latents are fitted on these;
- **compare set**: the test images with NeRF-OSR eval masks; metrics are
  computed there, restricted to the building mask (mask channel 0 of the
  test split);
- **session → latent slot**: all images of a session share one latent, so
  the holdout's fitted sky relights its whole session;
- in the ``nerf_osr_envmap`` eval mode the latents come from the sessions'
  envmaps and only a per-session rotation about z and the scale are fitted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from neusky_torch.core.cameras import Cameras
from neusky_torch.data.pixel_sampler import PixelSampler, PixelSamplerConfig


@dataclasses.dataclass
class NeRFOSREvalProtocol:
    """The test split (host numpy images and masks, cameras on the eval
    device) and its session maps, as eval batch sources."""

    cameras: Cameras
    images: np.ndarray  # [C, H, W, 3]
    masks: np.ndarray  # [C, H, W, 4] (channel 0: the test eval mask where there is one)
    session_to_indices: Dict[int, List[int]]
    indices_to_session: Dict[int, int]
    session_holdout_indices: List[int]
    test_eval_mask_indices: List[int]  # the images with NeRF-OSR eval masks
    pixel_config: PixelSamplerConfig = PixelSamplerConfig(images_per_batch=4, rays_per_image=256)
    seed: int = 0

    def __post_init__(self):
        self.optimise_indices = [
            self.session_to_indices[s][h]
            for s, h in zip(sorted(self.session_to_indices.keys()), self.session_holdout_indices)
        ]
        self.compare_indices = list(self.test_eval_mask_indices)
        overlap = set(self.optimise_indices) & set(self.compare_indices)
        if overlap:
            raise ValueError(f"holdout images {sorted(overlap)} are also compare images")
        self._sampler = PixelSampler(self.pixel_config, self.images, self.masks, self.seed)
        self.num_sessions = len(self.session_to_indices)

    def latent_slot_of_image(self, image_idx: int) -> int:
        """Image → eval-latent slot: its session."""
        return self.indices_to_session[image_idx]

    def lighting_eval_batch(self, mode: str = "optimise") -> Dict:
        """A host batch of U images × R pixels from the ``"optimise"`` or
        ``"compare"`` pool, with the cameras; its ``image_indices`` are
        latent slots (sessions), so a session's images share one latent."""
        pool = self.optimise_indices if mode == "optimise" else self.compare_indices
        rng = self._sampler.rng
        u = min(self.pixel_config.images_per_batch, len(pool))
        chosen = rng.choice(pool, size=u, replace=len(pool) < u)
        cols = rng.integers(0, self._sampler.valid_idx.shape[1], size=(u, self.pixel_config.rays_per_image))
        batch = self._sampler._pixels_to_batch(chosen, self._sampler.valid_idx[chosen[:, None], cols])
        batch["image_indices"] = np.asarray([self.latent_slot_of_image(int(i)) for i in chosen], np.int32)
        batch["cameras"] = self.cameras
        return batch

    def compare_image(self, i: int):
        """(image index, latent slot, full-image ray bundle, ground truth:
        host ``image`` [H·W, 3] and ``mask`` [H·W, 4]) of the i-th compare
        image."""
        image_idx = self.compare_indices[i]
        batch = {"image": self.images[image_idx].reshape(-1, 3), "mask": self.masks[image_idx].reshape(-1, 4),
                 "image_idx": image_idx}
        return image_idx, self.latent_slot_of_image(image_idx), self.cameras.generate_rays(image_idx), batch


def global_least_squares_scale(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """``pred`` times the one scale α = <gt, pred> / <pred, pred> that best
    fits it to ``gt``."""
    p = pred.reshape(-1)
    g = gt.reshape(-1)
    alpha = float(g @ p) / max(float(p @ p), 1e-12)
    return alpha * pred
