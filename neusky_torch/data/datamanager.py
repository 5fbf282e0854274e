"""DataManager (mirror of ``neusky_tpu/data/datamanager.py``, numpy
sampler): owns the train split and an optional eval split, emits per-step
training batches as tensors on its device, full-image eval bundles, and the
region batches of test-time latent fitting.  The C++ prefetch sampler is
not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neusky_torch.core.cameras import Cameras
from neusky_torch.core.rays import RayBundle
from neusky_torch.data.pixel_sampler import PixelSampler, PixelSamplerConfig
from neusky_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataManagerConfig:
    pixel_sampler: PixelSamplerConfig = PixelSamplerConfig()
    num_sky_rays: int = 256
    seed: int = 0


def batch_to_device(batch: Dict, cameras: Cameras, device) -> Dict:
    """Host numpy batch → tensors on ``device`` (+ the cameras)."""
    out = {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True) for k, v in batch.items()}
    for k in ("cam_idx", "image_indices", "ray_image_idx", "sky_cam_idx"):
        if k in out:
            out[k] = out[k].long()
    out["cameras"] = cameras
    return out


class DataManager:
    """Entry point: keeps its cameras on ``device`` (default CUDA; raises
    without a card unless ``device="cpu"``); images and masks stay host
    numpy.  The eval sampler is seeded ``seed + 1``, as in JAX."""

    def __init__(self, config: DataManagerConfig, train_cameras: Cameras, train_images: np.ndarray,
                 train_masks: np.ndarray, eval_cameras: Optional[Cameras] = None,
                 eval_images: Optional[np.ndarray] = None, eval_masks: Optional[np.ndarray] = None,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.train_sampler = PixelSampler(config.pixel_sampler, train_images, train_masks, seed=config.seed)
        self.eval_sampler = None
        if eval_cameras is not None:
            self.eval_sampler = PixelSampler(config.pixel_sampler, eval_images, eval_masks, seed=config.seed + 1)
        self.train_cameras = train_cameras.to(self.device)
        self.eval_cameras = eval_cameras.to(self.device) if eval_cameras is not None else None
        self.train_images, self.train_masks = train_images, train_masks
        self.eval_images, self.eval_masks = eval_images, eval_masks

    @property
    def num_train(self) -> int:
        return self.train_sampler.num_images

    @property
    def num_eval(self) -> int:
        return self.eval_sampler.num_images if self.eval_sampler else 0

    def reseed(self, step: int) -> None:
        """Move the training batch stream to a resume step: the stream of
        ``np.random.default_rng((seed, step))``, so a resumed run neither
        replays the stream from its start nor depends on how it got there."""
        self.train_sampler.rng = np.random.default_rng((self.config.seed, step))

    def next_train(self, step: int = 0) -> Dict:
        """Scene batch + sky-ray pixels, on the device."""
        batch = self.train_sampler.sample_batch()
        sky = self.train_sampler.sample_sky_rays(self.config.num_sky_rays)
        if sky is not None:
            batch["sky_cam_idx"], batch["sky_pixel_coords"] = sky
        return batch_to_device(batch, self.train_cameras, self.device)

    def _eval_split(self):
        if self.eval_cameras is not None:
            return self.eval_cameras, self.eval_images, self.eval_masks
        return self.train_cameras, self.train_images, self.train_masks

    def eval_image_bundle(self, image_idx: int) -> Tuple[RayBundle, Dict]:
        """The full-image ray bundle of eval image ``image_idx`` (on the
        device, row-major) and its ground truth (host numpy ``image``
        [H·W, 3], ``mask`` [H·W, 4]); the train split when there is no
        eval split."""
        cams, imgs, msks = self._eval_split()
        batch = {"image": imgs[image_idx].reshape(-1, 3), "mask": msks[image_idx].reshape(-1, 4),
                 "image_idx": image_idx}
        return cams.generate_rays(image_idx), batch

    def eval_latent_batch(self, image_idx: int, region: str = "full_image") -> Dict:
        """One region batch of eval image ``image_idx`` for test-time latent
        fitting (:meth:`PixelSampler.sample_region_batch`): host numpy, with
        the split's ``cameras`` on the device (the fit stacks many batches
        on the host and copies them at once)."""
        sampler = self.eval_sampler or self.train_sampler
        return {**sampler.sample_region_batch(image_idx, region), "cameras": self._eval_split()[0]}
