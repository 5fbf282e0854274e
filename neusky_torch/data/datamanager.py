"""DataManager (mirror of ``neusky_tpu/data/datamanager.py``, numpy
sampler): owns the train split and emits per-step batches as tensors on
its device.  The C++ prefetch sampler and the eval split are not ported
yet."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from neusky_torch.core.cameras import Cameras
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
    def __init__(self, config: DataManagerConfig, train_cameras: Cameras, train_images: np.ndarray,
                 train_masks: np.ndarray, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.train_sampler = PixelSampler(config.pixel_sampler, train_images, train_masks, seed=config.seed)
        self.train_cameras = train_cameras.to(self.device)

    def next_train(self, step: int = 0) -> Dict:
        """Scene batch + sky-ray pixels, on the device."""
        batch = self.train_sampler.sample_batch()
        sky = self.train_sampler.sample_sky_rays(self.config.num_sky_rays)
        if sky is not None:
            batch["sky_cam_idx"], batch["sky_pixel_coords"] = sky
        return batch_to_device(batch, self.train_cameras, self.device)
