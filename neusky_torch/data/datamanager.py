"""DataManager (mirror of ``neusky_tpu/data/datamanager.py``): owns the
train split and an optional eval split, emits per-step training batches as
tensors on its device, full-image eval bundles, and the region batches of
test-time latent fitting.  Training batches come from the numpy
``PixelSampler`` or, with ``use_native_sampler``, from the C++ sampler and
its prefetch thread (``data/native_sampler.py``), which draws each batch's
sky rays after its pixels and raises where it cannot be built."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neusky_torch.core.cameras import Cameras
from neusky_torch.core.rays import RayBundle
from neusky_torch.data.native_sampler import NativeBatchSampler
from neusky_torch.data.pixel_sampler import PixelSampler, PixelSamplerConfig
from neusky_torch.device import resolve_device
from neusky_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DataManagerConfig:
    pixel_sampler: PixelSamplerConfig = PixelSamplerConfig()
    num_sky_rays: int = 256
    seed: int = 0
    use_native_sampler: bool = False
    """Draw training batches and sky rays from the C++ sampler, whose thread
    prefetches ``native_queue_depth`` batches, each with its sky rays, while
    the step runs."""
    native_queue_depth: int = 4


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
        self._native: Optional[NativeBatchSampler] = None
        if config.use_native_sampler:
            self._start_native(config.seed)

    @property
    def num_train(self) -> int:
        return self.train_sampler.num_images

    @property
    def num_eval(self) -> int:
        return self.eval_sampler.num_images if self.eval_sampler else 0

    def _start_native(self, seed: int) -> None:
        ps = self.config.pixel_sampler
        if self._native is not None:
            self._native.close()
        self._native = NativeBatchSampler(self.train_images, self.train_masks, seed=seed)
        self._native_u = min(ps.images_per_batch, self.num_train)
        n_sky = self.config.num_sky_rays if self._native.has_sky else 0
        self._native.start_prefetch(self._native_u, ps.rays_per_image, self.config.native_queue_depth, n_sky)

    def reseed(self, step: int) -> None:
        """Move the training batch stream to a resume step: the stream of
        ``np.random.default_rng((seed, step))``, so a resumed run neither
        replays the stream from its start nor depends on how it got there.
        The native sampler is rebuilt from a 32-bit seed folded from
        (seed, step), as in JAX."""
        self.train_sampler.rng = np.random.default_rng((self.config.seed, step))
        if self._native is not None:
            self._start_native(int(np.random.SeedSequence([self.config.seed, step]).generate_state(1)[0]))

    def next_train(self, step: int = 0) -> Dict:
        """Scene batch + sky-ray pixels, on the device."""
        with span("data.next_train"):
            with span("data.sample"):
                if self._native is not None:
                    batch, sky = self._native_batch()
                else:
                    batch = self.train_sampler.sample_batch()
                    sky = self.train_sampler.sample_sky_rays(self.config.num_sky_rays)
                if sky is not None:
                    batch["sky_cam_idx"], batch["sky_pixel_coords"] = sky
            with span("data.to_device"):
                return batch_to_device(batch, self.train_cameras, self.device)

    def _native_pixel_coords(self, pixels: np.ndarray) -> np.ndarray:
        w = self._native.width
        return np.stack([(pixels // w).astype(np.float32) + 0.5, (pixels % w).astype(np.float32) + 0.5], axis=-1)

    def _native_batch(self):
        """The next prefetched native batch in the numpy sampler's layout,
        and its sky rays (None where a training image has no sky pixel)."""
        u, r = self._native_u, self.config.pixel_sampler.rays_per_image
        rows, pixels, rgb, mask, *sky = self._native.next_batch()
        batch = {
            "image_indices": rows.astype(np.int32),
            "ray_image_idx": np.repeat(np.arange(u, dtype=np.int32), r),
            "cam_idx": np.repeat(rows, r).astype(np.int32),
            "pixel_coords": self._native_pixel_coords(pixels),
            "image": rgb,
            "mask": mask,
        }
        return batch, (sky[0], self._native_pixel_coords(sky[1])) if sky else None

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
