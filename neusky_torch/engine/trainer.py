"""Trainer: the step loop (mirror of ``neusky_tpu/engine/trainer.py``
``Trainer.run``, without the eval and save cadences, which are not ported
yet).  Entry point: runs on ``device`` (default CUDA; raises without a
card unless ``device="cpu"``)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from neusky_torch.data.datamanager import DataManager
from neusky_torch.device import resolve_device
from neusky_torch.engine import optimizers as opt_mod
from neusky_torch.engine.checkpoint import load_illumination_prior
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import PipelineConfig
from neusky_torch.parallel.mesh import make_train_step


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The JAX ``TrainerConfig`` fields this loop reads; the save and eval
    cadences come with their ports."""

    max_num_iterations: int = 100001
    steps_per_log: int = 100
    seed: int = 42


class Trainer:
    def __init__(
        self,
        config: TrainerConfig,
        model: NeuSkyModel,
        pipeline_config: PipelineConfig,
        datamanager: DataManager,
        optimizer_groups: Optional[Dict[str, opt_mod.OptimizerGroupConfig]] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if model.device != self.device or datamanager.device != self.device:
            raise ValueError("model, datamanager and trainer must share one device")
        self.config = config
        self.model = model
        self.pipeline_config = pipeline_config
        self.datamanager = datamanager
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.params = model.init(self.generator)
        self.params = load_illumination_prior(self.params, model.config)
        groups = optimizer_groups or opt_mod.default_neusky_optimizer_groups(config.max_num_iterations)
        self.optimizer = opt_mod.GroupedAdam(self.params, groups)
        self.train_step = make_train_step(model, pipeline_config, self.optimizer)
        self.step = 0
        self.history: list = []

    def _count_rays(self, batch) -> int:
        """Rays of one step, by the JAX loop's rule: the scene rays, plus the
        DDF-fit rays when the visibility field is fitted, plus the sky rays
        (1,024 + 1,024 + 256 = 2,304 for the canonical joint step)."""
        if "ray_bundle" in batch:
            n = int(batch["ray_bundle"].origins.shape[0])
        else:
            n = int(batch["pixel_coords"].shape[0])
        if self.model.config.fit_visibility_field and self.model.ddf is not None:
            s = self.pipeline_config.visibility_train_sampler
            n += s.num_samples_on_sphere * s.num_rays_per_sample
        if "sky_ray_bundle" in batch:
            n += int(batch["sky_ray_bundle"].origins.shape[0])
        elif "sky_cam_idx" in batch:
            n += int(batch["sky_cam_idx"].shape[0])
        return n

    def run(self, num_steps: Optional[int] = None, log_fn: Optional[Callable] = None):
        """Run ``num_steps`` steps (default: to the configured maximum)."""
        target = self.step + (num_steps or self.config.max_num_iterations)
        t_start = time.perf_counter()
        rays_done = 0
        while self.step < target:
            batch = self.datamanager.next_train(self.step)
            aux = self.train_step(self.params, batch, float(self.step), generator=self.generator)
            rays_done += self._count_rays(batch)
            self.step += 1
            if self.step % self.config.steps_per_log == 0 or self.step == target:
                total = float(aux["total_loss"])  # waits for the device
                dt = time.perf_counter() - t_start
                record = {
                    "step": self.step,
                    "total_loss": total,
                    "rays_per_sec": rays_done / max(dt, 1e-9),
                    **{k: float(v) for k, v in aux["metrics"].items()},
                    **{k: float(v) for k, v in aux["loss_dict"].items()},
                }
                self.history.append(record)
                if log_fn:
                    log_fn(record)
        return self.history
