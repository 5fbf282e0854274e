"""Trainer: the step loop with its log, eval and save cadences, and
checkpoint save / resume (mirror of ``neusky_tpu/engine/trainer.py``).
Entry point: runs on ``device`` (default CUDA; raises without a card unless
``device="cpu"``)."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from neusky_torch.data.datamanager import DataManager
from neusky_torch.device import resolve_device
from neusky_torch.engine import optimizers as opt_mod
from neusky_torch.engine.checkpoint import load_checkpoint, load_illumination_prior, save_checkpoint
from neusky_torch.engine.eval_loop import eval_image_metrics, fit_eval_latents
from neusky_torch.engine.eval_panels import image_metrics_and_panels
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import PipelineConfig
from neusky_torch.parallel.mesh import make_train_step
from neusky_torch.tree import tree_items


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_num_iterations: int = 100001
    steps_per_save: int = 5000
    steps_per_eval_image: int = 5000
    steps_per_log: int = 100
    output_dir: str = "outputs/run"
    seed: int = 42
    use_split_step: bool = False
    """The JAX step split into three executables; not ported (raises)."""


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
        if config.use_split_step:
            raise NotImplementedError("use_split_step (the three-executable JAX step) is not ported")
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
        self.writer = None

    def attach_writer(self, writer):
        self.writer = writer
        return self

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
        """Run ``num_steps`` steps (default: to the configured maximum):
        log every ``steps_per_log`` steps and at the last, run an eval pass
        every ``steps_per_eval_image`` steps when there is an eval split,
        and save every ``steps_per_save`` steps."""
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
                if self.writer is not None:
                    self.writer.write_scalars(self.step, record)
            if self.step % self.config.steps_per_eval_image == 0 and self.datamanager.num_eval > 0:
                self._eval_image_pass()
            if self.step % self.config.steps_per_save == 0:
                self.save()
        return self.history

    def _eval_image_pass(self):
        """Fit the eval latents of every eval image (the training params
        untouched), render one eval image (the next in turn) and score it;
        with a writer, write the scores and the eval panels."""
        image_idx = (self.step // self.config.steps_per_eval_image - 1) % max(self.datamanager.num_eval, 1)
        params, _ = fit_eval_latents(self.model, self.params, self.datamanager)
        m = eval_image_metrics(self.model, params, self.datamanager, image_idx)
        outputs = m.pop("outputs")
        record = {f"eval_{k}": v for k, v in m.items() if v is not None}
        self.history.append({"step": self.step, **record})
        if self.writer is not None:
            self.writer.write_scalars(self.step, record)
            cams = self.datamanager.eval_cameras
            _, batch = self.datamanager.eval_image_bundle(image_idx)
            _, panels = image_metrics_and_panels(self.model, params, outputs, batch, cams.height, cams.width,
                                                 latent_slot=image_idx)
            for name, img in panels.items():
                self.writer.write_image(self.step, name, img)

    def save(self, path: Optional[str] = None):
        save_checkpoint(Path(path or self.config.output_dir), self.step, self.params, self.optimizer.state_dict())

    def load(self, path: str, step: Optional[int] = None):
        """Resume: params (copied into this trainer's tensors, which the
        optimizer holds), the Adam state and the step; the training batch
        stream moves to the step (``DataManager.reseed``).  The checkpoint
        holds no generator state: the draw stream goes on from this
        trainer's seed, as JAX's does, so a resumed run is not the run that
        did not stop, draw for draw."""
        params, opt_state, self.step = load_checkpoint(Path(path), step, self.params, self.optimizer.state_dict())
        restored = dict(tree_items(params))
        with torch.no_grad():
            for k, t in tree_items(self.params):
                t.copy_(restored[k])
        self.optimizer.load_state_dict(opt_state)
        self.datamanager.reseed(self.step)
