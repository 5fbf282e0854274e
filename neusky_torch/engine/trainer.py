"""Trainer: the step loop with its log, eval and save cadences, and
checkpoint save / resume (mirror of ``neusky_tpu/engine/trainer.py``).
Entry point: runs on ``device`` (default CUDA; raises without a card unless
``device="cpu"``).

With ``mesh`` (:func:`~neusky_torch.parallel.mesh.make_mesh`) the trainer
is one rank of a multi-device run: every rank builds it alike (the same
config, seed and data), the parameters are broadcast from rank 0 once, and
each rank draws the global batch from its own sampler (the samplers'
streams, the native one's prefetched stream included, are the same on
every rank) and trains on its shard of it
(:func:`~neusky_torch.parallel.mesh.shard_batch`).  Over NCCL a rank's
step runs as one CUDA graph replay with its collectives; over gloo
eagerly.  Every rank runs the
eval passes as one process does, with the model off its mesh, as every
JAX process runs them; rank 0 alone logs, writes and saves, and its
checkpoint resumes in one process."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from neusky_torch.data.datamanager import DataManager
from neusky_torch.device import resolve_device
from neusky_torch.engine import optimizers as opt_mod
from neusky_torch.engine.checkpoint import load_illumination_prior, resume_into, save_checkpoint
from neusky_torch.engine.eval_loop import eval_image_metrics, fit_eval_latents
from neusky_torch.engine.eval_panels import image_metrics_and_panels
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import PipelineConfig
from neusky_torch.parallel.mesh import (
    make_train_step,
    make_train_step_split,
    replicate,
    shard_batch,
)
from neusky_torch.utils import profiling
from neusky_torch.utils.profiling import span


def count_rays(model: NeuSkyModel, pipeline_config: PipelineConfig, batch) -> int:
    """Rays of one step, by the JAX loop's rule: the scene rays, plus the
    DDF-fit rays when the visibility field is fitted, plus the sky rays
    (1,024 + 1,024 + 256 = 2,304 for the canonical joint step)."""
    if "ray_bundle" in batch:
        n = int(batch["ray_bundle"].origins.shape[0])
    else:
        n = int(batch["pixel_coords"].shape[0])
    if model.config.fit_visibility_field and model.ddf is not None:
        s = pipeline_config.visibility_train_sampler
        n += s.num_samples_on_sphere * s.num_rays_per_sample
    if "sky_ray_bundle" in batch:
        n += int(batch["sky_ray_bundle"].origins.shape[0])
    elif "sky_cam_idx" in batch:
        n += int(batch["sky_cam_idx"].shape[0])
    return n


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_num_iterations: int = 100001
    steps_per_save: int = 5000
    steps_per_eval_image: int = 5000
    steps_per_log: int = 100
    output_dir: str = "outputs/run"
    seed: int = 42
    use_split_step: bool = False
    """Take the scene gradient and the DDF-fit gradient in two passes and
    sum them before one update (``make_train_step_split``): the same step
    at a lower peak memory."""


class Trainer:
    def __init__(
        self,
        config: TrainerConfig,
        model: NeuSkyModel,
        pipeline_config: PipelineConfig,
        datamanager: DataManager,
        optimizer_groups: Optional[Dict[str, opt_mod.OptimizerGroupConfig]] = None,
        device="cuda",
        mesh=None,
        graphed: Optional[bool] = None,
    ):
        """``graphed`` as the step factories' (``parallel/mesh.py``): None
        captures the training step as a CUDA graph on the card, alone or
        as a rank of an NCCL mesh (and its eval passes' latent fits,
        renders and LPIPS the same way, with or without a mesh), False runs
        them eagerly; True raises on the CPU or with a gloo mesh."""
        with span("trainer.init"):
            self.device = resolve_device(device)
            if model.device != self.device or datamanager.device != self.device:
                raise ValueError("model, datamanager and trainer must share one device")
            self.config = config
            self.model = model
            self.pipeline_config = pipeline_config
            self.datamanager = datamanager
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(config.seed)
            with span("model.init"):
                self.params = model.init(self.generator)
            with span("prior.load"):
                self.params = load_illumination_prior(self.params, model.config)
            self.mesh = mesh
            self.is_main = mesh is None or dist.get_rank() == 0
            if mesh is not None:
                model.set_mesh(mesh)
                self.params = replicate(self.params, mesh)
            groups = optimizer_groups or opt_mod.default_neusky_optimizer_groups(config.max_num_iterations)
            with span("optimizer.build"):
                self.optimizer = opt_mod.GroupedAdam(self.params, groups)
            make_step = make_train_step_split if config.use_split_step else make_train_step
            with span("step.build"):
                self.train_step = make_step(model, pipeline_config, self.optimizer, mesh, graphed)
        self.graphed = graphed
        self.step = 0
        self.history: list = []
        self.writer = None

    def attach_writer(self, writer):
        self.writer = writer
        return self

    def _count_rays(self, batch) -> int:
        return count_rays(self.model, self.pipeline_config, batch)

    def run(self, num_steps: Optional[int] = None, log_fn: Optional[Callable] = None):
        """Run ``num_steps`` steps (default: to the configured maximum):
        log every ``steps_per_log`` steps and at the last, run an eval pass
        every ``steps_per_eval_image`` steps when there is an eval split,
        and save every ``steps_per_save`` steps.  A log record's
        ``rays_per_sec`` counts the rays and the time since the previous
        record of this call (its first, since the call began)."""
        target = self.step + (num_steps or self.config.max_num_iterations)
        t_start = time.perf_counter()
        rays_done = 0
        while self.step < target:
            with span("trainer.step"):
                batch = self.datamanager.next_train(self.step)
                rays_done += self._count_rays(batch)
                if self.mesh is not None:
                    batch = shard_batch(batch, self.mesh)
                aux = self.train_step(self.params, batch, float(self.step), generator=self.generator)
                self.step += 1
                if self.step % self.config.steps_per_log == 0 or self.step == target:
                    with span("trainer.log"):
                        total = float(aux["total_loss"])  # waits for the device
                        profiling.collect()
                        now = time.perf_counter()
                        record = {
                            "step": self.step,
                            "total_loss": total,
                            "rays_per_sec": rays_done / max(now - t_start, 1e-9),
                            **{k: float(v) for k, v in aux["metrics"].items()},
                            **{k: float(v) for k, v in aux["loss_dict"].items()},
                        }
                        t_start, rays_done = now, 0
                        self.history.append(record)
                        if log_fn and self.is_main:
                            log_fn(record)
                        if self.writer is not None and self.is_main:
                            self.writer.write_scalars(self.step, record)
                if self.step % self.config.steps_per_eval_image == 0 and self.datamanager.num_eval > 0:
                    self._eval_image_pass()
                if self.step % self.config.steps_per_save == 0:
                    self.save()
        return self.history

    def _eval_image_pass(self):
        """Fit the eval latents of every eval image (the training params
        untouched), render one eval image (the next in turn) and score it;
        with a writer, write the scores and the eval panels.  On a mesh the
        model leaves it for the pass (every rank holds the eval batches
        whole and runs the one-process pass) and goes back on it after."""
        image_idx = (self.step // self.config.steps_per_eval_image - 1) % max(self.datamanager.num_eval, 1)
        self.model.set_mesh(None)
        try:
            params, _ = fit_eval_latents(self.model, self.params, self.datamanager, host_loop=self.graphed is False)
            m = eval_image_metrics(self.model, params, self.datamanager, image_idx, graphed=self.graphed)
            outputs = m.pop("outputs")
            record = {f"eval_{k}": v for k, v in m.items() if v is not None}
            self.history.append({"step": self.step, **record})
            if self.writer is not None and self.is_main:
                self.writer.write_scalars(self.step, record)
                cams = self.datamanager.eval_cameras
                _, batch = self.datamanager.eval_image_bundle(image_idx)
                _, panels = image_metrics_and_panels(self.model, params, outputs, batch, cams.height, cams.width,
                                                     latent_slot=image_idx, graphed=self.graphed)
                for name, img in panels.items():
                    self.writer.write_image(self.step, name, img)
        finally:
            self.model.set_mesh(self.mesh)

    def save(self, path: Optional[str] = None):
        """Write the checkpoint (rank 0 alone on a mesh)."""
        if not self.is_main:
            return
        save_checkpoint(Path(path or self.config.output_dir), self.step, self.params, self.optimizer.state_dict())

    def load(self, path: str, step: Optional[int] = None):
        """Resume: params (copied into this trainer's tensors, which the
        optimizer holds), the Adam state and the step; the training batch
        stream moves to the step (``DataManager.reseed``).  The checkpoint
        holds no generator state: the draw stream goes on from this
        trainer's seed, as JAX's does, so a resumed run is not the run that
        did not stop, draw for draw.  A captured step warms up and captures
        again over the loaded Adam state (``GroupedAdam.generation``)."""
        self.step = resume_into(Path(path), step, self.params, self.optimizer)
        self.datamanager.reseed(self.step)
