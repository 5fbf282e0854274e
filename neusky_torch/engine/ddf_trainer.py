"""The DDF trained alone against a frozen NeuSky scene (mirror of
``neusky_tpu/engine/ddf_trainer.py``).

Each step renders a fresh batch of vMF sphere rays against the frozen SDF
as ground truth, adds sky rays from the datamanager, and fits the DDF to
them (depth, SDF level set at the predicted termination points,
multi-view and sky-ray losses).  Only ``ddf_field`` is optimised (one Adam
group, cosine schedule).  The scene is frozen for real: its leaves are
detached and the ground-truth pass and the SDF query run under
``torch.no_grad``, so autograd records no hash-grid encode and no
table-gradient scatter runs.

A step's draws are ``vmf`` (:func:`~neusky_torch.sampling.ddf_sampler.draw_vmf`)
and ``multi_view_u`` (the multi-view loss's sphere points), and, with a
datamanager, the sky rays' camera rows and pixel coordinates from its
numpy sampler, as in JAX (``sky_rows``, ``sky_coords``; the rays are
generated on the device inside the step).  :meth:`DDFTrainer.draw_step`
makes them all before each step, so the step draws nothing: on the card it
runs as one CUDA graph replay a step (``neusky_torch/parallel/graphs.py``),
JAX's jitted step (``neusky_tpu/engine/ddf_trainer.py:137``), the cosine
schedule reading Adam's count on the device; ``graphed=False`` runs it
eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from neusky_torch.core.cameras import Cameras
from neusky_torch.core.spherical import draw_sphere_uniforms, look_at_target
from neusky_torch.data.datamanager import DataManager
from neusky_torch.engine.optimizers import GroupedAdam, OptimizerGroupConfig
from neusky_torch.models.ddf_model import ddf_loss_dict, ddf_train_outputs
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.parallel.graphs import CapturedStep, use_graph
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig, draw_vmf, vmf_ddf_samples
from neusky_torch.sampling.illumination import IcosahedronSampler
from neusky_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class DDFTrainerConfig:
    max_num_iterations: int = 20001
    steps_per_log: int = 100
    sampler: DDFSamplerConfig = DDFSamplerConfig(
        num_samples_on_sphere=8, num_rays_per_sample=128,
        only_sample_upper_hemisphere=True, concentration=20.0,
    )
    num_sky_rays: int = 256
    accumulation_mask_threshold: float = 0.0
    lr: float = 1e-4
    seed: int = 0


class DDFTrainer:
    """Optimises a copy of ``frozen_params["ddf_field"]`` (``self.ddf_params``)
    against the frozen rest of ``frozen_params``, on the model's device;
    ``frozen_params`` itself is not modified.  ``graphed``: None captures
    the step as a CUDA graph on the card, False runs it eagerly, True
    raises on the CPU."""

    def __init__(self, config: DDFTrainerConfig, model: NeuSkyModel, frozen_params: Dict,
                 datamanager: Optional[DataManager] = None, graphed: Optional[bool] = None):
        if model.ddf is None:
            raise ValueError("the model config has no DDF")
        self.config = config
        self.model = model
        self.datamanager = datamanager
        self.frozen_scene = tree_map(lambda t: t.detach(), {k: v for k, v in frozen_params.items() if k != "ddf_field"})
        self.ddf_params = tree_map(lambda t: t.detach().clone(), frozen_params["ddf_field"])
        self.optimizer = GroupedAdam(
            {"ddf_field": self.ddf_params},
            {"ddf_field": OptimizerGroupConfig(lr=config.lr, schedule="cosine", max_steps=config.max_num_iterations)},
        )
        self.generator = torch.Generator(device=model.device).manual_seed(config.seed)
        self.step = 0
        self.history: List[dict] = []
        self.train_step = self._train_step
        if use_graph(graphed, model.device):
            self.train_step = CapturedStep(self._train_step, self.optimizer)

    def draw(self) -> dict:
        s = self.config.sampler
        return {"vmf": draw_vmf(s, self.generator, self.model.device),
                "multi_view_u": draw_sphere_uniforms(s.num_samples_on_sphere * s.num_rays_per_sample,
                                                     self.generator, self.model.device)}

    def draw_step(self, draws: Optional[dict] = None) -> dict:
        """Every draw of one step, in the order the eager loop made them:
        ``draws`` (:meth:`draw`'s keys, else drawn), then the sky rays'
        camera rows and pixel coordinates from the datamanager's sampler as
        device tensors ``sky_rows`` and ``sky_coords`` (none without a
        datamanager, or where the sampler gives none)."""
        d = dict(draws) if draws is not None else self.draw()
        if self.datamanager is not None and "sky_rows" not in d:
            sky = self.datamanager.train_sampler.sample_sky_rays(self.config.num_sky_rays)
            if sky is not None:
                dev = self.model.device
                d["sky_rows"], d["sky_coords"] = (torch.from_numpy(a).to(dev) for a in sky)
        return d

    def sky_rays(self, draws: dict):
        """The sky ray bundle of a step's draws (:meth:`draw_step`), or
        None."""
        if "sky_rows" not in draws:
            return None
        return self.datamanager.train_cameras.generate_rays_at(draws["sky_rows"], draws["sky_coords"])

    def loss(self, draws: dict, sky_ray_bundle=None):
        """(total, {"losses", "depth_psnr"}) of one step."""
        model, cfg = self.model, self.config
        r = model.config.ddf_radius
        bundle = vmf_ddf_samples(cfg.sampler, draws["vmf"], ddf_sphere_radius=r)
        with torch.no_grad():
            batch = dict(model.generate_ddf_ground_truth(
                {**self.frozen_scene, "ddf_field": self.ddf_params}, bundle,
                mask_threshold=cfg.accumulation_mask_threshold, stop_gradients=True))
        if sky_ray_bundle is not None:
            batch["sky_ray_bundle"] = sky_ray_bundle
        fields = self.frozen_scene["fields"]
        outputs = ddf_train_outputs(
            model.ddf, self.ddf_params, bundle, batch,
            sdf_at_pos_fn=lambda p: model.field.sdf_only(fields, p),  # ddf_train_outputs runs it under no_grad
            stop_sdf_gradients=True, multi_view_u=draws["multi_view_u"],
        )
        losses = ddf_loss_dict(model.config.ddf, outputs, batch, r)
        total = torch.zeros((), device=model.device)
        for v in losses.values():
            total = total + v
        m = batch["mask"].reshape(-1, 1)
        mse = torch.mean((outputs["expected_termination_dist"].reshape(-1, 1) * m
                          - batch["termination_dist"].reshape(-1, 1) * m) ** 2)
        psnr = -10.0 * torch.log10(torch.clamp(mse / r**2, min=1e-10))
        return total, {"losses": losses, "depth_psnr": psnr}

    def _train_step(self, ddf_params, _, draws: dict) -> dict:
        """One update of ``ddf_params`` (``self.ddf_params``) from a step's
        draws (:meth:`draw_step`) → the step's detached ``total_loss``,
        ``depth_psnr`` and ``losses``; reads nothing on the host."""
        self.optimizer.zero_grad()
        total, aux = self.loss(draws, self.sky_rays(draws))
        total.backward()
        self.optimizer.step()
        return {"total_loss": total.detach(), "depth_psnr": aux["depth_psnr"].detach(),
                "losses": {k: v.detach() for k, v in aux["losses"].items()}}

    def run(self, num_steps: Optional[int] = None, log_fn=None, draws: Optional[Sequence[dict]] = None):
        """Train ``num_steps`` (default ``max_num_iterations``) steps; a
        record (``step``, ``total_loss``, ``depth_psnr`` and each loss) every
        ``steps_per_log`` steps and at the last, the only host reads.
        ``draws``: one dict per step of this run (as :meth:`draw` makes),
        else drawn."""
        start = self.step
        target = self.step + (num_steps or self.config.max_num_iterations)
        while self.step < target:
            d = self.draw_step(draws[self.step - start] if draws is not None else None)
            out = self.train_step(self.ddf_params, None, d)
            self.step += 1
            if self.step % self.config.steps_per_log == 0 or self.step == target:
                rec = {"step": self.step, "total_loss": float(out["total_loss"]),
                       "depth_psnr": float(out["depth_psnr"]), **{k: float(v) for k, v in out["losses"].items()}}
                self.history.append(rec)
                if log_fn:
                    log_fn(rec)
        return self.history

    @torch.no_grad()
    def render_eval_depth_images(self, num_views: int = 8, width: int = 64, height: int = 64) -> np.ndarray:
        """DDF depth images [V, H, W] from ``num_views`` icosphere points on
        the DDF sphere, each looking at the origin."""
        r = self.model.config.ddf_radius
        dev = self.model.device
        positions = IcosahedronSampler(num_directions=42, apply_random_rotation=False).directions_np[:num_views] * r
        images = []
        for p in positions:
            c2w = look_at_target(p[None].astype(np.float32), np.zeros((1, 3), np.float32))[..., :3, :]
            f = torch.tensor([width / 1.2], device=dev)
            cam = Cameras(camera_to_worlds=torch.from_numpy(c2w).to(dev), fx=f, fy=f,
                          cx=torch.tensor([width / 2.0], device=dev), cy=torch.tensor([height / 2.0], device=dev),
                          width=width, height=height)
            rb = cam.generate_rays(0)
            out = self.model.ddf.apply(self.ddf_params, rb.origins, rb.directions)
            images.append(out["expected_termination_dist"].cpu().numpy().reshape(height, width))
        return np.stack(images)
