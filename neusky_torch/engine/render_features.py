"""Render-time features (mirror of ``neusky_tpu/engine/render_features.py``):
the shadow map of one sun direction through the DDF, the sky-visibility
probe of one scene point, and the illumination-rotation animation (the sky
rotated about z frame by frame, frames cached to ``frame_{i}.npy``, the
sequence written to ``render_sequence.npz``; video encoding is left to
ffmpeg).

Everything here runs the eval forward: no draws, no hash-table gradient, so
K1 never launches.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from neusky_torch.core.rays import RayBundle, render_depth, weights_and_transmittance_from_alphas
from neusky_torch.core.spherical import ray_sphere_intersection, rot_z
from neusky_torch.engine.eval_loop import eval_grad_mode, make_render_chunk_fn, render_camera
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.sampling.illumination import EquirectangularSampler
from neusky_torch.sampling.proposal import proposal_sample


def render_shadow_map(
    model: NeuSkyModel,
    params,
    ray_bundle: RayBundle,
    azimuth_deg: float,
    elevation_deg: float,
    threshold: float = 0.5,
    sigmoid_scale: float = 50.0,
    accumulation_mask_threshold: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Visibility of each pixel's surface point toward one sun direction
    (azimuth and elevation in degrees, z up) through the DDF, masked to
    pixels whose accumulation exceeds ``accumulation_mask_threshold`` →
    host ``shadow_map`` [N], ``difference`` [N], ``accumulation`` [N]."""
    dev = ray_bundle.origins.device
    az, el = math.radians(azimuth_deg), math.radians(elevation_deg)
    sun = torch.tensor([[math.cos(az) * math.cos(el), math.sin(az) * math.cos(el), math.sin(el)]],
                       dtype=torch.float32, device=dev)
    with eval_grad_mode(model):
        rb = model.apply_collider(ray_bundle)
        rs, _, _ = proposal_sample(rb, model.density_fns(params), model.config.proposal, train=False)
        field_out = model.field.field_outputs(params["fields"], rs, True, model.config.cos_anneal_ratio)
        weights, _ = weights_and_transmittance_from_alphas(field_out["alpha"])
        p2p = render_depth(weights, rs)
        accum = torch.sum(weights, dim=-2)
        vis = model.compute_visibility(
            params, rs, p2p, sun, torch.tensor(threshold, device=dev), torch.tensor(sigmoid_scale, device=dev),
            stop_sdf_gradients=True, compute_sdf_at_termination=False,
        )
        mask = (accum[:, 0] > accumulation_mask_threshold).to(weights.dtype)
        return {
            "shadow_map": (vis["visibility"][:, 0, 0] * mask).detach().cpu().numpy(),
            "difference": (vis["difference"][:, 0] * mask).detach().cpu().numpy(),
            "accumulation": accum[:, 0].detach().cpu().numpy(),
        }


def render_shadow_probe(
    model: NeuSkyModel,
    params,
    position,
    side_length: int = 64,
    threshold: float = 0.5,
    sigmoid_scale: float = 50.0,
) -> np.ndarray:
    """Sky visibility of every direction of a ``side_length``-wide
    equirectangular grid (z up) from one scene point [3]: the DDF queried
    from where the ray from the point leaves the DDF sphere, looking back
    → host [side_length / 2, side_length]."""
    dev = model.device
    sampler = EquirectangularSampler(width=side_length)
    r = model.config.ddf_radius
    with torch.inference_mode():
        dirs = sampler(dev)
        pos = torch.as_tensor(np.asarray(position, np.float32), device=dev).reshape(1, 3).expand(dirs.shape[0], 3)
        sphere_pts = ray_sphere_intersection(pos, dirs, r)
        dist = torch.linalg.norm(sphere_pts - pos, dim=-1)
        out = model.ddf.apply(params["ddf_field"], sphere_pts, -dirs)
        difference = torch.clamp(dist, max=2.0 * r) - out["expected_termination_dist"]
        vis = 1.0 - torch.sigmoid(sigmoid_scale * (difference - threshold))
        return vis.cpu().numpy().reshape(sampler.height, sampler.width)


@dataclasses.dataclass
class AnimationConfig:
    num_frames: int = 60
    output_dir: str = "outputs/animation"
    chunk_size: int = 4096
    start_frame: int = 0
    end_frame: Optional[int] = None
    graphed: Optional[bool] = None
    """As ``make_render_chunk_fn``'s: the rotating chunk captured on the card
    (JAX's jitted rotating chunk, ``neusky_tpu/engine/render_features.py:168``)."""


def render_illumination_animation(
    model: NeuSkyModel,
    params,
    camera_ray_bundle: RayBundle,
    image_idx: int,
    config: AnimationConfig,
) -> np.ndarray:
    """Frames ``start_frame`` … ``end_frame`` (default ``num_frames``) of the
    sky of eval slot ``image_idx`` rotated about z by 360°/``num_frames`` a
    frame, each rendered over ``camera_ray_bundle`` → rgb [F, N, 3].  A
    frame already cached as ``<output_dir>/render_frames/frame_{i}.npy`` is
    read back, not rendered; the sequence goes to
    ``<output_dir>/render_sequence.npz`` (key ``rgb``)."""
    out_dir = Path(config.output_dir) / "render_frames"
    out_dir.mkdir(parents=True, exist_ok=True)
    end = config.end_frame or config.num_frames
    chunk_fn, chunk_size = make_render_chunk_fn(model, config.chunk_size, config.graphed)
    frames = []
    for i in range(config.start_frame, end):
        frame_path = out_dir / f"frame_{i}.npy"
        if frame_path.exists():
            frames.append(np.load(frame_path))
            continue
        rotation = rot_z(math.radians(i * (360.0 / config.num_frames))).to(model.device)
        rgb = render_camera(model, params, camera_ray_bundle, image_idx, chunk_fn, chunk_size, rotation=rotation)["rgb"]
        np.save(frame_path, rgb)
        frames.append(rgb)
    seq = np.stack(frames)
    np.savez_compressed(Path(config.output_dir) / "render_sequence.npz", rgb=seq)
    return seq
