"""Where does a ``train_sanity`` checkpoint's error live on the synthetic
scene? (mirror of ``tools/diagnose_ckpt.py``)

Prints the loaded step, then four JSON records:

- geometry: the SDF on the true sphere surface (r = 0.4) and the radius
  found by bisection along 512 probe directions;
- illumination: the HDR sky decoded from train latent 0 over 2,048
  directions, near and away from the true sun, against the scene's sun
  intensity and ambient level;
- albedo: the field's albedo just inside the surface against the true
  (0.7, 0.4, 0.3);
- losses: every loss term, the PSNR and ``s_val`` on the first training
  batch, and the squared error and accumulation over its sky and
  foreground rays.

The config is ``neusky_model_config(8, 2)`` with ``--ddf-encoding`` as
the DDF's position encoding.

Usage:
    python -m neusky_torch.tools.diagnose_ckpt <ckpt_dir> [--ddf-encoding nerf|hash] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="diagnose_ckpt")
    ap.add_argument("ckpt_dir")
    ap.add_argument("--ddf-encoding", choices=("nerf", "hash"), default="nerf")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _unit_normals(generator: torch.Generator, n: int, device) -> torch.Tensor:
    d = torch.randn((n, 3), generator=generator, device=device)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _r(x, digits: int) -> float:
    return round(float(x), digits)


@torch.no_grad()
def _geometry(model, params, sc, d: torch.Tensor):
    center = torch.tensor(sc.sphere_center, dtype=d.dtype, device=d.device)
    surf = center + sc.sphere_radius * d

    def sdf_at(pts):
        return model.field.sdf_only(params["fields"], pts).reshape(-1)

    sdf_surf = sdf_at(surf).cpu().numpy()
    lo = torch.full((d.shape[0],), 0.05, device=d.device)
    hi = torch.full((d.shape[0],), 0.9, device=d.device)
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        inside = sdf_at(center + mid[:, None] * d) < 0
        lo = torch.where(inside, mid, lo)
        hi = torch.where(inside, hi, mid)
    radius = (0.5 * (lo + hi)).cpu().numpy()
    rec = {
        "sdf_surface_rms": _r(np.sqrt((sdf_surf**2).mean()), 5),
        "sdf_surface_mean": _r(sdf_surf.mean(), 5),
        "radius_est_mean": _r(radius.mean(), 4),
        "radius_est_std": _r(radius.std(), 4),
        "radius_gt": sc.sphere_radius,
    }
    return rec, surf


@torch.no_grad()
def _illumination(model, params, sc, dirs: torch.Tensor):
    g = params["illumination_field"]
    n = dirs.shape[0]
    out = model.illumination.apply(params["illumination_decoder"], dirs, g["train_latents"][0:1].expand(n, -1, -1),
                                   g["train_scale"][0:1].expand(n))
    hdr = model.illumination.unnormalise(out["rgb"]).cpu().numpy()
    d = dirs.cpu().numpy()
    sun = np.asarray(sc.sun_direction, np.float64)
    sun /= np.linalg.norm(sun)
    cos_to_sun = d @ sun
    near, away, upper = cos_to_sun > 0.95, cos_to_sun < 0.5, d[:, 2] > 0
    return {
        "hdr_min": _r(hdr.min(), 4),
        "hdr_mean": _r(hdr.mean(), 4),
        "hdr_max": _r(hdr.max(), 4),
        "hdr_near_sun_mean": _r(hdr[near].mean(), 4) if near.any() else None,
        "hdr_away_sun_mean": _r(hdr[away].mean(), 4),
        "hdr_upper_mean": _r(hdr[upper].mean(), 4),
        "train_scale_0": _r(g["train_scale"][0], 4),
        "latent_norm_0": _r(torch.linalg.norm(g["train_latents"][0]), 4),
        "gt_sun_intensity": sc.sun_intensity,
        "gt_ambient": sc.ambient,
    }


@torch.no_grad()
def _albedo(model, params, sc, surf: torch.Tensor):
    pts = surf * (1.0 - 1e-3)
    _, geo_feat = model.field.geo(params["fields"], pts)
    alb = model.field.colour(params["fields"], pts, geo_feat)[:, :3].reshape(-1, 3).cpu().numpy()
    return {"albedo_mean": [_r(x, 4) for x in alb.mean(0)], "albedo_std": [_r(x, 4) for x in alb.std(0)],
            "albedo_gt": list(sc.albedo)}


@torch.no_grad()
def _losses(model, params, scene, step: int, forward_draws: Optional[dict], generator: torch.Generator):
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.models.pipeline import batch_ray_bundle

    dm = DataManager(
        DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=8, rays_per_image=128), num_sky_rays=256),
        scene["cameras"], scene["images"], scene["masks"], device=model.device,
    )
    batch = dm.next_train(0)
    outputs = model.forward(params, batch_ray_bundle(batch), batch["image_indices"], batch["ray_image_idx"],
                            step=float(step), train=True, draws=forward_draws, generator=generator)
    losses = model.loss_dict(params, outputs, batch)
    metrics = model.metrics_dict(params, outputs, batch)
    rec = {k: _r(v, 5) for k, v in losses.items()}
    rec["psnr"] = _r(metrics["psnr"], 3)
    rec["s_val"] = _r(metrics["s_val"], 5)
    pred = outputs["rgb"].cpu().numpy()
    img = batch["image"].cpu().numpy()
    sky = batch["mask"][..., 3].cpu().numpy() > 0.5
    err = ((pred - img) ** 2).mean(-1)
    acc = outputs["accumulation"].reshape(-1).cpu().numpy()
    rec["batch_mse_sky"] = _r(err[sky].mean(), 5)
    rec["batch_mse_fg"] = _r(err[~sky].mean(), 5)
    rec["accum_mean_fg"] = _r(acc[~sky].mean(), 4)
    rec["accum_mean_sky"] = _r(acc[sky].mean(), 4)
    return rec


def diagnose(model, params, step: int, draws: Optional[dict] = None) -> List[dict]:
    """The four records of a checkpoint's ``params``.  ``draws``: the
    surface probe directions ``surface_dirs`` [512, 3], the sky directions
    ``sky_dirs`` [2048, 3] (both unit) and the training forward's
    ``forward`` draws; any left out are drawn from seeds 0, 1 and 42."""
    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene

    draws = draws or {}
    dev = model.device
    surface_dirs = draws.get("surface_dirs")
    if surface_dirs is None:
        surface_dirs = _unit_normals(torch.Generator(device=dev).manual_seed(0), 512, dev)
    sky_dirs = draws.get("sky_dirs")
    if sky_dirs is None:
        sky_dirs = _unit_normals(torch.Generator(device=dev).manual_seed(1), 2048, dev)
    sc = SyntheticSceneConfig(num_cameras=8, width=64, height=64)
    scene = generate_synthetic_scene(sc)
    geometry, surf = _geometry(model, params, sc, surface_dirs.to(dev))
    records = [geometry, _illumination(model, params, sc, sky_dirs.to(dev)), _albedo(model, params, sc, surf),
               _losses(model, params, scene, step, draws.get("forward"), torch.Generator(device=dev).manual_seed(42))]
    for rec in records:
        print(json.dumps(rec), flush=True)
    return records


def load(args):
    """The run's config, model and checkpoint → (model, params, step)."""
    from neusky_torch.configs.neusky_config import neusky_model_config
    from neusky_torch.engine.checkpoint import load_checkpoint
    from neusky_torch.models.neusky import NeuSkyModel

    cfg = neusky_model_config(num_train_data=8, num_eval_data=2)
    if args.ddf_encoding != cfg.ddf.field.position_encoding_type:
        field = dataclasses.replace(cfg.ddf.field, position_encoding_type=args.ddf_encoding)
        cfg = dataclasses.replace(cfg, ddf=dataclasses.replace(cfg.ddf, field=field))
    model = NeuSkyModel(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    params, _, step = load_checkpoint(Path(args.ckpt_dir), None, params, None)
    print(json.dumps({"loaded_step": int(step)}), flush=True)
    return model, params, int(step)


def main(argv=None, draws: Optional[dict] = None) -> List[dict]:
    return diagnose(*load(parse_args(argv)), draws=draws)


if __name__ == "__main__":
    main()
