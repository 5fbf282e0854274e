"""Does joint training fit the sky through the frozen RENI++ prior? (mirror
of ``tools/prior_fit_sanity.py``)

The canonical illumination (the latent-100 decoder of the shipped prior,
loaded frozen) with geometry fields cut to CPU scale: an 8-level hash grid
of 2^15, 2 × 64 MLPs, 64 light directions, a 3 × 64 FiLM DDF on NeRF
encodings, 8 × 32 scene rays, 4 × 32 vMF rays and 64 sky rays a step on
the synthetic scene at 48 × 48.  ``--no-prior`` keeps the random decoder
(the ablation).

Prints a JSON line (and appends it to ``--out``) at step 1 and every
``log_every`` steps (PSNR, sky-pixel loss, total loss, seconds), then a
final record: camera 0 rendered with the train latents in the eval slots,
its PSNR and its squared error over the sky and the foreground.

Usage:
    python -m neusky_torch.tools.prior_fit_sanity [steps] [log_every] [--out out.jsonl] [--no-prior] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

PX = 48


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="prior_fit_sanity")
    ap.add_argument("steps", nargs="?", type=int, default=400)
    ap.add_argument("log_every", nargs="?", type=int, default=50)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-prior", action="store_true", help="ablation: keep the random frozen decoder")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps, fits, renders and LPIPS op by op (default: CUDA graphs on the card)")
    return ap.parse_args(argv)


def build_config():
    """The canonical illumination with the fields, samplers and DDF cut to
    CPU scale."""
    from neusky_torch.configs.neusky_config import neusky_model_config
    from neusky_torch.fields.ddf import DDFFieldConfig
    from neusky_torch.fields.density_field import DensityFieldConfig
    from neusky_torch.fields.sdf_albedo import SDFAlbedoFieldConfig
    from neusky_torch.ops.hashgrid import HashGridConfig
    from neusky_torch.sampling.proposal import ProposalSamplerConfig

    small_hash = HashGridConfig(num_levels=8, features_per_level=2, log2_hashmap_size=15, base_res=4, max_res=256)
    cfg = neusky_model_config(
        num_train_data=8, num_eval_data=2,
        sdf_field=SDFAlbedoFieldConfig(
            num_layers=2, hidden_dim=64, geo_feat_dim=64, num_layers_color=2, hidden_dim_color=64,
            bias=0.1, beta_init=0.1, hash=small_hash, contraction_order="l2", stochastic_table_grads=True,
        ),
        proposal=ProposalSamplerConfig(num_proposal_samples=(64, 32), num_final_samples=24),
        proposal_fields=(
            DensityFieldConfig(hidden_dim=16, num_layers=2, hash=small_hash),
            DensityFieldConfig(hidden_dim=16, num_layers=2, hash=small_hash),
        ),
        num_illumination_directions=64,
        visibility_query_chunk=4096,
    )
    return dataclasses.replace(cfg, ddf=dataclasses.replace(cfg.ddf, field=DDFFieldConfig(
        conditioning="FiLM", position_encoding_type="nerf", direction_encoding_type="nerf", hidden_layers=3,
        hidden_features=64, mapping_layers=3, mapping_features=64,
    )))


@dataclasses.dataclass
class PriorFitRun:
    args: argparse.Namespace
    cfg: Any
    model: Any
    scene: Dict[str, Any]
    dm: Any
    params: Dict[str, Any]
    step_fn: Callable
    generator: torch.Generator


def build(args) -> PriorFitRun:
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
    from neusky_torch.engine.checkpoint import load_illumination_prior
    from neusky_torch.engine.optimizers import GroupedAdam, default_neusky_optimizer_groups
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.models.pipeline import PipelineConfig
    from neusky_torch.parallel.mesh import make_train_step
    from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig

    cfg = build_config()
    model = NeuSkyModel(cfg, device=args.device)
    pipe = PipelineConfig(
        visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=4, num_rays_per_sample=32,
                                                  only_sample_upper_hemisphere=True, concentration=20.0),
        num_sky_rays=64,
    )
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=8, width=PX, height=PX))
    dm = DataManager(
        DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=8, rays_per_image=32), num_sky_rays=64),
        scene["cameras"], scene["images"], scene["masks"], device=model.device,
    )
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    if not args.no_prior:
        params = load_illumination_prior(params, cfg)
    optimizer = GroupedAdam(params, default_neusky_optimizer_groups(args.steps + 1))
    return PriorFitRun(args, cfg, model, scene, dm, params, make_train_step(model, pipe, optimizer, graphed=False if args.eager else None),
                       torch.Generator(device=model.device).manual_seed(1))


def run(r: PriorFitRun, draws_fn: Optional[Callable[[int], dict]] = None) -> List[dict]:
    """Train ``steps`` steps (``draws_fn(i)``: step i's draws, else drawn
    from ``r.generator``), then render and score camera 0 → the records."""
    from neusky_torch.engine.eval_loop import render_camera

    args, records = r.args, []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = r.dm.next_train(i)
        aux = r.step_fn(r.params, batch, float(i), draws_fn(i) if draws_fn else None, r.generator)
        if (i + 1) % args.log_every == 0 or i == 0:
            emit({
                "step": i + 1,
                "prior": not args.no_prior,
                "psnr": round(float(aux["metrics"]["psnr"]), 3),
                "sky_pixel_loss": round(float(aux["loss_dict"].get("sky_pixel_loss", float("nan"))), 5),
                "total_loss": round(float(aux["total_loss"]), 4),
                "elapsed_s": round(time.perf_counter() - t0, 1),
            })

    g = r.params["illumination_field"]
    n_eval = r.params["eval_latents"]["eval_latents"].shape[0]
    params = {**r.params, "eval_latents": {**r.params["eval_latents"], "eval_latents": g["train_latents"][:n_eval],
                                           "eval_scale": g["train_scale"][:n_eval]}}
    rb = r.scene["cameras"].to(r.model.device).generate_rays(0)
    outs = render_camera(r.model, params, rb, 0, chunk_size=PX * PX, graphed=False if args.eager else None)
    pred = np.clip(outs["rgb"].reshape(PX, PX, 3), 0, 1)
    gt = np.asarray(r.scene["images"][0]).reshape(PX, PX, 3)
    sky = np.asarray(r.scene["masks"][0]).reshape(PX, PX, 4)[..., 3] > 0.5
    err = np.mean((pred - gt) ** 2, axis=-1)
    emit({
        "final_image_psnr": round(-10.0 * float(np.log10(max(float(err.mean()), 1e-10))), 3),
        "mse_sky": round(float(err[sky].mean()) if sky.any() else -1, 5),
        "mse_fg": round(float(err[~sky].mean()) if (~sky).any() else -1, 5),
        "prior": not args.no_prior,
    })
    return records


def main(argv=None) -> List[dict]:
    return run(build(parse_args(argv)))


if __name__ == "__main__":
    main()
