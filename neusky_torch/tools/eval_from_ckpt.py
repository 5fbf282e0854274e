"""The full eval protocol on a checkpoint of the canonical synthetic scene
(mirror of ``tools/eval_from_ckpt.py``), as ``train_sanity`` writes one:

  1. the train-time model config (the same ``NEUSKY_*`` knobs);
  2. a novel-view eval split: a camera ring at azimuth offset π/8 and
     height 0.5 around the same sphere and sky;
  3. the checkpoint restored (eval latents of another count are refit);
  4. the eval latents fitted over every eval image (from the prior's mean-sky
     latent) and every eval image rendered;
  5. per image and mean PSNR / SSIM / LPIPS / MSE and rays/s, the GT-layer
     metrics (albedo PSNR after a per-channel least-squares scale, normal
     MAE, scale-and-shift depth MSE), a metrics JSON and optional panel
     PNGs.

Usage:
    python -m neusky_torch.tools.eval_from_ckpt --ckpt-dir outputs/sanity_ckpt \
        --out results/eval.json [--panels results/panels] [--fit-steps 250] [--device cpu --tiny]

``--tiny`` evaluates a ``cli train neusky-tiny --synthetic-demo``
checkpoint (6 train images): a CPU rehearsal.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="eval_from_ckpt")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", default="results/eval_from_ckpt.json")
    ap.add_argument("--panels", default=None, help="directory for panel PNGs")
    ap.add_argument("--fit-steps", type=int, default=250)
    ap.add_argument("--num-eval-cameras", type=int, default=2)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--chunk-size", type=int, default=4096)
    ap.add_argument("--tiny", action="store_true", help="evaluate a neusky-tiny checkpoint (a CPU rehearsal)")
    ap.add_argument("--no-fit", action="store_true", help="skip the latent fit (render with the checkpoint's latents)")
    ap.add_argument("--prior-dir", default=None,
                    help="the illumination_prior_dir the checkpoint was trained with: the fit starts from its "
                    "init_latent")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps, fits, renders and LPIPS op by op (default: CUDA graphs on the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from neusky_torch.configs.env_overrides import apply_env_knobs, effective_summary, knob_summary
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
    from neusky_torch.engine import metrics as M
    from neusky_torch.engine.checkpoint import latest_step, load_param_subtrees
    from neusky_torch.engine.eval_loop import fit_eval_latents, make_render_chunk_fn, render_camera
    from neusky_torch.engine.eval_panels import image_metrics_and_panels
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.tools.train_sanity import EVAL_RING
    from neusky_torch.utils.viz import save_png

    # the config train_sanity (or cli train neusky-tiny) trained, so the
    # checkpoint restores exactly
    n_train = 6 if args.tiny else 8
    if args.tiny:
        from neusky_torch.configs.tiny_config import tiny_model_config

        cfg = apply_env_knobs(tiny_model_config(n_train, args.num_eval_cameras))
    else:
        from neusky_torch.configs.neusky_config import neusky_model_config

        cfg = apply_env_knobs(neusky_model_config(num_train_data=n_train, num_eval_data=args.num_eval_cameras))
    if args.prior_dir:
        cfg = dataclasses.replace(cfg, illumination_prior_dir=args.prior_dir)
    model = NeuSkyModel(cfg, device=args.device)

    train_scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=n_train, width=64, height=64))
    eval_scene = generate_synthetic_scene(SyntheticSceneConfig(
        num_cameras=args.num_eval_cameras, width=args.width, height=args.width, **EVAL_RING))
    dm = DataManager(
        DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=n_train, rays_per_image=128),
                          num_sky_rays=256),
        train_scene["cameras"], train_scene["images"], train_scene["masks"],
        eval_cameras=eval_scene["cameras"], eval_images=eval_scene["images"], eval_masks=eval_scene["masks"],
        device=model.device,
    )
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    params = load_param_subtrees(Path(args.ckpt_dir), None, params)
    print(f"restored checkpoint from {args.ckpt_dir}", file=sys.stderr)

    fit_first = fit_last = None
    if not args.no_fit:
        t0 = time.perf_counter()
        params, losses = fit_eval_latents(model, params, dm, steps=args.fit_steps, sample_region="full_image",
                                          host_loop=args.eager)
        fit_first, fit_last = float(losses[0]), float(losses[-1])
        print(json.dumps({"eval_latent_fit": {"steps": args.fit_steps, "loss_first": fit_first,
                                              "loss_last": fit_last, "seconds": round(time.perf_counter() - t0, 1)}}),
              flush=True)

    chunk_fn, chunk_size = make_render_chunk_fn(model, args.chunk_size, graphed=False if args.eager else None)
    h = w = args.width
    albedo_gt = np.broadcast_to(np.asarray(SyntheticSceneConfig().albedo, np.float32), (h, w, 3))
    panels_dir = Path(args.panels) if args.panels else None
    if panels_dir:
        panels_dir.mkdir(parents=True, exist_ok=True)
    per_image = []
    for i in range(args.num_eval_cameras):
        rb, batch = dm.eval_image_bundle(i)
        t0 = time.perf_counter()
        outputs = render_camera(model, params, rb, i, chunk_fn, chunk_size)
        dt = time.perf_counter() - t0
        metrics, images = image_metrics_and_panels(
            model, params, outputs, batch, h, w, latent_slot=i, graphed=False if args.eager else None,
            gt_layers={"albedo": albedo_gt, "normal": eval_scene["normals"][i], "depth": eval_scene["depths"][i]},
        )
        metrics["num_rays_per_sec"] = h * w / dt
        per_image.append({"image_idx": i, **metrics})
        print(json.dumps({"image": i, **{k: round(float(v), 4) for k, v in metrics.items()}}), flush=True)
        if panels_dir:
            for name, img in images.items():
                arr = np.asarray(img, np.float32)
                if arr.ndim == 2:
                    arr = np.stack([arr] * 3, -1)
                save_png(str(panels_dir / f"eval{i}_{name}.png"), np.clip(arr, 0, 1))

    keys = [k for k in per_image[0] if k != "image_idx" and per_image[0][k] is not None]
    mean = {k: float(np.mean([p[k] for p in per_image])) for k in keys}
    if len(per_image) > 1:
        # image 0 pays the first-call costs
        mean["num_rays_per_sec"] = float(np.mean([p["num_rays_per_sec"] for p in per_image[1:]]))
    result = {
        "ckpt_dir": args.ckpt_dir,
        "ckpt_step": latest_step(Path(args.ckpt_dir)),
        "fit_steps": 0 if args.no_fit else args.fit_steps,
        "fit_loss_first": fit_first,
        "fit_loss_last": fit_last,
        "per_image": per_image,
        "mean": mean,
        "lpips_flavour": M.lpips_flavour(),
        "eval_split": {"num_cameras": args.num_eval_cameras, "angle_offset_rad": EVAL_RING["angle_offset"],
                       "camera_height": EVAL_RING["camera_height"], "width": args.width},
        "env_knobs": knob_summary(),
        "effective": effective_summary(cfg),
        "prior_dir": cfg.illumination_prior_dir,
        "device": str(model.device),
    }
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=2))
    print(json.dumps({"mean": {k: round(v, 4) for k, v in mean.items()}}))
    print(f"wrote {out_path}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
