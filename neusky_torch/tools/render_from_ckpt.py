"""Render a view and a shadow map from a ``train_sanity`` checkpoint and
score it in image space against the synthetic scene's ground truth (mirror
of ``tools/render_from_ckpt.py``): the training batches' PSNR is Monte
Carlo noisy; this is the image metric on one fixed camera.

The render reads the eval latents, which ``train_sanity`` does not fit:
the train latents and scales are copied into the eval slots (the train
cameras are the ones rendered).  The config is ``neusky_model_config(8,
2)`` without the ``NEUSKY_*`` knobs (``--tiny``: the tiny recipe, a CPU
rehearsal), as in JAX.

Usage:
    python -m neusky_torch.tools.render_from_ckpt outputs/sanity_ckpt --cam 0 \
        --out-prefix outputs/ckpt_render [--ddf-encoding nerf|hash] [--device cpu --tiny]

Writes ``<prefix>_rgb.png``, ``_gt.png``, ``_err.png``, ``_depth.png`` and
``_shadow.png``; prints one JSON record (image PSNR, MSE over the sky and
the foreground, mean accumulation, shadow statistics).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="render_from_ckpt")
    ap.add_argument("ckpt_dir")
    ap.add_argument("--cam", type=int, default=0)
    ap.add_argument("--out-prefix", default="outputs/ckpt_render")
    ap.add_argument("--ddf-encoding", choices=("nerf", "hash"), default="nerf")
    ap.add_argument("--chunk-size", type=int, default=4096)
    ap.add_argument("--tiny", action="store_true", help="a train_sanity --tiny checkpoint (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps, fits, renders and LPIPS op by op (default: CUDA graphs on the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from pathlib import Path

    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
    from neusky_torch.engine.checkpoint import load_checkpoint
    from neusky_torch.engine.eval_loop import render_camera
    from neusky_torch.engine.render_features import render_shadow_map
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.utils.viz import apply_depth_colormap, save_png

    if args.tiny:
        from neusky_torch.configs.tiny_config import tiny_model_config

        cfg = tiny_model_config(num_train_data=8, num_eval_data=2)
    else:
        from neusky_torch.configs.neusky_config import neusky_model_config

        cfg = neusky_model_config(num_train_data=8, num_eval_data=2)
    if args.ddf_encoding != cfg.ddf.field.position_encoding_type:
        field = dataclasses.replace(cfg.ddf.field, position_encoding_type=args.ddf_encoding)
        cfg = dataclasses.replace(cfg, ddf=dataclasses.replace(cfg.ddf, field=field))
    model = NeuSkyModel(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    params, _, step = load_checkpoint(Path(args.ckpt_dir), None, params, None)
    print(json.dumps({"loaded_step": int(step)}), flush=True)

    g = params["illumination_field"]
    n_eval = params["eval_latents"]["eval_latents"].shape[0]
    params = {**params, "eval_latents": {"eval_latents": g["train_latents"][:n_eval],
                                         "eval_scale": g["train_scale"][:n_eval]}}

    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=8, width=64, height=64))
    cams = scene["cameras"].to(model.device)
    h, w = cams.height, cams.width
    rb = cams.generate_rays(args.cam)
    outs = render_camera(model, params, rb, args.cam, chunk_size=args.chunk_size, graphed=False if args.eager else None)
    pred = np.clip(outs["rgb"].reshape(h, w, 3), 0, 1)
    gt = np.asarray(scene["images"][args.cam]).reshape(h, w, 3)
    mse = float(np.mean((pred - gt) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-10))
    sky = np.asarray(scene["masks"][args.cam]).reshape(h, w, 4)[..., 3] > 0.5  # mask channel 3 = sky
    err = np.mean((pred - gt) ** 2, axis=-1)
    rec = {
        "step": int(step),
        "cam": args.cam,
        "image_psnr": round(float(psnr), 3),
        "mse": round(mse, 5),
        "mse_sky": round(float(err[sky].mean()) if sky.any() else -1, 5),
        "mse_fg": round(float(err[~sky].mean()) if (~sky).any() else -1, 5),
        "accum_mean": round(float(outs["accumulation"].mean()), 4),
    }
    save_png(f"{args.out_prefix}_rgb.png", pred)
    save_png(f"{args.out_prefix}_gt.png", gt)
    save_png(f"{args.out_prefix}_err.png", np.repeat((err / max(err.max(), 1e-6))[..., None], 3, -1))
    save_png(f"{args.out_prefix}_depth.png", apply_depth_colormap(
        outs["depth"].reshape(h, w, 1), accumulation=outs["accumulation"].reshape(h, w, 1)))
    sm = render_shadow_map(model, params, rb, azimuth_deg=45.0, elevation_deg=45.0)
    shadow = np.clip(sm["shadow_map"].reshape(h, w), 0, 1)
    save_png(f"{args.out_prefix}_shadow.png", np.stack([shadow] * 3, -1))
    rec["shadow_mean"] = round(float(shadow.mean()), 4)
    rec["shadow_std"] = round(float(shadow.std()), 4)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
