"""Publication renders from a trained run (mirror of
``tools/render_animation.py``): frames along a nerfstudio camera path,
the illumination-rotation animation (the sky rotated about z) and the
per-image envmap figures.

The camera-path JSON is nerfstudio's: ``camera_path`` entries with a
row-major 4×4 ``camera_to_world`` and a vertical ``fov`` in degrees, and
optional ``render_height`` / ``render_width``.  The run is read as ``cli
eval`` reads it (``--method``, ``--load-dir``, the data flags).

Usage:
    python -m neusky_torch.tools.render_animation camera-path path.json --load-dir outputs/run \
        --method neusky-tiny --out outputs/anim
    python -m neusky_torch.tools.render_animation illumination-rotation --load-dir outputs/run --frames 60 \
        --out outputs/anim
    python -m neusky_torch.tools.render_animation envmaps --load-dir outputs/run --out figs

Frames are PNGs plus a compressed ``.npz`` sequence; encode video with
ffmpeg.  Add ``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _load(args):
    from neusky_torch.engine.eval_loop import _load_run

    return _load_run(args, [])


def cmd_camera_path(args) -> dict:
    from neusky_torch.core.cameras import Cameras, CameraType
    from neusky_torch.engine.eval_loop import render_camera
    from neusky_torch.utils.viz import save_png

    model, params, _ = _load(args)
    with open(args.path_json) as f:
        spec = json.load(f)
    res_h = args.height or max(32, int(spec.get("render_height", 128)) // args.downscale)
    res_w = args.width or max(32, int(spec.get("render_width", 128)) // args.downscale)
    os.makedirs(args.out, exist_ok=True)
    seq = []
    for i, frame in enumerate(spec["camera_path"][args.start::args.stride]):
        c2w = np.asarray(frame["camera_to_world"], np.float32).reshape(4, 4)[:3]
        fy = 0.5 * res_h / np.tan(0.5 * np.deg2rad(float(frame.get("fov", 50.0))))
        cam = Cameras(
            camera_to_worlds=torch.from_numpy(c2w)[None], fx=torch.tensor([fy], dtype=torch.float32),
            fy=torch.tensor([fy], dtype=torch.float32), cx=torch.tensor([res_w / 2.0]), cy=torch.tensor([res_h / 2.0]),
            width=res_w, height=res_h, camera_type=int(CameraType.PERSPECTIVE),
        ).to(model.device)
        outs = render_camera(model, params, cam.generate_rays(0), args.illumination_idx, chunk_size=args.chunk_size,
                             graphed=False if args.eager else None)
        rgb = np.clip(outs["rgb"].reshape(res_h, res_w, 3), 0, 1)
        save_png(os.path.join(args.out, f"frame_{i:04d}.png"), rgb)
        seq.append(rgb)
        print(f"frame {i}: rendered {res_w}x{res_h}", flush=True)
    np.savez_compressed(os.path.join(args.out, "sequence.npz"), rgb=np.stack(seq))
    result = {"frames": len(seq), "out": args.out}
    print(json.dumps(result))
    return result


def cmd_illumination_rotation(args) -> dict:
    from neusky_torch.engine.render_features import AnimationConfig, render_illumination_animation
    from neusky_torch.utils.viz import save_png

    model, params, dm = _load(args)
    rb, _ = dm.eval_image_bundle(0)
    cams = dm.eval_cameras if dm.eval_cameras is not None else dm.train_cameras
    h, w = cams.height, cams.width
    seq = render_illumination_animation(
        model, params, rb, args.illumination_idx,
        AnimationConfig(num_frames=args.frames, output_dir=args.out, chunk_size=args.chunk_size,
                        graphed=False if args.eager else None),
    )
    for i, frame in enumerate(seq):
        save_png(os.path.join(args.out, f"frame_{i:04d}.png"), np.clip(frame.reshape(h, w, 3), 0, 1))
    result = {"frames": len(seq), "out": args.out}
    print(json.dumps(result))
    return result


def cmd_envmaps(args) -> dict:
    """Per-image HDR envmaps of the train latents: an LDR sRGB PNG and the
    HDR ``.npy`` each (the reference's ``get_envmap`` figures)."""
    from neusky_torch.core.colour import linear_to_sRGB
    from neusky_torch.models.neusky import freeze_decoder_params
    from neusky_torch.sampling.illumination import EquirectangularSampler
    from neusky_torch.utils.viz import save_png

    model, params, _ = _load(args)
    sampler = EquirectangularSampler(width=args.envmap_width)
    os.makedirs(args.out, exist_ok=True)
    g = params["illumination_field"]
    latents, scales = g["train_latents"], g["train_scale"]
    decoder = freeze_decoder_params(params["illumination_decoder"])
    with torch.inference_mode():
        dirs = sampler(model.device)
        for i in range(latents.shape[0]):
            out = model.illumination.apply(decoder, dirs, latents[i], scales[i:i + 1])
            hdr = model.illumination.unnormalise(out["rgb"]).reshape(sampler.height, sampler.width, 3)
            np.save(os.path.join(args.out, f"envmap_{i:03d}_hdr.npy"), hdr.cpu().numpy())
            save_png(os.path.join(args.out, f"envmap_{i:03d}.png"),
                     linear_to_sRGB(torch.clamp(hdr, 0, 1)).cpu().numpy())
    result = {"envmaps": int(latents.shape[0]), "out": args.out}
    print(json.dumps(result))
    return result


COMMANDS = {"camera-path": cmd_camera_path, "illumination-rotation": cmd_illumination_rotation,
            "envmaps": cmd_envmaps}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="render_animation", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--method", default="neusky-tiny")
        p.add_argument("--load-dir", default=None)
        p.add_argument("--out", default="outputs/animation")
        p.add_argument("--chunk-size", type=int, default=4096)
        p.add_argument("--illumination-idx", type=int, default=0)
        p.add_argument("--data", default=None)
        p.add_argument("--scene", default="site1")
        p.add_argument("--downscale", type=int, default=4)
        p.add_argument("--rays-per-batch", type=int, default=1024)
        p.add_argument("--synthetic-demo", action="store_true", default=True)
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        p.add_argument("--eager", action="store_true",
                       help="run the steps, fits, renders and LPIPS op by op (default: CUDA graphs on the card)")

    p = sub.add_parser("camera-path", help="render along a nerfstudio camera-path JSON")
    p.add_argument("path_json")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    common(p)
    p = sub.add_parser("illumination-rotation", help="rotate the sky about z")
    p.add_argument("--frames", type=int, default=60)
    common(p)
    p = sub.add_parser("envmaps", help="export per-image envmap figures")
    p.add_argument("--envmap-width", type=int, default=128)
    common(p)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    main()
