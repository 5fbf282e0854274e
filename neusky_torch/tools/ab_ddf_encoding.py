"""DDF encoding A/B (mirror of ``tools/ab_ddf_encoding.py``): the DDF
trained standalone against one frozen scene, once per position encoding,
so the DDF depth quality of each encoding is compared on the same
geometry.

For each arm of ``--encodings`` the DDF (a fresh init for that encoding)
is trained by the DDF trainer (``engine/ddf_trainer.py``) against the
scene of ``--ckpt`` (every group but ``ddf_field``), on the synthetic scene
(8 cameras, 64 × 64) with 8 × 128 vMF rays at κ = 20 and 256 sky rays a
step.  ``hash`` puts the DDF's positions through a hash grid, whose table
gradient is one K1 launch per differentiated encode.

Prints JSON lines (and appends them to ``--out``): each arm's start, its
trainer's records (with the seconds since the start) and its end (final
depth PSNR, steps a second).

Usage:
    python -m neusky_torch.tools.ab_ddf_encoding --ckpt <scene checkpoint> [--steps 2000] [--log-every 50]
        [--out results.jsonl] [--encodings nerf,hash] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="ab_ddf_encoding")
    ap.add_argument("--ckpt", required=True, help="frozen NeuSky scene checkpoint (the recipe's topology)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--out", default="outputs/ab_ddf_standalone.jsonl")
    ap.add_argument("--encodings", default="nerf,hash")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def arm_trainer(args, enc: str, scene):
    """The DDF trainer of one arm: the recipe with ``enc`` as the DDF
    position encoding, the prior, the checkpoint's scene."""
    from neusky_torch.configs.neusky_config import neusky_model_config
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.engine.checkpoint import load_illumination_prior, load_param_subtrees
    from neusky_torch.engine.ddf_trainer import DDFTrainer, DDFTrainerConfig
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig

    base = neusky_model_config(num_train_data=8, num_eval_data=2)
    cfg = dataclasses.replace(base, ddf=dataclasses.replace(
        base.ddf, field=dataclasses.replace(base.ddf.field, position_encoding_type=enc)))
    model = NeuSkyModel(cfg, device=args.device)
    params = load_illumination_prior(model.init(torch.Generator(device=model.device).manual_seed(0)), cfg)
    # the scene from the checkpoint; ddf_field stays this encoding's fresh init
    params = load_param_subtrees(Path(args.ckpt), None, params, exclude=("ddf_field",))
    dm = DataManager(
        DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=8, rays_per_image=128), num_sky_rays=256),
        scene["cameras"], scene["images"], scene["masks"], device=model.device,
    )
    tcfg = DDFTrainerConfig(
        max_num_iterations=args.steps, steps_per_log=args.log_every,
        sampler=DDFSamplerConfig(num_samples_on_sphere=8, num_rays_per_sample=128,
                                 only_sample_upper_hemisphere=True, concentration=20.0),
        num_sky_rays=256,
    )
    return DDFTrainer(tcfg, model, params, datamanager=dm)


def main(argv=None, draws: Optional[Dict[str, Sequence[dict]]] = None,
         on_trainer: Optional[Callable[[str, Any], None]] = None) -> List[dict]:
    """``draws``: per arm, one dict of draws per step (the DDF trainer's
    form), else drawn; ``on_trainer(arm, trainer)`` is called on each arm's
    trainer before it runs."""
    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
    from neusky_torch.device import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)  # refuse before writing anything
    records: List[dict] = []
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        def emit(rec):
            records.append(rec)
            line = json.dumps(rec)
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

        scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=8, width=64, height=64))
        for enc in args.encodings.split(","):
            trainer = arm_trainer(args, enc, scene)
            if on_trainer is not None:
                on_trainer(enc, trainer)
            t0 = time.time()
            emit({"arm": enc, "event": "start"})
            trainer.run(
                num_steps=args.steps,
                log_fn=lambda rec: emit({"arm": enc, "elapsed_s": round(time.time() - t0, 1),
                                         **{k: round(v, 5) if isinstance(v, float) else v for k, v in rec.items()}}),
                draws=None if draws is None else draws[enc],
            )
            emit({"arm": enc, "event": "done", "final_depth_psnr": trainer.history[-1]["depth_psnr"],
                  "steps_per_sec": round(args.steps / (time.time() - t0), 3)})
    return records


if __name__ == "__main__":
    main()
