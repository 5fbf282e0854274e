"""Training-dynamics run of the canonical NeuSky recipe on the synthetic
sphere scene (mirror of ``tools/train_sanity.py``): the joint step of
``apply_env_knobs(neusky_model_config(8, 2))`` (``--tiny``: the tiny
recipe on a 16 px scene) on 8 cameras × 128 rays, 8 × 128 vMF DDF rays at
κ = 20 and 256 sky rays a step, with the converted prior and the five Adam
groups.  Train PSNR must climb and the DDF depth PSNR follow the scene.

Prints JSON lines (and appends them to ``--out``): the provenance (the
``NEUSKY_*`` knobs and the effective config), a record every
``log_every`` steps and at the first (PSNR, foreground PSNR, DDF depth PSNR,
the total and four diagnostic losses, ``s_val``, seconds), with
``--eval-images`` the held-out eval record at each segment boundary and at
the end (the eval latents fitted over every eval image of the ring at
angle offset π/8, height 0.5, then each image rendered and scored), the
checkpoint and, with ``--shadow-out``, a sun shadow map of camera 0.

Usage:
    python -m neusky_torch.tools.train_sanity [steps] [log_every] [--out results.jsonl]
        [--ckpt-dir DIR [--ckpt-every N] [--resume] [--segment-steps N]]
        [--eval-images N --eval-fit-steps N] [--shadow-out shadow.png] [--gt-illumination]
        [--ddf-encoding nerf|hash] [--prior-dir DIR] [--heartbeat FILE] [--tiny] [--device cuda|cpu]

Exit codes: 0 when the run ends; 3 when a ``--segment-steps`` segment
ends (after its checkpoint) with steps left — rerun with ``--resume``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

EVAL_RING = dict(angle_offset=float(np.pi / 8.0), camera_height=0.5)
RECORD_LOSSES = ("sky_pixel_loss", "rgb_l1_loss", "fg_mask_loss", "eikonal_loss")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="train_sanity")
    ap.add_argument("steps", nargs="?", type=int, default=1500)
    ap.add_argument("log_every", nargs="?", type=int, default=100)
    # None keeps the config's (and NEUSKY_DDF_ENCODING's) value
    ap.add_argument("--ddf-encoding", choices=("nerf", "hash"), default=None)
    ap.add_argument("--out", default=None, help="also append the JSON records here")
    ap.add_argument("--shadow-out", default=None, help="render a sun shadow map of camera 0 at the end → PNG")
    ap.add_argument("--ckpt-dir", default=None, help="save a final checkpoint here")
    ap.add_argument("--ckpt-every", type=int, default=0, help="also checkpoint every N steps")
    ap.add_argument("--resume", action="store_true", help="resume from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--heartbeat", default=None, help="touch this file at every logged step and eval phase")
    ap.add_argument("--prior-dir", default=None,
                    help="illumination_prior_dir override; a prior with no init_latent trains from zero latents")
    ap.add_argument("--gt-illumination", action="store_true",
                    help="ceiling probe: a learnable per-direction light table and the analytic sky in place of "
                    "the RENI fit (NeuSkyModelConfig.gt_illumination_probe)")
    ap.add_argument("--eval-images", type=int, default=0,
                    help="held-out eval cameras rendered and scored at every segment boundary and at the end, "
                    "after a latent fit across all of them")
    ap.add_argument("--eval-fit-steps", type=int, default=150, help="Adam steps of each boundary's latent fit")
    ap.add_argument("--tiny", action="store_true", help="the tiny recipe on a 16 px scene (a CPU rehearsal)")
    ap.add_argument("--segment-steps", type=int, default=0,
                    help="exit with code 3 (after a checkpoint) once this many steps ran in this invocation")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_config(args):
    """The model config of the run: the recipe with the ``NEUSKY_*`` knobs
    applied, then the flags' overrides."""
    from neusky_torch.configs.env_overrides import apply_env_knobs

    if args.tiny:
        from neusky_torch.configs.tiny_config import tiny_model_config

        cfg = apply_env_knobs(tiny_model_config(num_train_data=8, num_eval_data=2))
    else:
        from neusky_torch.configs.neusky_config import neusky_model_config

        cfg = apply_env_knobs(neusky_model_config(num_train_data=8, num_eval_data=2))
    if args.ddf_encoding is not None and args.ddf_encoding != cfg.ddf.field.position_encoding_type:
        field = dataclasses.replace(cfg.ddf.field, position_encoding_type=args.ddf_encoding)
        cfg = dataclasses.replace(cfg, ddf=dataclasses.replace(cfg.ddf, field=field))
    if args.gt_illumination:
        cfg = dataclasses.replace(cfg, gt_illumination_probe=True)
    if args.prior_dir:
        cfg = dataclasses.replace(cfg, illumination_prior_dir=args.prior_dir)
    if args.eval_images:
        # the eval latents are sized here: keep --eval-images across the
        # segments of one run (the checkpoint carries them)
        cfg = dataclasses.replace(cfg, num_eval_data=args.eval_images)
    return cfg


@dataclasses.dataclass
class SanityRun:
    """What a run holds: its config, model, data and the training state
    (``params`` are updated in place by ``step_fn``)."""

    args: argparse.Namespace
    cfg: Any
    model: Any
    pipeline: Any
    dm: Any
    params: Dict[str, Any]
    optimizer: Any
    step_fn: Callable
    generator: torch.Generator
    start: int = 0
    eval_state: Dict[str, Any] = dataclasses.field(default_factory=dict)


def scene_px(args) -> int:
    return 16 if args.tiny else 64


def emit(args, rec: Dict[str, Any]) -> None:
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _beat(args, text: str) -> None:
    if args.heartbeat:
        Path(args.heartbeat).write_text(text)


def build_run(args) -> SanityRun:
    """Print the provenance, build the model, data and optimizer, load the
    prior and, with ``--resume``, the latest checkpoint."""
    from neusky_torch.configs.env_overrides import effective_summary, knob_summary
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
    from neusky_torch.engine.checkpoint import latest_step, load_illumination_prior, resume_into
    from neusky_torch.engine.optimizers import GroupedAdam, default_neusky_optimizer_groups
    from neusky_torch.models.neusky import NeuSkyModel
    from neusky_torch.models.pipeline import PipelineConfig
    from neusky_torch.parallel.mesh import make_train_step
    from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig

    cfg = build_config(args)
    prov = {"env_knobs": knob_summary(), "effective": effective_summary(cfg)}
    if args.gt_illumination:
        prov["gt_illumination_probe"] = True
    if args.prior_dir:
        prov["prior_dir"] = args.prior_dir
    emit(args, prov)
    model = NeuSkyModel(cfg, device=args.device)
    pipeline = PipelineConfig(
        visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=8, num_rays_per_sample=128,
                                                  only_sample_upper_hemisphere=True, concentration=20.0),
        num_sky_rays=256,
    )
    px = scene_px(args)
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=8, width=px, height=px))
    dm = DataManager(
        DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=8, rays_per_image=128), num_sky_rays=256),
        scene["cameras"], scene["images"], scene["masks"], device=model.device,
    )
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    params = load_illumination_prior(params, cfg)
    optimizer = GroupedAdam(params, default_neusky_optimizer_groups(args.steps + 1))
    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = resume_into(Path(args.ckpt_dir), None, params, optimizer)
        dm.reseed(start)  # a fresh batch stream, not a replay of 0..start
        print(json.dumps({"resumed_from": start}), flush=True)
    # the draw stream of a segment starting at ``start``
    seed = int(np.random.SeedSequence([1, start]).generate_state(1)[0])
    generator = torch.Generator(device=model.device).manual_seed(seed)
    return SanityRun(args, cfg, model, pipeline, dm, params, optimizer, make_train_step(model, pipeline, optimizer),
                     generator, start)


def boundary_eval(run: SanityRun, at_step: int) -> None:
    """With ``--eval-images``: fit the eval latents across every image of
    the eval ring (on a copy: the training params do not move), render and
    score each image, emit the eval record."""
    args = run.args
    if not args.eval_images:
        return
    from neusky_torch.data.datamanager import DataManager, DataManagerConfig
    from neusky_torch.data.pixel_sampler import PixelSamplerConfig
    from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
    from neusky_torch.engine.eval_loop import eval_image_metrics, fit_eval_latents, make_render_chunk_fn

    if not run.eval_state:
        px = scene_px(args)
        es = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=args.eval_images, width=px, height=px,
                                                           **EVAL_RING))
        run.eval_state["dm"] = DataManager(
            DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=min(8, args.eval_images),
                                                               rays_per_image=128), num_sky_rays=256),
            run.dm.train_cameras, run.dm.train_images, run.dm.train_masks,
            eval_cameras=es["cameras"], eval_images=es["images"], eval_masks=es["masks"], device=run.model.device,
        )
        run.eval_state["chunk"] = make_render_chunk_fn(run.model)
    edm = run.eval_state["dm"]
    chunk_fn, chunk = run.eval_state["chunk"]
    _beat(args, "eval")
    t0 = time.perf_counter()
    fit_params, fit_losses = fit_eval_latents(run.model, run.params, edm, steps=args.eval_fit_steps)
    _beat(args, "eval")
    psnrs = []
    for ei in range(args.eval_images):
        psnrs.append(float(eval_image_metrics(run.model, fit_params, edm, ei, chunk_fn, chunk)["psnr"]))
        _beat(args, "eval")
    emit(args, {
        "eval_at": at_step,
        "eval_psnr": [round(p, 3) for p in psnrs],
        "eval_psnr_mean": round(float(np.mean(psnrs)), 3),
        "eval_fit_loss_last": round(float(fit_losses[-1]), 5),
        "eval_seconds": round(time.perf_counter() - t0, 1),
    })


def shadow_map(run: SanityRun) -> Dict[str, float]:
    """The sun shadow map (azimuth and elevation 45°) of train camera 0,
    written to ``--shadow-out`` as a grey PNG."""
    from neusky_torch.engine.render_features import render_shadow_map
    from neusky_torch.utils.viz import save_png

    cams = run.dm.train_cameras
    sm = render_shadow_map(run.model, run.params, cams.generate_rays(0), azimuth_deg=45.0, elevation_deg=45.0)
    img = np.clip(sm["shadow_map"].reshape(cams.height, cams.width), 0.0, 1.0)
    save_png(run.args.shadow_out, np.stack([img] * 3, axis=-1))
    rec = {"shadow_out": run.args.shadow_out, "shadow_mean": round(float(img.mean()), 4),
           "shadow_std": round(float(img.std()), 4)}
    print(json.dumps(rec), flush=True)
    return rec


def step_record(run: SanityRun, step: int, aux: Dict[str, Any], elapsed: float) -> Dict[str, Any]:
    """The log record of ``step`` (reading it waits for the card)."""
    m, ld = aux["metrics"], aux["loss_dict"]
    rec = {"step": step, "ddf_encoding": run.cfg.ddf.field.position_encoding_type,
           "psnr": round(float(m["psnr"]), 3)}
    if "psnr_fg" in m:
        rec["psnr_fg"] = round(float(m["psnr_fg"]), 3)
    rec.update(ddf_depth_psnr=round(float(m["ddf_depth_psnr"]), 3), total_loss=round(float(aux["total_loss"]), 4),
               s_val=round(float(m["s_val"]), 5), elapsed_s=round(elapsed, 1))
    for k in RECORD_LOSSES:
        if k in ld:
            rec[k] = round(float(ld[k]), 5)
    return rec


def run_sanity(run: SanityRun, draws_fn: Optional[Callable[[int], dict]] = None,
               on_step: Optional[Callable[[int, dict], None]] = None) -> int:
    """Train from ``run.start`` to ``args.steps``, logging, checkpointing
    and evaluating as the flags say; then the final checkpoint, eval and
    shadow map → the exit code.  ``draws_fn(i)`` gives step i's random
    draws (else they come from ``run.generator``); ``on_step(i, aux)`` is
    called after each step's update."""
    from neusky_torch.engine.checkpoint import save_checkpoint

    args = run.args
    save = lambda step: save_checkpoint(Path(args.ckpt_dir), step, run.params, run.optimizer.state_dict())  # noqa: E731
    t0 = time.perf_counter()
    for i in range(run.start, args.steps):
        batch = run.dm.next_train(i)
        aux = run.step_fn(run.params, batch, float(i), draws_fn(i) if draws_fn else None, run.generator)
        if on_step is not None:
            on_step(i, aux)
        if args.ckpt_every and args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save(i + 1)
        if args.segment_steps and args.ckpt_dir and (i + 1) - run.start >= args.segment_steps and i + 1 < args.steps:
            save(i + 1)
            boundary_eval(run, i + 1)
            print(json.dumps({"segment_done_at": i + 1}), flush=True)
            return 3
        if (i + 1) % args.log_every == 0 or i == run.start:
            emit(args, step_record(run, i + 1, aux, time.perf_counter() - t0))
            _beat(args, str(i + 1))
    if args.ckpt_dir:
        save(args.steps)
        print(json.dumps({"ckpt": args.ckpt_dir, "step": args.steps}), flush=True)
    boundary_eval(run, args.steps)
    if args.shadow_out:
        shadow_map(run)
    return 0


def main(argv=None) -> int:
    return run_sanity(build_run(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
