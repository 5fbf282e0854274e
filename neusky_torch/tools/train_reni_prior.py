"""Train and gate a RENI++ sky prior on procedural HDR skies, and write it
where ``illumination_prior_dir`` finds it (mirror of
``tools/train_reni_prior.py``).

  1. a Preetham-sky corpus (``data/sky_generator.py``), train and held-out
     splits;
  2. the variational autodecoder (``engine/reni_trainer.py``) on the
     train split;
  3. the gates: mean train reconstruction PSNR, held-out frozen-decoder
     latent-fit PSNR, SO(2) equivariance, and at z = 0 the share of
     sRGB-saturated directions and a latent fit from zero through the
     clipped sRGB sky loss that must descend;
  4. ``<output>/reni_prior.npz`` (``engine.checkpoint.save_prior``) and
     ``<output>/quality.json``; a model with ``illumination_prior_dir`` set
     to ``<output>`` loads that decoder.  The file holds no mean-sky latent:
     ``neusky_torch/tools/fit_prior_init_latent.py`` fits and adds it.

Usage:
    python -m neusky_torch.tools.train_reni_prior --output outputs/reni_prior
    python -m neusky_torch.tools.train_reni_prior --quick --device cpu
    python -m neusky_torch.tools.train_reni_prior --output outputs/reni_prior --gates-only

Exits 0 when every gate passes, 1 when the prior is written but a gate
fails.
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


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="train_reni_prior")
    ap.add_argument("--num-skies", type=int, default=512)
    ap.add_argument("--holdout", type=int, default=32)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--steps", type=int, default=40000)
    ap.add_argument("--pixels-per-step", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--latent-lr", type=float, default=1e-2)
    ap.add_argument("--output", default="outputs/reni_prior",
                    help="directory for reni_prior.npz and quality.json (relative: from the repository root)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="tiny decoder and corpus: a smoke run")
    ap.add_argument("--gates-only", action="store_true",
                    help="skip training: load the decoder that --output holds and (re)run the quality gates")
    ap.add_argument("--train-psnr-gate", type=float, default=None,
                    help="default 28 (autodecoder) / 16 (variational: decoding the posterior mean of a decoder "
                    "trained on z = mu + sigma*eps with sigma ~ 1 is bounded by that noise; 16 is a collapse floor)")
    ap.add_argument("--holdout-psnr-gate", type=float, default=22.0)
    ap.add_argument("--kl-weight", type=float, default=3e-3)
    ap.add_argument("--autodecoder", action="store_true",
                    help="unregularised autodecoder prior (kl 1e-5 on ||z||^2; z = 0 decodes out of domain)")
    ap.add_argument("--z0-saturation-gate", type=float, default=0.9,
                    help="most share of z = 0 decode directions whose sRGB render is clipped (corpus skies are "
                    "themselves 50-84%% saturated; a flat plateau is ~100%%)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps, fits, renders and LPIPS op by op (default: CUDA graphs on the card)")
    args = ap.parse_args(argv)
    if args.train_psnr_gate is None:
        args.train_psnr_gate = 28.0 if args.autodecoder else 16.0
    if args.quick:
        args.num_skies, args.holdout, args.width = 24, 4, 32
        if args.steps == ap.get_default("steps"):
            args.steps = 400
        args.pixels_per_step = 512
        args.train_psnr_gate, args.holdout_psnr_gate = 10.0, 8.0
        args.z0_saturation_gate = 0.995  # tiny decoder: structure only
        args.output = args.output + "_quick"
    return args


def prior_field_config(quick: bool):
    """The decoder a prior trains: the canonical model's RENI field, or
    ``--quick``'s tiny one (latent 8, hidden 32, 2 heads, 2 layers)."""
    from neusky_torch.configs.neusky_config import neusky_model_config

    cfg = dataclasses.replace(neusky_model_config(1, 1).illumination, fixed_decoder=False)
    if quick:
        cfg = dataclasses.replace(cfg, latent_dim=8, hidden_features=32, num_attention_heads=2, num_attention_layers=2)
    return cfg


def gates(args, trainer, heldout_skies: np.ndarray, field_cfg) -> dict:
    """The quality gates of a trained prior (see the module docstring)."""
    from neusky_torch.core.colour import linear_to_sRGB
    from neusky_torch.core.spherical import rot_z
    from neusky_torch.models import losses as L
    from neusky_torch.sampling.illumination import EquirectangularSampler

    field, decoder, dev = trainer.field, trainer.params["decoder"], trainer.device
    sample = range(0, args.num_skies, max(1, args.num_skies // 16))
    train_psnr = float(np.mean([trainer.reconstruction_psnr(i) for i in sample]))
    _, heldout_psnrs = trainer.fit_heldout_latents(heldout_skies, steps=250, pixels_per_step=args.pixels_per_step,
                                                   graphed=False if args.eager else None)
    heldout_psnr = float(np.mean(heldout_psnrs))

    with torch.no_grad():
        # f(R d, Z) == f(d, R^T Z): latents are [D, 3] vectors, z @ R = R^T z
        d = EquirectangularSampler(width=32)(dev)
        z = trainer.params["latents"][0]
        rot = rot_z(np.pi / 3).to(dev)
        equiv_err = float(torch.max(torch.abs(field.apply(decoder, d @ rot.T, z)["rgb"]
                                              - field.apply(decoder, d, z @ rot)["rgb"])))
        z0 = torch.zeros((field_cfg.latent_dim, 3), device=dev)
        pred0 = field.apply(decoder, trainer.directions, z0)["rgb"]
        mean_sky = torch.mean(field.normalise(trainer.targets), dim=0)
        z0_psnr = 10.0 * float(np.log10(4.0 / max(float(torch.mean((pred0 - mean_sky) ** 2)), 1e-12)))
        z0_max_abs = float(torch.max(torch.abs(pred0)))
        z0_srgb = linear_to_sRGB(field.unnormalise(pred0))
        z0_sat_frac = float(torch.mean(((z0_srgb >= 1.0) | (z0_srgb <= 0.0)).float()))

    # a latent fit from zero through the sRGB-clipped sky loss must descend
    stride = max(1, trainer.directions.shape[0] // 2048)
    d_fit = trainer.directions[::stride]
    gt = torch.as_tensor(heldout_skies[0].reshape(-1, 3)[::stride], device=dev)
    gt_srgb = torch.clamp(linear_to_sRGB(gt), 0.0, 1.0)
    fit_mask = torch.ones((d_fit.shape[0], 1), device=dev)
    z = torch.zeros((field_cfg.latent_dim, 3), device=dev, requires_grad=True)
    opt = torch.optim.Adam([z], lr=1e-2, eps=1e-8)
    fit_losses = []
    for _ in range(150):
        loss = L.sky_pixel_loss(linear_to_sRGB(field.unnormalise(field.apply(decoder, d_fit, z)["rgb"])),
                                gt_srgb, fit_mask, 0.1)
        opt.zero_grad()
        loss.backward()
        opt.step()
        fit_losses.append(loss.detach())
    clip_first, clip_last = float(fit_losses[0]), float(fit_losses[-1])

    out = {
        "train_recon_psnr": train_psnr,
        "heldout_fit_psnr": heldout_psnr,
        "equivariance_max_err": equiv_err,
        "train_gate": train_psnr >= args.train_psnr_gate,
        "holdout_gate": heldout_psnr >= args.holdout_psnr_gate,
        "equivariance_gate": equiv_err < 1e-3,
        "variational": not args.autodecoder,
        "z0_mean_sky_psnr": z0_psnr,
        "z0_decode_max_abs": z0_max_abs,
        "z0_srgb_saturated_frac": z0_sat_frac,
        "clip_fit_loss_first": clip_first,
        "clip_fit_loss_last": clip_last,
        "z0_gate": z0_sat_frac <= args.z0_saturation_gate,
        "clip_fit_gate": clip_last < 0.7 * clip_first,
    }
    out["all_pass"] = bool(out["train_gate"] and out["holdout_gate"] and out["equivariance_gate"]
                           and (args.autodecoder or (out["z0_gate"] and out["clip_fit_gate"])))
    return out


def restore_for_gates(args, trainer, train_skies: np.ndarray, out: Path) -> None:
    """``--gates-only``: the trainer's decoder from the prior ``out`` holds
    (``<out>/reni_prior.npz``, else the bundled conversion of that name),
    and its first 32 train latents refitted against it, so the train gate
    measures the restored decoder and not random latents; the gates then
    sample only those rows.  The step count is the one ``quality.json``
    recorded, where there is one."""
    from types import SimpleNamespace

    from neusky_torch.engine.checkpoint import load_illumination_prior

    restored = load_illumination_prior({"illumination_decoder": trainer.params["decoder"]},
                                       SimpleNamespace(illumination_prior_dir=str(out)), init_latent=False)
    trainer.params["decoder"] = restored["illumination_decoder"]
    n_fit = min(32, args.num_skies)
    z_train, _ = trainer.fit_heldout_latents(train_skies[:n_fit], steps=250, pixels_per_step=args.pixels_per_step,
                                             graphed=False if args.eager else None)
    with torch.no_grad():
        trainer.params["latents"][:n_fit] = torch.as_tensor(z_train, device=trainer.device)
    args.num_skies = n_fit
    quality = out / "quality.json"
    if quality.exists():
        trainer.step = int(json.loads(quality.read_text()).get("steps", trainer.step))


def main(argv=None) -> int:
    args = parse_args(argv)

    from neusky_torch.data.sky_generator import generate_sky_corpus
    from neusky_torch.engine.checkpoint import REPO_ROOT, save_prior
    from neusky_torch.engine.reni_trainer import RENITrainer, RENITrainerConfig

    field_cfg = prior_field_config(args.quick)
    t0 = time.time()
    total = args.num_skies + args.holdout
    print(f"generating {total} procedural skies at {args.width}px ...", flush=True)
    corpus = generate_sky_corpus(total, width=args.width, seed=args.seed)
    train_skies, heldout_skies = corpus[:args.num_skies], corpus[args.num_skies:]
    print(f"  done in {time.time() - t0:.1f}s; radiance range [{corpus.min():.2e}, {corpus.max():.2e}]", flush=True)

    trainer = RENITrainer(
        RENITrainerConfig(
            field=field_cfg, lr=args.lr, latent_lr=args.latent_lr,
            kl_weight=1e-5 if args.autodecoder else args.kl_weight, variational=not args.autodecoder,
            num_steps=args.steps, pixels_per_step=args.pixels_per_step, steps_per_call=min(100, args.steps),
            seed=args.seed,
        ),
        train_skies, device=args.device, graphed=False if args.eager else None,
    )
    out = Path(args.output)
    if not out.is_absolute():
        out = REPO_ROOT / out
    if args.gates_only:
        restore_for_gates(args, trainer, train_skies, out)
        train_time = 0.0
    else:
        sync = torch.cuda.synchronize if trainer.device.type == "cuda" else (lambda: None)
        t0 = time.time()
        trainer.run(log_every=max(args.steps // 20, 1), log_fn=lambda rec: print(json.dumps(rec), flush=True))
        sync()
        train_time = time.time() - t0
        print(f"trained {trainer.step} steps in {train_time:.1f}s", flush=True)
        print(f"saved prior decoder to {save_prior(out, trainer.params['decoder'])}", flush=True)

    result = gates(args, trainer, heldout_skies, field_cfg)
    result.update(steps=trainer.step, train_seconds=train_time, num_skies=args.num_skies, width=args.width,
                  latent_dim=field_cfg.latent_dim, device=str(trainer.device))
    (out / "quality.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result), flush=True)
    if not result["all_pass"]:
        print("QUALITY GATES FAILED — prior saved but needs more training", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
