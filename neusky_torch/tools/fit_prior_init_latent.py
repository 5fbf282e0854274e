"""Fit the mean-sky init latent of a RENI++ prior and store it in the
prior's file (mirror of ``tools/fit_prior_init_latent.py``).

Every latent fit and every training run starts its sky latents from the
prior's ``init_latent`` (``engine.checkpoint.load_illumination_prior``
broadcasts it into ``train_latents`` and ``eval_latents``; without one they
start at zero).  z = 0 decodes to a plausible mean sky only for a
well-regularised variational prior; the in-framework priors decode it out
of the domain, to a saturated sky on which the sky loss is flat.  So one
latent z* is fitted with the decoder frozen:

- default (log domain): to the log-domain mean of the prior's own training
  corpus (the geometric mean of radiance), with the held-out gate's
  frozen-decoder fit (``engine.reni_trainer.fit_latents_to_envmaps``);
- ``--ldr``: through the clipped sRGB render path to the mean of the
  corpus exposed so each sky's 98th percentile is 1 and tonemapped, so
  the fit starts below saturation with every pixel's gradient alive.

Gates (exit 1, nothing written): z* must decode in the domain (|out| ≤ 1)
for more than 95% of 1,024 random directions; with ``--ldr`` the share of
unsaturated sRGB values must exceed min(0.7, the target's own − 0.1).
Then z* and the decoder go to ``<prior>/reni_prior.npz``
(``engine.checkpoint.save_prior``) and the statistics to
``<prior>/init_latent.json``.  The prior is read from
``<prior>/reni_prior.npz``, else from the bundled conversion of that name.

Usage:
    python -m neusky_torch.tools.fit_prior_init_latent [--prior checkpoints/reni_prior_latent100]
        [--num-skies 32] [--width 128] [--steps 600] [--ldr] [--quick] [--device cpu]

``--quick`` fits a prior of ``train_reni_prior --quick`` (its tiny decoder).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

LDR_PIXELS_PER_STEP = 2048
LDR_LR = 1e-2


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="fit_prior_init_latent")
    ap.add_argument("--prior", default="checkpoints/reni_prior_latent100",
                    help="the prior's directory (relative: from the repository root)")
    ap.add_argument("--num-skies", type=int, default=32,
                    help="corpus size to average (match the prior's quality.json num_skies)")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0, help="corpus seed (match the prior's training run)")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--ldr", action="store_true",
                    help="fit through the clipped sRGB render path to the exposed, tonemapped corpus mean")
    ap.add_argument("--quick", action="store_true", help="the tiny decoder of train_reni_prior --quick")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def srgb_np(x: np.ndarray) -> np.ndarray:
    """Linear → sRGB in [0, 1] on the host."""
    x = np.clip(x, 0.0, None)
    return np.clip(np.where(x <= 0.0031308, 12.92 * x, 1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055),
                   0.0, 1.0)


def prior_dir(prior: str) -> Path:
    path = Path(prior)
    if not path.is_absolute():
        from neusky_torch.engine.checkpoint import REPO_ROOT

        path = REPO_ROOT / path
    return path


def load_decoder(prior: Path, quick: bool, device):
    """(the RENI field, the prior's decoder params on ``device``)."""
    from neusky_torch.configs.neusky_config import neusky_model_config
    from neusky_torch.device import resolve_device
    from neusky_torch.engine.checkpoint import load_illumination_prior
    from neusky_torch.fields.reni import RENIField
    from neusky_torch.tools.train_reni_prior import prior_field_config

    dev = resolve_device(device)
    field_cfg = dataclasses.replace(prior_field_config(quick), fixed_decoder=True)
    field = RENIField(field_cfg)
    cfg = dataclasses.replace(neusky_model_config(1, 1), illumination=field_cfg, illumination_prior_dir=str(prior))
    template = {"illumination_decoder": field.init(torch.Generator(device=dev).manual_seed(0), dev)}
    return field, load_illumination_prior(template, cfg, init_latent=False)["illumination_decoder"]


def fit_log_domain(field, decoder, corpus: np.ndarray, steps: int, pixel_draws=None) -> Tuple[np.ndarray, float]:
    """z* fitted to the corpus's log-domain mean sky → (z* [D, 3], its
    PSNR in the normalised domain)."""
    from neusky_torch.engine.reni_trainer import fit_latents_to_envmaps

    mean_sky = np.exp(np.log(np.maximum(corpus, 1e-8)).mean(axis=0))[None]
    z, psnr = fit_latents_to_envmaps(field, decoder, mean_sky.astype(np.float32), steps=steps,
                                     pixel_draws=pixel_draws)
    return z[0], float(psnr[0])


def fit_ldr(field, decoder, corpus: np.ndarray, steps: int, seed: int,
            pixel_draws: Optional[np.ndarray] = None) -> Tuple[np.ndarray, float, float]:
    """z* fitted through the clipped sRGB path (Adam, lr 1e-2, 2,048 random
    pixels a step, ``pixel_draws`` [steps, 2048] or drawn from a generator
    seeded ``seed``) to the exposed corpus's sRGB mean → (z* [D, 3], its
    sRGB PSNR over the whole sky, the target's share of unsaturated
    values)."""
    from neusky_torch.core.colour import linear_to_sRGB
    from neusky_torch.engine.reni_trainer import OPTAX_ADAM_EPS
    from neusky_torch.sampling.illumination import EquirectangularSampler
    from neusky_torch.tree import tree_leaves, tree_map

    dev = tree_leaves(decoder)[0].device
    decoder = tree_map(lambda t: t.detach(), decoder)
    nc = corpus.shape[0]
    q = np.quantile(corpus.reshape(nc, -1), 0.98, axis=1)[:, None, None, None]
    target = srgb_np(corpus / np.maximum(q, 1e-8)).mean(axis=0)  # [H, W, 3]
    h, w = target.shape[:2]
    dirs = EquirectangularSampler(width=w)(dev)
    tgt = torch.as_tensor(target.reshape(h * w, 3).astype(np.float32), device=dev)
    if pixel_draws is None:
        g = torch.Generator(device=dev).manual_seed(seed)
        pix_all = torch.randint(0, h * w, (steps, LDR_PIXELS_PER_STEP), generator=g, device=dev)
    else:
        pix_all = torch.as_tensor(np.asarray(pixel_draws), device=dev).long()
    render = lambda d, z: linear_to_sRGB(field.unnormalise(field.apply(decoder, d, z)["rgb"]))  # noqa: E731
    z = torch.zeros((field.config.latent_dim, 3), device=dev, requires_grad=True)
    opt = torch.optim.Adam([z], lr=LDR_LR, betas=(0.9, 0.999), eps=OPTAX_ADAM_EPS)
    for s in range(steps):
        pix = pix_all[s]
        loss = torch.mean((render(dirs[pix], z) - tgt[pix]) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
    with torch.no_grad():
        mse = float(torch.mean((render(dirs, z) - tgt) ** 2))
    fit_psnr = 10.0 * float(np.log10(1.0 / max(mse, 1e-12)))
    return z.detach().cpu().numpy(), fit_psnr, float((target.reshape(-1, 3).astype(np.float32) < 0.999).mean())


def decode_stats(field, decoder, z: np.ndarray, dirs: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The decode of z* over 1,024 directions (``dirs``, else unit normals
    from a generator seeded 3): its raw range and share in the domain,
    HDR mean and max, and its sRGB view's unsaturated share and mean."""
    from neusky_torch.tree import tree_leaves

    dev = tree_leaves(decoder)[0].device
    if dirs is None:
        dirs = torch.randn((1024, 3), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    dirs = dirs.to(dev)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    with torch.no_grad():
        out = field.apply(decoder, dirs, torch.as_tensor(z, device=dev))["rgb"]
        raw, hdr = out.cpu().numpy(), field.unnormalise(out).cpu().numpy()
    srgb_view = srgb_np(hdr)
    return {
        "raw_out_min": round(float(raw.min()), 4),
        "raw_out_max": round(float(raw.max()), 4),
        "raw_out_frac_in_domain": round(float((np.abs(raw) <= 1.0).mean()), 4),
        "hdr_mean": round(float(hdr.mean()), 4),
        "hdr_max": round(float(hdr.max()), 4),
        "srgb_frac_unsaturated": round(float((srgb_view < 0.999).mean()), 4),
        "srgb_mean": round(float(srgb_view.mean()), 4),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    from neusky_torch.data.sky_generator import generate_sky_corpus
    from neusky_torch.engine.checkpoint import save_prior

    prior = prior_dir(args.prior)
    field, decoder = load_decoder(prior, args.quick, args.device)
    corpus = generate_sky_corpus(args.num_skies, width=args.width, seed=args.seed)
    target_frac_unsat = None
    if args.ldr:
        z, fit_psnr, target_frac_unsat = fit_ldr(field, decoder, corpus, args.steps, args.seed)
    else:
        z, fit_psnr = fit_log_domain(field, decoder, corpus, args.steps)
    stats = {"mode": "ldr" if args.ldr else "log_domain", "fit_psnr": round(fit_psnr, 3),
             **decode_stats(field, decoder, z), "num_skies": args.num_skies, "width": args.width, "seed": args.seed,
             "steps": args.steps}
    failed = []
    if not stats["raw_out_frac_in_domain"] > 0.95:
        failed.append("the fitted init latent still decodes out of the domain: the prior is unusable")
    if args.ldr:
        stats["target_frac_unsaturated"] = round(target_frac_unsat, 4)
        gate = min(0.7, target_frac_unsat - 0.1)
        if not stats["srgb_frac_unsaturated"] > gate:
            failed.append(f"the LDR-fitted seed still saturates the sRGB clip (gate {gate})")
    print(json.dumps(stats), flush=True)
    if failed:
        print("GATE FAILED, nothing written: " + "; ".join(failed), flush=True)
        return 1
    path = save_prior(prior, decoder, init_latent=z.astype(np.float32))
    (prior / "init_latent.json").write_text(json.dumps(stats, indent=1))
    print(f"saved the init latent to {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
