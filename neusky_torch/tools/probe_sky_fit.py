"""Can the frozen RENI++ prior fit the synthetic scene's constant sky colour
by latent optimisation alone? (mirror of ``tools/probe_sky_fit.py``)

Isolates the sky's convergence from the full model: one latent [L, 3] and
its scale are fitted through the frozen prior of the canonical config to
the synthetic sky colour, on 512 upper-hemisphere directions, with the
sky-pixel loss of the model (``models/losses.py``) and Adam at lr 1e-2
(the ``illumination_field`` group's rate).  ``NEUSKY_PRIOR_DIR`` probes
another prior directory.

Prints JSON lines: the gradient norms and loss at the start, then a
record at step 1 and every 100 steps (loss, sky sRGB MSE, mean predicted
colour, scale, latent norm).

Usage:
    python -m neusky_torch.tools.probe_sky_fit [--steps 800] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional

import torch

SKY_SRGB = (0.35, 0.55, 0.95)  # data/synthetic.py's sky colour


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="probe_sky_fit")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(device):
    """The canonical config (``NEUSKY_PRIOR_DIR`` overrides the prior
    directory), its model and parameters with the prior loaded."""
    from neusky_torch.configs.neusky_config import neusky_model_config
    from neusky_torch.engine.checkpoint import load_illumination_prior
    from neusky_torch.models.neusky import NeuSkyModel

    cfg = neusky_model_config(num_train_data=1, num_eval_data=1)
    alt = os.environ.get("NEUSKY_PRIOR_DIR", "")
    if alt:
        cfg = dataclasses.replace(cfg, illumination_prior_dir=alt)
        print(json.dumps({"prior_dir": alt}), flush=True)
    model = NeuSkyModel(cfg, device=device)
    params = load_illumination_prior(model.init(torch.Generator(device=model.device).manual_seed(0)), cfg)
    return cfg, model, params


def draw_directions(generator: torch.Generator, device, n: int = 512) -> torch.Tensor:
    """Unit directions with z ≥ 0: the synthetic scene's sky rays all point up."""
    d = torch.randn((n, 3), generator=generator, device=device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.cat([d[:, :2], d[:, 2:].abs()], dim=-1)


def probe(cfg, model, params, dirs: torch.Tensor, steps: int) -> List[dict]:
    """Fit train latent 0 and its scale to the sky colour → the records
    (each printed as a JSON line)."""
    from neusky_torch.core.colour import linear_to_sRGB
    from neusky_torch.models.losses import sky_pixel_loss

    dev = dirs.device
    dec = params["illumination_decoder"]
    n = dirs.shape[0]
    z = params["illumination_field"]["train_latents"][0].detach().clone().requires_grad_(True)
    s = params["illumination_field"]["train_scale"][0].detach().clone().requires_grad_(True)
    sky = torch.tensor(SKY_SRGB, device=dev)
    gt, mask = sky.expand(n, 3), torch.ones((n, 1), device=dev)

    def decode():
        out = model.illumination.apply(dec, dirs, z[None].expand(n, *z.shape), s.reshape(1).expand(n))
        return model.illumination.unnormalise(out["rgb"])

    def loss_fn():
        return sky_pixel_loss(linear_to_sRGB(decode()), gt, mask, cfg.losses.sky_pixel_cosine_weight)

    records = []

    def log(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    loss = loss_fn()
    gz, gs = torch.autograd.grad(loss, (z, s))
    log({"grad_norm_z": round(float(torch.linalg.norm(gz)), 6), "grad_s": round(float(gs), 6),
         "loss_init": round(float(loss.detach()), 5)})
    opt = torch.optim.Adam([z, s], lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for i in range(1, steps + 1):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
        if i % 100 == 0 or i == 1:
            with torch.no_grad():
                pred = linear_to_sRGB(decode())
                log({"step": i, "loss": round(float(loss.detach()), 6),
                     "sky_srgb_mse": round(float(torch.mean((pred - sky) ** 2)), 6),
                     "pred_mean": [round(float(x), 3) for x in pred.mean(0)],
                     "scale": round(float(s), 4), "z_norm": round(float(torch.linalg.norm(z)), 3)})
    return records


def main(argv=None, dirs: Optional[torch.Tensor] = None) -> List[dict]:
    """``dirs``: the fitted directions (else drawn from seed 2)."""
    args = parse_args(argv)
    cfg, model, params = build(args.device)
    if dirs is None:
        dirs = draw_directions(torch.Generator(device=model.device).manual_seed(2), model.device)
    return probe(cfg, model, params, dirs.to(model.device), args.steps)


if __name__ == "__main__":
    main()
