"""Loading the frozen RENI++ prior (mirror of
``neusky_tpu/engine/checkpoint.py::load_illumination_prior``).

The JAX package keeps its priors as orbax checkpoints.  The port reads a
converted copy instead: ``neusky_torch/assets/<prior dir name>.npz`` holds
the ``illumination_decoder`` tree under its flax paths
(``illumination_decoder/params/decoder/...``) and, where the prior ships
one, the fitted mean-sky latent under ``init_latent``.  Every training
entry point calls :func:`load_illumination_prior` after ``model.init`` —
without it the model trains against a random frozen decoder.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from neusky_torch.tree import tree_items, unflatten

ASSETS = Path(__file__).resolve().parent.parent / "assets"


def prior_asset_path(model_config) -> Optional[Path]:
    prior_dir = getattr(model_config, "illumination_prior_dir", None)
    if not prior_dir:
        return None
    return ASSETS / f"{Path(prior_dir).name}.npz"


def load_illumination_prior(params: Dict[str, Any], model_config, init_latent: bool = True) -> Dict[str, Any]:
    """Replace ``params["illumination_decoder"]`` with the configured prior
    and (``init_latent``) seed ``train_latents`` / ``eval_latents`` with its
    mean-sky latent.  No-op when no prior is configured; raises when one is
    configured but its converted file is missing or does not fit."""
    path = prior_asset_path(model_config)
    if path is None:
        return params
    if not path.exists():
        raise FileNotFoundError(f"illumination prior {path} is missing")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    template = dict(tree_items({"illumination_decoder": params["illumination_decoder"]}))
    device = next(iter(template.values())).device
    decoder_flat = {}
    for key, ref in template.items():
        if key not in arrays or tuple(arrays[key].shape) != tuple(ref.shape):
            got = None if key not in arrays else arrays[key].shape
            raise ValueError(f"prior {path}: {key} is {got}, the model wants {tuple(ref.shape)}")
        decoder_flat[key] = torch.from_numpy(arrays[key]).to(device)
    params = dict(params)
    params["illumination_decoder"] = unflatten(decoder_flat)["illumination_decoder"]
    print(f"loaded RENI++ prior decoder from {path}", file=sys.stderr)
    if init_latent and "init_latent" in arrays:
        z0 = torch.from_numpy(arrays["init_latent"]).to(device)
        for group, key in (("illumination_field", "train_latents"), ("eval_latents", "eval_latents")):
            cur = params[group][key]
            if tuple(cur.shape[1:]) != tuple(z0.shape):
                print(f"WARNING: init_latent shape {tuple(z0.shape)} != {key} slot "
                      f"shape {tuple(cur.shape[1:])} — keeping zero init", file=sys.stderr)
                continue
            params[group] = {**params[group], key: z0[None].expand_as(cur).clone().to(cur.dtype)}
        print("seeded sky latents from the prior's init_latent", file=sys.stderr)
    return params
