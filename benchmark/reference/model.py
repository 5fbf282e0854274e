"""The reference model, built from a configuration file alone.

Everything here is plain PyTorch: the model, its losses, its draws and its
optimizer are those of ``plain/``, a frozen copy of the program's plain
code with the hand-written kernel replaced by its plain version.  It
imports nothing of the program; the weights that both sides start from are
made here (:func:`make_params`)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from benchmark import cfgjson, scene
from benchmark.reference.plain.core import cameras as cameras_module
from benchmark.reference.plain.engine import optimizers
from benchmark.reference.plain.fields import ddf, density_field, reni, sdf_albedo
from benchmark.reference.plain.models import ddf_model, neusky, pipeline
from benchmark.reference.plain.ops import hashgrid
from benchmark.reference.plain.sampling import ddf_sampler, proposal
from benchmark.reference.plain.tree import tree_items, unflatten

ROOT = Path(__file__).resolve().parents[2]


def _classes() -> Dict[str, Any]:
    mods = (ddf, density_field, reni, sdf_albedo, ddf_model, neusky, pipeline, hashgrid, ddf_sampler, proposal,
            optimizers)
    out = {}
    for m in mods:
        for name, obj in vars(m).items():
            if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                out[name] = obj
    return out


def recipe(config: Dict[str, Any]) -> Dict[str, Any]:
    """(model_config, pipeline_config, optimizer_groups) of a configuration
    file, as the reference's own dataclasses."""
    classes = _classes()
    b = config["bundle"]
    return {
        "model_config": cfgjson.decode(b["model_config"], classes),
        "pipeline_config": cfgjson.decode(b["pipeline_config"], classes),
        "optimizer_groups": cfgjson.decode(b["optimizer_groups"], classes),
    }


def load_prior(params: Dict[str, Any], prior_file: str) -> Dict[str, Any]:
    """The RENI decoder from the prior file, and its mean-sky latent in
    every train and eval slot."""
    with np.load(ROOT / prior_file) as z:
        arrays = {k: z[k] for k in z.files}
    template = dict(tree_items({"illumination_decoder": params["illumination_decoder"]}))
    device = next(iter(template.values())).device
    flat = {}
    for key, ref in template.items():
        if tuple(arrays[key].shape) != tuple(ref.shape):
            raise ValueError(f"prior {prior_file}: {key} is {arrays[key].shape}, the model wants {tuple(ref.shape)}")
        flat[key] = torch.from_numpy(arrays[key]).to(device)
    params = dict(params)
    params["illumination_decoder"] = unflatten(flat)["illumination_decoder"]
    z0 = torch.from_numpy(arrays["init_latent"]).to(device)
    for group, key in (("illumination_field", "train_latents"), ("eval_latents", "eval_latents")):
        cur = params[group][key]
        params[group] = {**params[group], key: z0[None].expand_as(cur).clone().to(cur.dtype)}
    return params


def make_model(config: Dict[str, Any], device) -> neusky.NeuSkyModel:
    return neusky.NeuSkyModel(recipe(config)["model_config"], device=device)


def make_params(config: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The run's starting weights: the model's initialisation drawn from
    ``seed`` on ``device``, with the prior loaded where the configuration
    has one."""
    model = make_model(config, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = model.init(gen)
    return load_prior(params, config["prior_file"]) if config["prior_file"] else params


def batch_to_device(batch: Dict, cameras, device) -> Dict:
    """A host batch of the pixel sampler as tensors on ``device``."""
    out = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}
    for k in ("cam_idx", "image_indices", "ray_image_idx", "sky_cam_idx"):
        if k in out:
            out[k] = out[k].long()
    out["cameras"] = cameras
    return out


def split_cameras(split: Dict, device):
    return scene.cameras(split, cameras_module).to(device)
