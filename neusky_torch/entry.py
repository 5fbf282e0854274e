"""The single-device forward entry point (counterpart of
``__graft_entry__.py::entry``) and the tiny configuration and batch it
shares with the multi-device dry run (``parallel/dryrun.py``)."""

from __future__ import annotations

import dataclasses

import torch

from neusky_torch.configs.env_overrides import apply_env_knobs
from neusky_torch.core.rays import RayBundle
from neusky_torch.device import resolve_device
from neusky_torch.fields.ddf import DDFFieldConfig
from neusky_torch.fields.density_field import DensityFieldConfig
from neusky_torch.fields.reni import RENIFieldConfig
from neusky_torch.fields.sdf_albedo import SDFAlbedoFieldConfig
from neusky_torch.models.ddf_model import DDFModelConfig
from neusky_torch.models.neusky import LossInclusions, NeuSkyModel, NeuSkyModelConfig
from neusky_torch.ops.hashgrid import HashGridConfig
from neusky_torch.sampling.proposal import ProposalSamplerConfig


def tiny_configs(num_train: int = 4) -> NeuSkyModelConfig:
    """JAX's ``_tiny_configs``: the whole NeuSky graph (SDF, proposals, RENI,
    the FiLM DDF with visibility and its fit) at a width a CPU steps, under
    the ``NEUSKY_*`` knobs."""
    tiny_hash = HashGridConfig(num_levels=4, features_per_level=2, log2_hashmap_size=12, base_res=4, max_res=32)
    return apply_env_knobs(NeuSkyModelConfig(
        sdf_field=SDFAlbedoFieldConfig(num_layers=2, hidden_dim=64, geo_feat_dim=32, num_layers_color=2,
                                       hidden_dim_color=64, hash=tiny_hash),
        proposal=ProposalSamplerConfig(num_proposal_samples=(32, 16), num_final_samples=12),
        proposal_fields=(DensityFieldConfig(hidden_dim=16, num_layers=2, hash=tiny_hash),
                         DensityFieldConfig(hidden_dim=16, num_layers=2, hash=tiny_hash)),
        illumination=RENIFieldConfig(latent_dim=8, hidden_features=32, num_attention_heads=4,
                                     num_attention_layers=2, fixed_decoder=False),
        ddf=DDFModelConfig(field=DDFFieldConfig(
            conditioning="FiLM", position_encoding_type="nerf", direction_encoding_type="nerf", hidden_layers=2,
            hidden_features=32, mapping_layers=2, mapping_features=32)),
        num_illumination_directions=12,
        use_visibility=True,
        fit_visibility_field=True,
        num_train_data=num_train,
        num_eval_data=2,
        losses=LossInclusions(hashgrid_density_grid_resolution=4),
        visibility_query_chunk=1024,
    ))


def tiny_batch(seed: int, device, n_rays: int = 64, num_images: int = 4) -> dict:
    """JAX's ``_tiny_batch`` drawn from ``seed``: ``n_rays`` scene rays from
    one point over ``num_images`` images and 16 upper-hemisphere sky rays,
    on ``device``."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn((n_rays, 3), generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.tensor([[0.0, -0.9, 0.2]]).repeat(n_rays, 1)
    sky_d = torch.randn((16, 3), generator=g)
    sky_d = sky_d / torch.linalg.norm(sky_d, dim=-1, keepdim=True)
    sky_d[:, 2] = sky_d[:, 2].abs()
    batch = {
        "ray_bundle": RayBundle.create(origins=o, directions=d),
        "image": torch.rand((n_rays, 3), generator=g),
        "mask": torch.cat([torch.ones((n_rays, 2)), torch.zeros((n_rays, 2))], dim=-1),
        "image_indices": torch.arange(num_images, dtype=torch.int32),
        "ray_image_idx": torch.repeat_interleave(torch.arange(num_images, dtype=torch.int32), n_rays // num_images),
        "sky_ray_bundle": RayBundle.create(origins=torch.tensor([[0.0, -0.9, 0.2]]).repeat(16, 1), directions=sky_d),
    }
    return {k: (RayBundle(**{f.name: getattr(v, f.name).to(device) for f in dataclasses.fields(v)})
                if isinstance(v, RayBundle) else v.to(device)) for k, v in batch.items()}


def entry(device="cuda"):
    """(fn, example_args): the eval-mode forward of the tiny model.

    ``fn(params, draws_or_generator, ray_bundle, image_indices,
    ray_image_idx)`` is ``NeuSkyModel.forward(..., step=0, train=False)``
    → (rgb, depth, normal, accumulation); its second argument, a dict of
    draws or a ``torch.Generator``, takes JAX's key's place (the eval
    forward draws nothing).  ``example_args`` are the seed-0 params, a
    generator seeded 2 and the rays and image indices of
    ``tiny_batch(1, device)``.  Entry point: runs on the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    model = NeuSkyModel(tiny_configs(), device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    batch = tiny_batch(1, dev)

    def fn(params, draws_or_generator, ray_bundle, image_indices, ray_image_idx):
        rng = {"draws": draws_or_generator} if isinstance(draws_or_generator, dict) else {
            "generator": draws_or_generator}
        # the batch's 4 images index 2 eval slots: JAX's gather clamps an
        # index past the last slot, torch's indexing would raise
        slots = torch.clamp(image_indices, max=model.config.num_eval_data - 1)
        out = model.forward(params, ray_bundle, slots, ray_image_idx, step=0.0, train=False, **rng)
        return out["rgb"], out["depth"], out["normal"], out["accumulation"]

    example_args = (params, torch.Generator(dev).manual_seed(2), batch["ray_bundle"], batch["image_indices"],
                    batch["ray_image_idx"])
    return fn, example_args

