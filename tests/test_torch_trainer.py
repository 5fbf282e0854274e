"""The port's ``Trainer._count_rays`` against the JAX loop's
(``neusky_tpu/engine/trainer.py:108-120``) on the same batch: scene rays,
plus the sky rays the batch carries, plus the DDF-fit rays when a DDF is
fitted."""

import dataclasses
import types

import pytest

from neusky_tpu.configs.neusky_config import neusky_model_config as j_model_config
from neusky_tpu.configs.neusky_config import neusky_pipeline_config as j_pipeline_config
from neusky_tpu.engine.trainer import Trainer as JTrainer
from neusky_torch.configs.neusky_config import neusky_model_config, neusky_pipeline_config
from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine.trainer import Trainer
from neusky_torch.models.neusky import NeuSkyModel


def _scene_slice(cfg):
    return dataclasses.replace(
        cfg, ddf=None, use_visibility=False, fit_visibility_field=False,
        losses=dataclasses.replace(cfg.losses, sdf_level_set_visibility=False),
    )


@pytest.mark.parametrize("joint, num_sky_rays, expected", [(False, 256, 1280), (False, 0, 1024), (True, 256, 2304)],
                         ids=["canonical", "no_sky_rays", "joint"])
def test_count_rays_matches_jax(joint, num_sky_rays, expected):
    """Canonical batch: 8 images × 128 rays and 256 sky rays → 1,280 rays
    a step on both sides for the scene slice, and 2,304 with the 8 × 128
    DDF-fit rays of the joint step."""
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=8, width=32, height=32))
    dm = DataManager(
        DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=8, rays_per_image=128)),
        scene["cameras"], scene["images"], scene["masks"], device="cpu",
    )
    batch = dm.next_train(0)
    if num_sky_rays == 0:
        batch = {k: v for k, v in batch.items() if not k.startswith("sky_")}
    pick = (lambda c: c) if joint else _scene_slice
    port = types.SimpleNamespace(model=NeuSkyModel(pick(neusky_model_config(8, 2)), device="cpu"),
                                 pipeline_config=neusky_pipeline_config())
    j_cfg = pick(j_model_config(8, 2))
    jax_side = types.SimpleNamespace(model=types.SimpleNamespace(config=j_cfg, ddf=j_cfg.ddf),
                                     pipeline_config=j_pipeline_config())
    assert Trainer._count_rays(port, batch) == JTrainer._count_rays(jax_side, batch) == expected
