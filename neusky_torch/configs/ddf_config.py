"""Standalone DDF recipe (mirror of ``neusky_tpu/configs/ddf_config.py``):
20,001 iterations, vMF sampler 8×128 rays, FiLM conditioning with the hash
position encoding, sigmoid termination output; it trains the DDF against
a frozen NeuSky checkpoint used as the ground truth
(``engine/ddf_trainer.py``, ``cli train ddf``)."""

from __future__ import annotations

from neusky_torch.configs.registry import MethodSpec, register_method
from neusky_torch.engine.optimizers import OptimizerGroupConfig
from neusky_torch.engine.trainer import TrainerConfig
from neusky_torch.fields.ddf import DDFFieldConfig
from neusky_torch.models.ddf_model import DDFLossConfig, DDFModelConfig
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig


def ddf_model_config(**overrides) -> DDFModelConfig:
    base = dict(
        field=DDFFieldConfig(
            ddf_type="ddf",
            position_encoding_type="hash",
            direction_encoding_type="nerf",
            conditioning="FiLM",
            termination_output_activation="sigmoid",
            hidden_layers=5, hidden_features=256,
            mapping_layers=5, mapping_features=256,
            predict_probability_of_hit=False,
        ),
        losses=DDFLossConfig(depth_l1=True, sdf_l2=True, multi_view=True, sky_ray=True),
        include_depth_loss_scene_center_weight=True,
        scene_center_weight_exp=3.0,
        scene_center_weight_include_z=False,
    )
    base.update(overrides)
    return DDFModelConfig(**base)


def _build(**_):
    return {
        "model_config": ddf_model_config(),
        "sampler_config": DDFSamplerConfig(
            num_samples_on_sphere=8, num_rays_per_sample=128,
            only_sample_upper_hemisphere=True, concentration=20.0,
        ),
        "trainer_config": TrainerConfig(max_num_iterations=20001, steps_per_save=5000),
        "optimizer_groups": {
            "ddf_field": OptimizerGroupConfig(lr=1e-4, schedule="cosine", max_steps=20001),
        },
    }


ddf_method = register_method(
    MethodSpec(
        name="ddf",
        description="Standalone DDF fit against a frozen NeuSky (``configs/ddf_config.py``).",
        build=_build,
    )
)
