"""Tiny smoke-test recipes (mirror of ``neusky_tpu/configs/tiny_config.py``):
the full NeuSky graph at minimal width — SDF, proposals, RENI++, DDF
visibility, joint DDF fit — so a CPU core steps it.

``fixed_decoder=False`` lets the RENI decoder's gradient be computed, but
the optimizer labels ``illumination_decoder`` frozen (a group no recipe
names), so the decoder does not move, in JAX as in the port."""

from __future__ import annotations

from neusky_torch.configs.registry import MethodSpec, register_method
from neusky_torch.engine.optimizers import OptimizerGroupConfig
from neusky_torch.engine.trainer import TrainerConfig
from neusky_torch.fields.ddf import DDFFieldConfig
from neusky_torch.fields.density_field import DensityFieldConfig
from neusky_torch.fields.reni import RENIFieldConfig
from neusky_torch.fields.sdf_albedo import SDFAlbedoFieldConfig
from neusky_torch.models.ddf_model import DDFLossConfig, DDFModelConfig
from neusky_torch.models.neusky import LossInclusions, NeuSkyModelConfig
from neusky_torch.models.pipeline import PipelineConfig
from neusky_torch.ops.hashgrid import HashGridConfig
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig
from neusky_torch.sampling.proposal import ProposalSamplerConfig

_TINY_HASH = HashGridConfig(num_levels=4, features_per_level=2, log2_hashmap_size=13, base_res=4, max_res=64)


def tiny_model_config(num_train_data: int = 6, num_eval_data: int = 2) -> NeuSkyModelConfig:
    return NeuSkyModelConfig(
        sdf_field=SDFAlbedoFieldConfig(
            num_layers=2, hidden_dim=64, geo_feat_dim=32,
            num_layers_color=2, hidden_dim_color=64, bias=0.3, hash=_TINY_HASH,
            stochastic_table_grads=True,
        ),
        proposal=ProposalSamplerConfig(num_proposal_samples=(32, 16), num_final_samples=12),
        proposal_fields=(
            DensityFieldConfig(hidden_dim=16, num_layers=2, hash=_TINY_HASH),
            DensityFieldConfig(hidden_dim=16, num_layers=2, hash=_TINY_HASH),
        ),
        illumination=RENIFieldConfig(
            latent_dim=8, hidden_features=32, num_attention_heads=4,
            num_attention_layers=2, fixed_decoder=False,
        ),
        ddf=DDFModelConfig(
            field=DDFFieldConfig(
                conditioning="FiLM", position_encoding_type="nerf",
                direction_encoding_type="nerf", hidden_layers=2,
                hidden_features=32, mapping_layers=2, mapping_features=32,
            ),
            losses=DDFLossConfig(depth_l1=True, sdf_l2=True, multi_view=True, sky_ray=True),
        ),
        num_illumination_directions=12,
        use_visibility=True,
        fit_visibility_field=True,
        num_train_data=num_train_data,
        num_eval_data=num_eval_data,
        losses=LossInclusions(hashgrid_density_grid_resolution=6),
        visibility_query_chunk=2048,
    )


def _build(num_train_data: int = 6, num_eval_data: int = 2, **_):
    steps = 50
    return {
        "model_config": tiny_model_config(num_train_data, num_eval_data),
        "pipeline_config": PipelineConfig(
            visibility_train_sampler=DDFSamplerConfig(
                num_samples_on_sphere=2, num_rays_per_sample=16,
                only_sample_upper_hemisphere=True, concentration=20.0,
            ),
            num_sky_rays=32,
        ),
        "trainer_config": TrainerConfig(max_num_iterations=steps, steps_per_save=10**9, steps_per_log=10),
        "optimizer_groups": {
            name: OptimizerGroupConfig(lr=lr, schedule="constant", max_steps=steps)
            for name, lr in (
                ("proposal_networks", 1e-2), ("fields", 1e-3),
                ("illumination_field", 1e-2), ("visibility_sigmoid", 1e-3),
                ("ddf_field", 1e-4),
            )
        },
    }


neusky_tiny_method = register_method(
    MethodSpec(
        name="neusky-tiny",
        description="Tiny full-graph smoke recipe (synthetic demo / CI).",
        build=_build,
    )
)


def _build_synthetic_tiny(num_train_data: int = 6, num_eval_data: int = 2, **_):
    """The tiny model on the Blender-synthetic data path (the
    ``custom_neusky`` dataparser)."""
    bundle = _build(num_train_data, num_eval_data)
    bundle["dataparser"] = "custom_neusky"
    return bundle


neusky_synthetic_tiny_method = register_method(
    MethodSpec(
        name="neusky-synthetic-tiny",
        description="Tiny model on Blender-synthetic data (CI for the synthetic path).",
        build=_build_synthetic_tiny,
    )
)
