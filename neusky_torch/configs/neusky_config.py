"""Canonical NeuSky recipe (mirror of
``neusky_tpu/configs/neusky_config.py``): ``neusky_model_config`` (the
joint model, with the FiLM-SIREN DDF on NeRF encodings) and
``neusky_pipeline_config`` (vMF DDF rays, 8 sphere points × 128 rays at
κ = 20, 256 sky rays), registered as the CLI method ``neusky``."""

from __future__ import annotations

from neusky_torch.configs.registry import MethodSpec, register_method
from neusky_torch.engine.optimizers import default_neusky_optimizer_groups
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

SDF_HASH = HashGridConfig(
    num_levels=16, features_per_level=2, log2_hashmap_size=19,
    base_res=16, max_res=2048, use_hash=True, smoothstep=False,
)
PROPOSAL_HASH_0 = HashGridConfig(num_levels=5, features_per_level=2, log2_hashmap_size=17, base_res=16, max_res=128)
PROPOSAL_HASH_1 = HashGridConfig(num_levels=5, features_per_level=2, log2_hashmap_size=17, base_res=16, max_res=256)


def neusky_model_config(num_train_data: int, num_eval_data: int, **overrides) -> NeuSkyModelConfig:
    base = dict(
        sdf_field=SDFAlbedoFieldConfig(
            num_layers=2, hidden_dim=256, geo_feat_dim=256,
            num_layers_color=2, hidden_dim_color=256,
            bias=0.1, beta_init=0.1,
            use_grid_feature=True, inside_outside=False,
            predict_shininess=False, hash=SDF_HASH,
            contraction_order="l2",
            stochastic_table_grads=True,
        ),
        proposal=ProposalSamplerConfig(num_proposal_samples=(256, 96), num_final_samples=48),
        proposal_fields=(
            DensityFieldConfig(hidden_dim=16, num_layers=2, hash=PROPOSAL_HASH_0),
            DensityFieldConfig(hidden_dim=16, num_layers=2, hash=PROPOSAL_HASH_1),
        ),
        illumination=RENIFieldConfig(
            conditioning="Attention", invariant_function="VN",
            equivariance="SO2", axis_of_invariance="z",
            positional_encoding="NeRF", encoded_input="Directions",
            latent_dim=100, hidden_features=128, hidden_layers=9,
            mapping_layers=5, mapping_features=128,
            num_attention_heads=8, num_attention_layers=6,
            output_activation="None", last_layer_linear=True,
            fixed_decoder=True, trainable_scale=True,
        ),
        illumination_prior_dir="checkpoints/reni_prior_variational",
        ddf=DDFModelConfig(
            field=DDFFieldConfig(
                ddf_type="ddf",
                position_encoding_type="nerf",
                direction_encoding_type="nerf", conditioning="FiLM",
                termination_output_activation="sigmoid",
                hidden_layers=5, hidden_features=256,
                mapping_layers=5, mapping_features=256,
                num_attention_heads=8, num_attention_layers=6,
                predict_probability_of_hit=False,
            ),
            losses=DDFLossConfig(
                depth_l1=True, depth_l2=False, sdf_l1=False, sdf_l2=True,
                prob_hit=False, normal=False, multi_view=True, sky_ray=True,
            ),
            include_depth_loss_scene_center_weight=True,
            scene_center_weight_exp=3.0,
            scene_center_weight_include_z=False,
            mask_to_circumference=False,
            inverse_depth_weight=False,
            log_depth=False,
        ),
        num_illumination_directions=512,
        illumination_sampler_random_rotation=True,
        fix_test_illumination_directions=True,
        use_visibility=True,
        fit_visibility_field=True,
        sdf_to_visibility_stop_gradients="depth",
        only_upperhemisphere_visibility=True,
        lower_hemisphere_visibility=True,
        scene_contraction_order="l2",
        collider_shape="sphere",
        collider_radius=1.0,
        collider_near=0.05,
        ddf_radius=1.0,
        num_train_data=num_train_data,
        num_eval_data=num_eval_data,
        losses=LossInclusions(
            rgb_l1=True, rgb_l2=False, cosine_colour=False,
            eikonal=True, fg_mask=True, normal=False, depth=False,
            sdf_level_set_visibility=True, interlevel=True,
            sky_pixel=True, sky_pixel_cosine_weight=0.1,
            hashgrid_density=True, hashgrid_density_grid_resolution=10,
            ground_plane=True,
            vis_sigmoid_method="learnable",
            vis_optimise_sigmoid_bias=True,
            vis_optimise_sigmoid_scale=False,
            vis_target_min_bias=0.1,
            vis_target_max_scale=25.0,
            vis_steps_until_min_bias=50000,
        ),
        eval_latent_optimise_method="per_image",
    )
    base.update(overrides)
    return NeuSkyModelConfig(**base)


def neusky_pipeline_config(**overrides) -> PipelineConfig:
    base = dict(
        stop_sdf_gradients=False,
        visibility_accumulation_mask_threshold=0.0,
        visibility_train_sampler=DDFSamplerConfig(
            num_samples_on_sphere=8, num_rays_per_sample=128,
            only_sample_upper_hemisphere=True, concentration=20.0,
        ),
        num_sky_rays=256,
    )
    base.update(overrides)
    return PipelineConfig(**base)


def _build(num_train_data: int = 8, num_eval_data: int = 2, **_):
    return {
        "model_config": neusky_model_config(num_train_data, num_eval_data),
        "pipeline_config": neusky_pipeline_config(),
        "trainer_config": TrainerConfig(max_num_iterations=100001, steps_per_save=5000, steps_per_eval_image=5000),
        "optimizer_groups": default_neusky_optimizer_groups(100001),
    }


neusky_method = register_method(
    MethodSpec(
        name="neusky",
        description="Canonical NeuSky on NeRF-OSR (``configs/neusky_config.py``).",
        build=_build,
    )
)
