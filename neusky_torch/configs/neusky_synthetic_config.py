"""NeuSky-synthetic recipe (mirror of
``neusky_tpu/configs/neusky_synthetic_config.py``): the canonical model
with 256 illumination directions on Blender-synthetic multi-illumination
data (the ``custom_neusky`` dataparser).

The bundle's ``downscale_factor`` (4) and ``rays_per_batch`` (512) keys are
read by nothing: ``cli train`` takes ``--downscale`` and
``--rays-per-batch`` (defaults 1 and 1,024), as JAX's does."""

from __future__ import annotations

from neusky_torch.configs.neusky_config import neusky_model_config, neusky_pipeline_config
from neusky_torch.configs.registry import MethodSpec, register_method
from neusky_torch.engine.optimizers import default_neusky_optimizer_groups
from neusky_torch.engine.trainer import TrainerConfig


def _build(num_train_data: int = 8, num_eval_data: int = 2, **_):
    model = neusky_model_config(num_train_data, num_eval_data, num_illumination_directions=256)
    return {
        "model_config": model,
        "pipeline_config": neusky_pipeline_config(),
        "trainer_config": TrainerConfig(max_num_iterations=100001, steps_per_save=5000),
        "optimizer_groups": default_neusky_optimizer_groups(100001),
        "dataparser": "custom_neusky",
        "downscale_factor": 4,  # 0.25 resolution scale
        "rays_per_batch": 512,
    }


neusky_synthetic_method = register_method(
    MethodSpec(
        name="neusky-synthetic",
        description="NeuSky on Blender-synthetic multi-illumination data.",
        build=_build,
    )
)
