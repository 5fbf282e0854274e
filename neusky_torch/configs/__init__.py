from neusky_torch.configs.neusky_config import (
    neusky_model_config,
    neusky_method,
)
from neusky_torch.configs.ddf_config import ddf_method
from neusky_torch.configs.neusky_synthetic_config import neusky_synthetic_method
from neusky_torch.configs.tiny_config import neusky_tiny_method, tiny_model_config
from neusky_torch.configs.registry import METHOD_REGISTRY, MethodSpec
