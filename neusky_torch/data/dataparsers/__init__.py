from neusky_torch.data.dataparsers.nerfosr import (
    NeRFOSRDataparserConfig,
    parse_nerfosr_scene,
)
from neusky_torch.data.dataparsers.custom_synthetic import (
    CustomSyntheticDataparserConfig,
    parse_custom_synthetic_scene,
)
