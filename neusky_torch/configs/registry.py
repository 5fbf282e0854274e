"""Method registry: named training recipes for the CLI (mirror of
``neusky_tpu/configs/registry.py``).  Specs are plain dataclasses whose
``build`` returns the full config tree; any leaf is overridable from the
CLI with dotted paths (``--model.num_illumination_directions 256``, see
``neusky_torch/cli.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict


@dataclasses.dataclass
class MethodSpec:
    name: str
    description: str
    build: Callable[..., Dict[str, Any]]
    """Returns a dict with ``model_config``, ``pipeline_config``,
    ``trainer_config``, ``optimizer_groups`` and, for some methods,
    ``dataparser`` (and the keys the CLI does not read)."""


METHOD_REGISTRY: Dict[str, MethodSpec] = {}


def register_method(spec: MethodSpec) -> MethodSpec:
    METHOD_REGISTRY[spec.name] = spec
    return spec
