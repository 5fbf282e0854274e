"""Multi-level icosphere vertex-feature encoding of directions (mirror of
``neusky_tpu/ops/icosphere_encoding.py``).

Level l is an icosphere of order ``base_order + l`` with a learned feature
vector per vertex.  A direction is encoded by the features of its K
nearest vertices (largest cosines, ``torch.topk``), weighted by inverse
angular distance.  The weights depend on the neighbours' cosines alone, so
the order in which ``topk`` returns tied neighbours does not change the
result.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from neusky_torch.core.spherical import icosphere_vertices


@dataclasses.dataclass(frozen=True)
class IcosphereEncodingConfig:
    num_levels: int = 4
    features_per_level: int = 2
    base_order: int = 1
    k_neighbours: int = 3


class IcosphereEncoding:
    """``init(generator, device)`` → per-level tables ``[V_l, F]``;
    ``__call__(tables, directions [M, 3])`` → ``[M, num_levels · F]``."""

    def __init__(self, config: IcosphereEncodingConfig):
        self.config = config
        self.vertices = [torch.from_numpy(icosphere_vertices(config.base_order + lvl))
                         for lvl in range(config.num_levels)]

    @property
    def out_dim(self) -> int:
        return self.config.num_levels * self.config.features_per_level

    def init(self, generator, device) -> List[torch.Tensor]:
        f = self.config.features_per_level
        return [1e-2 * torch.randn((v.shape[0], f), generator=generator, device=device) for v in self.vertices]

    def __call__(self, tables, directions: torch.Tensor) -> torch.Tensor:
        outs = []
        for verts, table in zip(self.vertices, tables):
            cos = directions @ verts.to(directions.device).T  # [M, V]
            vals, idx = torch.topk(cos, self.config.k_neighbours, dim=-1)
            w = 1.0 / (1.0 - torch.clamp(vals, -1.0, 1.0 - 1e-6) + 1e-4)
            w = w / torch.sum(w, dim=-1, keepdim=True)
            outs.append(torch.sum(table[idx] * w[..., None], dim=1))
        return torch.cat(outs, dim=-1)
