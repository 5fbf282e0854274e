"""Light-direction samplers (mirror of
``neusky_tpu/sampling/illumination.py``): the icosphere set of the shading
and the equirectangular grid of the envmap panels."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from neusky_torch.core.spherical import (
    draw_rotation_normals,
    icosphere_vertices,
    random_rotation_matrix,
)


def icosphere_order_for(num_directions: int) -> int:
    """Icosphere order whose vertex count (10·order² + 2) is closest to the
    request: 512 → order 7 (492 directions)."""
    best, best_err = 1, 1e18
    for order in range(1, 16):
        err = abs(10 * order * order + 2 - num_directions)
        if err < best_err:
            best, best_err = order, err
    return best


@dataclasses.dataclass(frozen=True)
class IcosahedronSampler:
    num_directions: int = 512
    apply_random_rotation: bool = True

    @property
    def directions_np(self) -> np.ndarray:
        return icosphere_vertices(icosphere_order_for(self.num_directions))

    @property
    def actual_num_directions(self) -> int:
        return self.directions_np.shape[0]

    def __call__(
        self,
        device,
        rotation_normals: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        apply_random_rotation: Optional[bool] = None,
    ) -> torch.Tensor:
        """Direction set [D, 3], rotated by one random SO(3) matrix when
        rotation applies.  ``rotation_normals`` is the explicit draw (four
        standard normals); without it one is drawn from ``generator``."""
        dirs = torch.as_tensor(self.directions_np, device=device)
        do_rot = self.apply_random_rotation if apply_random_rotation is None else apply_random_rotation
        if not do_rot:
            return dirs
        if rotation_normals is None:
            rotation_normals = draw_rotation_normals(generator, device)
        return dirs @ random_rotation_matrix(rotation_normals)


@dataclasses.dataclass(frozen=True)
class EquirectangularSampler:
    """Equirectangular grid of directions, z up, [H·W, 3] row-major from
    the zenith row; height = width // 2."""

    width: int = 128

    @property
    def height(self) -> int:
        return self.width // 2

    def __call__(self, device) -> torch.Tensor:
        phi = (torch.arange(self.height, device=device) + 0.5) / self.height * math.pi
        theta = (torch.arange(self.width, device=device) + 0.5) / self.width * 2.0 * math.pi - math.pi
        phi_g, theta_g = torch.meshgrid(phi, theta, indexing="ij")
        return torch.stack([torch.sin(phi_g) * torch.cos(theta_g), torch.sin(phi_g) * torch.sin(theta_g),
                            torch.cos(phi_g)], dim=-1).reshape(-1, 3)
