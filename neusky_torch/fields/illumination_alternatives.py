"""Alternative illumination fields (mirror of
``neusky_tpu/fields/illumination_alternatives.py``): spherical harmonics,
spherical Gaussians and a raw environment map in place of the RENI++
prior.

Each is a per-image latent → radiance map with RENI's contract,
``(directions, latents, scale, rotation) → {"rgb"}`` plus ``unnormalise``,
in a log domain.  None has learned decoder weights.  ``rotation`` is a
[3, 3] matrix applied as ``directions @ R`` or a per-direction [M, 3, 3]
applied as ``R_m d_m``; ``scale`` [M] multiplies the radiance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from neusky_torch.core.spherical import icosphere_vertices
from neusky_torch.ops.encodings import sh_encoding
from neusky_torch.sampling.illumination import icosphere_order_for


def _apply_rotation(directions: torch.Tensor, rotation: Optional[torch.Tensor]) -> torch.Tensor:
    if rotation is None:
        return directions
    if rotation.dim() == 2:
        return directions @ rotation
    return torch.einsum("mij,mj->mi", rotation, directions)


def _linear_in_latents(basis: torch.Tensor, latents: torch.Tensor, scale: Optional[torch.Tensor]) -> dict:
    """Σ_k basis[m, k] · latents[(m,) k, c], times ``scale``."""
    if latents.dim() == 2:
        rgb = basis @ latents
    else:
        rgb = torch.einsum("mk,mkc->mc", basis, latents)
    if scale is not None:
        rgb = rgb * scale[..., None]
    return {"rgb": rgb}


class _LogDomain:
    log_domain: bool

    def unnormalise(self, rgb: torch.Tensor) -> torch.Tensor:
        return torch.exp(rgb) if self.log_domain else rgb


@dataclasses.dataclass(frozen=True)
class SphericalHarmonicIlluminationField(_LogDomain):
    """Latents are SH coefficients [levels², 3] (or [M, levels², 3]):
    radiance Σ_k c_k Y_k(d)."""

    levels: int = 4
    log_domain: bool = True

    @property
    def num_sh_coeffs(self) -> int:
        return self.levels**2

    @property
    def latent_dim(self) -> int:
        return self.num_sh_coeffs

    def __call__(self, directions, latents, scale=None, rotation=None) -> dict:
        directions = _apply_rotation(directions, rotation)
        return _linear_in_latents(sh_encoding(directions, self.levels), latents, scale)


@dataclasses.dataclass(frozen=True)
class SphericalGaussianField(_LogDomain):
    """``sg_num`` lobes G_k(d) = exp(λ(d·μ_k − 1)) with fixed axes μ_k (the
    first ``sg_num`` vertices of the nearest icosphere) and one sharpness
    λ; latent row k is lobe k's RGB weight."""

    sg_num: int = 24
    sharpness: float = 8.0
    log_domain: bool = True

    @property
    def latent_dim(self) -> int:
        return self.sg_num

    def axes(self, device=None) -> torch.Tensor:
        """The lobe axes [sg_num, 3].  The icosphere is the one whose vertex
        count is nearest to ``sg_num``; with fewer vertices than lobes
        (``sg_num=24`` takes 12) there is no field, in JAX as here."""
        v = icosphere_vertices(icosphere_order_for(self.sg_num))
        if v.shape[0] < self.sg_num:
            raise ValueError(f"{v.shape[0]} icosphere vertices for {self.sg_num} lobes")
        return torch.from_numpy(v[: self.sg_num]).to(device)

    def __call__(self, directions, latents, scale=None, rotation=None) -> dict:
        directions = _apply_rotation(directions, rotation)
        basis = torch.exp(self.sharpness * (directions @ self.axes(directions.device).T - 1.0))
        return _linear_in_latents(basis, latents, scale)


@dataclasses.dataclass(frozen=True)
class EnvironmentMapField(_LogDomain):
    """Latents are an equirectangular map [3, H, W] (or [M, 3, H, W]):
    radiance is its bilinear lookup, wrapping around in u and clamped in v
    (the pixel grid of ``EquirectangularSampler``)."""

    height: int = 64
    width: int = 128
    log_domain: bool = True

    @property
    def latent_shape(self):
        return (3, self.height, self.width)

    def __call__(self, directions, latents, scale=None, rotation=None) -> dict:
        directions = _apply_rotation(directions, rotation)
        x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
        phi = torch.arccos(torch.clamp(z, -1.0, 1.0))
        theta = torch.arctan2(y, x)
        v = phi / torch.pi * self.height - 0.5
        u = (theta + torch.pi) / (2.0 * torch.pi) * self.width - 0.5
        # JAX's integer arithmetic: floor, then clip / mod on int32
        v0 = torch.clamp(torch.floor(v).to(torch.int32), 0, self.height - 1)
        v1 = torch.clamp(v0 + 1, 0, self.height - 1)
        u0f = torch.floor(u)
        u0 = torch.remainder(u0f.to(torch.int32), self.width)
        u1 = torch.remainder(u0 + 1, self.width)
        fv = torch.clamp(v - v0, 0.0, 1.0)
        fu = u - u0f

        if latents.dim() == 3:
            def gather(vi, ui):
                return latents[:, vi.long(), ui.long()].T  # [M, 3]
        else:
            m = torch.arange(directions.shape[0], device=directions.device)

            def gather(vi, ui):
                return latents[m, :, vi.long(), ui.long()]

        rgb = (
            gather(v0, u0) * ((1 - fv) * (1 - fu))[..., None]
            + gather(v0, u1) * ((1 - fv) * fu)[..., None]
            + gather(v1, u0) * (fv * (1 - fu))[..., None]
            + gather(v1, u1) * (fv * fu)[..., None]
        )
        if scale is not None:
            rgb = rgb * scale[..., None]
        return {"rgb": rgb}
