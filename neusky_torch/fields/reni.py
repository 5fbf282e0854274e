"""RENI++ illumination prior (mirror of ``neusky_tpu/fields/reni.py``):
SO(2)-invariant featurisation of (direction, latent set) and a decoder, in
a normalised log-HDR domain.  Decoders (``conditioning``): ``Attention``
(the canonical one: the direction features query the latent tokens),
``FiLM`` (a FiLM-SIREN on the direction features, its mapping network
driven by the flattened latent tokens) and ``Concat`` (a SIREN on the
direction features and the flattened tokens).

The ``Attention`` decoder reads each direction's D latent tokens, [M, D, 4],
on the transformer decoder's folded path (``nets/transformer.py``; taken
whenever D > 1): the tokens are normalised once, as their factors, and
no block embeds or projects them, the LayerNorm and the key and value
kernels being folded onto the direction's query.  It is the same function
as the explicit blocks, equal in float64 to round-off and as close to the
float64 answer in float32, so the sky decoded, and the latents', scales'
and rotation's gradients through it, are unchanged.

The decoder is frozen in NeuSky (``fixed_decoder=True``): its parameters
get ``requires_grad_(False)`` while latents and scales keep gradients.
Parameters (flax tree): ``{"params": {"decoder": ...}}`` with
``query_embed``, ``kv_embed``, ``block_{i}``, ``LayerNorm_0``, ``out``
(Attention), ``FiLMSiren_0`` (FiLM) or ``Siren_0`` (Concat).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from neusky_torch.nets.siren import FiLMSiren, Siren
from neusky_torch.nets.transformer import TransformerDecoder
from neusky_torch.ops.encodings import nerf_encoding


@dataclasses.dataclass(frozen=True)
class RENIFieldConfig:
    conditioning: str = "Attention"  # Attention | FiLM | Concat
    invariant_function: str = "VN"
    equivariance: str = "SO2"
    axis_of_invariance: str = "z"
    positional_encoding: str = "NeRF"
    encoded_input: str = "Directions"
    latent_dim: int = 100
    hidden_features: int = 128
    hidden_layers: int = 9
    mapping_layers: int = 5
    mapping_features: int = 128
    num_attention_heads: int = 8
    num_attention_layers: int = 6
    output_activation: str = "None"
    last_layer_linear: bool = True
    fixed_decoder: bool = True
    trainable_scale: bool = True
    log_domain_min: float = -18.0
    log_domain_max: float = 8.0


def so2_invariant_features(directions: torch.Tensor, latents: torch.Tensor):
    """directions [M, 3], latents [M, D, 3] → (dir_feats [M, 2],
    latent_tokens [M, D, 4]) — complete invariants of rotation about z."""

    def safe_norm(x):
        return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)

    d_xy = directions[..., :2]
    d_z = directions[..., 2:3]
    z_xy = latents[..., :2]
    z_z = latents[..., 2:3]
    dot = torch.sum(z_xy * d_xy[:, None, :], dim=-1, keepdim=True)
    cross = (z_xy[..., 0] * d_xy[:, None, 1] - z_xy[..., 1] * d_xy[:, None, 0])[..., None]
    dir_feats = torch.cat([d_z, safe_norm(d_xy)], dim=-1)
    latent_tokens = torch.cat([dot, cross, z_z, safe_norm(z_xy)], dim=-1)
    return dir_feats, latent_tokens


class RENIField:
    """``apply(params, directions, latents, scale, rotation)`` → {"rgb"}."""

    def __init__(self, config: RENIFieldConfig):
        c = config
        self.config = config
        if c.conditioning == "Attention":
            self.decoder = TransformerDecoder(c.hidden_features, c.num_attention_heads, c.num_attention_layers, 3)
            self._name = None
        elif c.conditioning == "FiLM":
            self.decoder = FiLMSiren(c.hidden_layers, c.hidden_features, c.mapping_layers, c.mapping_features, 3)
            self._name = "FiLMSiren_0"
        elif c.conditioning == "Concat":
            self.decoder = Siren(c.hidden_layers, c.hidden_features, 3, outermost_linear=c.last_layer_linear)
            self._name = "Siren_0"
        else:
            raise ValueError(c.conditioning)

    def init(self, generator, device):
        c = self.config
        dir_dim = 2 + (2 * 2 * 2 if c.positional_encoding == "NeRF" else 0)
        if c.conditioning == "Attention":
            dec = self.decoder.init(dir_dim, 4, generator, device)
        elif c.conditioning == "FiLM":
            dec = {self._name: self.decoder.init(dir_dim, 4 * c.latent_dim, generator, device)}
        else:
            dec = {self._name: self.decoder.init(dir_dim + 4 * c.latent_dim, generator, device)}
        return {"params": {"decoder": dec}}

    def apply(
        self,
        params,
        directions: torch.Tensor,
        latents: torch.Tensor,
        scale: Optional[torch.Tensor] = None,
        rotation: Optional[torch.Tensor] = None,
    ) -> dict:
        """directions [M, 3]; latents [M, D, 3] or [D, 3]; scale [M];
        rotation [3, 3] (``directions @ R``) or [M, 3, 3] (``R_m d_m``)."""
        c = self.config
        m = directions.shape[0]
        if latents.dim() == 2:
            latents = latents[None].expand(m, *latents.shape)
        if rotation is not None:
            if rotation.dim() == 2:
                directions = directions @ rotation
            else:
                directions = torch.einsum("mij,mj->mi", rotation, directions)
        if scale is not None:
            latents = latents * scale.reshape(-1, 1, 1)
        dir_feats, latent_tokens = so2_invariant_features(directions, latents)
        if c.positional_encoding == "NeRF":
            dir_feats = torch.cat([dir_feats, nerf_encoding(dir_feats, 2, 0.0, 2.0)], dim=-1)
        p = params["params"]["decoder"]
        if c.conditioning == "Attention":
            out = self.decoder(p, dir_feats, latent_tokens)
        else:
            flat_latents = latent_tokens.reshape(latent_tokens.shape[0], -1)
            if c.conditioning == "FiLM":
                out = self.decoder(p[self._name], dir_feats, flat_latents)
            else:
                out = self.decoder(p[self._name], torch.cat([dir_feats, flat_latents], dim=-1))
        if c.output_activation == "tanh":
            out = torch.tanh(out)
        return {"rgb": out}

    def unnormalise(self, rgb: torch.Tensor) -> torch.Tensor:
        """Normalised [-1, 1] log-HDR → linear HDR.  The clamp to the
        trained domain is straight-through for gradients."""
        c = self.config
        rgb = rgb + (torch.clamp(rgb, -1.0, 1.0) - rgb).detach()
        log_val = (rgb + 1.0) / 2.0 * (c.log_domain_max - c.log_domain_min) + c.log_domain_min
        return torch.exp(log_val)

    def normalise(self, hdr: torch.Tensor) -> torch.Tensor:
        """Linear HDR → the normalised log domain (inverse of
        :meth:`unnormalise` inside it)."""
        c = self.config
        log_val = torch.log(torch.clamp(hdr, min=1e-8))
        return 2.0 * (log_val - c.log_domain_min) / (c.log_domain_max - c.log_domain_min) - 1.0
