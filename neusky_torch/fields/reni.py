"""RENI++ illumination prior (mirror of ``neusky_tpu/fields/reni.py``):
SO(2)-invariant featurisation of (direction, latent set) and the attention
decoder, in a normalised log-HDR domain.

The decoder is frozen in NeuSky (``fixed_decoder=True``): its parameters
get ``requires_grad_(False)`` while latents and scales keep gradients.
Parameters (flax tree): ``{"params": {"decoder": {"query_embed",
"kv_embed", "block_{i}", "LayerNorm_0", "out"}}}``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from neusky_torch.nets.mlp import dense, init_dense
from neusky_torch.nets.transformer import (
    cross_attention_block,
    init_cross_attention_block,
    layer_norm,
)
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
        if config.conditioning != "Attention":
            raise NotImplementedError(
                f"RENI conditioning {config.conditioning!r} is not ported yet"
            )
        self.config = config

    def init(self, generator, device):
        c = self.config
        h = c.hidden_features
        dir_dim = 2 + (2 * 2 * 2 if c.positional_encoding == "NeRF" else 0)
        dec = {
            "query_embed": init_dense(dir_dim, h, generator, device),
            "kv_embed": init_dense(4, h, generator, device),
        }
        for i in range(c.num_attention_layers):
            dec[f"block_{i}"] = init_cross_attention_block(h, c.num_attention_heads, generator, device)
        dec["LayerNorm_0"] = {"scale": torch.ones(h, device=device), "bias": torch.zeros(h, device=device)}
        dec["out"] = init_dense(h, 3, generator, device)
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
        q = dense(p["query_embed"], dir_feats)[:, None, :]
        kv = dense(p["kv_embed"], latent_tokens)
        for i in range(c.num_attention_layers):
            q = cross_attention_block(p[f"block_{i}"], q, kv)
        out = dense(p["out"], layer_norm(p["LayerNorm_0"], q[:, 0, :]))
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
