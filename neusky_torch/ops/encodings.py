"""Parameter-free encodings (mirror of ``neusky_tpu/ops/encodings.py``)."""

from __future__ import annotations

import math

import torch


def nerf_encoding_dim(in_dim: int, num_frequencies: int) -> int:
    return in_dim * num_frequencies * 2


def nerf_encoding(
    x: torch.Tensor,
    num_frequencies: int,
    min_freq_exp: float,
    max_freq_exp: float,
) -> torch.Tensor:
    """Sin/cos frequency encoding, nerfstudio semantics: scale by 2π and
    by 2^linspace(min, max, F); emit sin and sin(· + π/2).
    Layout ``[..., D*F*2]`` (per input dim: F sines then F cosines)."""
    freqs = 2.0 ** torch.linspace(
        min_freq_exp, max_freq_exp, num_frequencies, dtype=x.dtype, device=x.device
    )
    scaled = 2.0 * math.pi * x[..., None] * freqs  # [..., D, F]
    enc = torch.cat([torch.sin(scaled), torch.sin(scaled + math.pi / 2.0)], dim=-1)
    return enc.reshape(*x.shape[:-1], -1)
