"""Parameter-free encodings (mirror of ``neusky_tpu/ops/encodings.py``):
the NeRF frequency encoding and real spherical harmonics."""

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


def sh_encoding(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real spherical harmonics of unit ``directions`` up to ``levels``
    (degree levels − 1) in tcnn / nerfstudio ``SHEncoding`` order:
    ``[..., 3]`` → ``[..., levels²]``."""
    if levels < 1 or levels > 4:
        raise ValueError("sh_encoding supports 1..4 levels")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if levels > 2:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if levels > 3:
        out += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)
