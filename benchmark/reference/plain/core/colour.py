"""Colour-space conversions (mirror of ``neusky_tpu/core/colour.py``)."""

from __future__ import annotations

import torch


def linear_to_sRGB(color: torch.Tensor) -> torch.Tensor:
    """Linear RGB → sRGB with a final clamp to [0, 1] whose gradient is
    straight-through (the clamp changes values, not gradients — see the JAX
    docstring for why saturated pixels must keep their pull)."""
    # the pow branch has infinite slope at 0: clamp its (untaken) input
    small = color <= 0.0031308
    safe = torch.where(small, torch.full_like(color, 0.0031308), color.abs())
    color = torch.where(small, 12.92 * color, 1.055 * torch.pow(safe, 1.0 / 2.4) - 0.055)
    clamped = torch.clamp(color, 0.0, 1.0)
    return color + (clamped - color).detach()


def sRGB_to_linear(color: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`linear_to_sRGB` (without the clamp)."""
    return torch.where(
        color <= 0.04045,
        color / 12.92,
        torch.pow((color + 0.055) / 1.055, 2.4),
    )
