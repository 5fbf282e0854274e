"""MLP building blocks (mirror of ``neusky_tpu/nets/mlp.py``).

Layers are plain functions of a parameter dict keyed like the flax tree:
``{"kernel": [in, out], "bias": [out]}`` plus ``"scale": [out]`` for
weight-normalised layers, whose effective kernel is
``scale · kernel / ‖kernel‖`` with the norm over the input axis (axis 0).
``bf16`` runs a layer's product in bf16 (``nets/bf16.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference.plain.nets.bf16 import matmul

Params = Dict[str, torch.Tensor]


def softplus_beta(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """torch ``Softplus(beta)`` with its overflow guard: linear above
    20/beta; the untaken exp branch's input is clamped so its discarded
    gradient cannot be inf·0 = NaN."""
    big = x * beta > 20.0
    safe_x = torch.where(big, torch.zeros_like(x), x)
    return torch.where(big, x, torch.log1p(torch.exp(beta * safe_x)) / beta)


def softplus_beta_with_slope(x: torch.Tensor, beta: float = 100.0):
    """(softplus_beta(x), d softplus_beta / dx) — the slope carries the
    forward-mode tangents of the SDF MLP by hand."""
    big = x * beta > 20.0
    safe_x = torch.where(big, torch.zeros_like(x), x)
    e = torch.exp(beta * safe_x)
    y = torch.where(big, x, torch.log1p(e) / beta)
    slope = torch.where(big, torch.ones_like(x), e / (1.0 + e))
    return y, slope


def dense_kernel(p: Params, weight_norm: bool) -> torch.Tensor:
    v = p["kernel"]
    if not weight_norm:
        return v
    return p["scale"] * v / (torch.linalg.norm(v, dim=0, keepdim=True) + 1e-12)


def wn_dense(p: Params, x: torch.Tensor, weight_norm: bool = False, bf16: bool = False) -> torch.Tensor:
    """``WNDense``: x [..., in] → [..., out]; with ``bf16`` its product is
    a bf16 product of the input and the (weight-normalised) kernel."""
    return matmul(x, dense_kernel(p, weight_norm), bf16) + p["bias"]


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense``."""
    return x @ p["kernel"] + p["bias"]


def lecun_normal(shape, generator, device, fan_in: Optional[int] = None) -> torch.Tensor:
    """flax's default kernel init: truncated normal (±2σ), variance 1/fan_in."""
    fan_in = shape[0] if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(shape, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return w


def init_dense(in_dim: int, out_dim: int, generator, device) -> Params:
    return {
        "kernel": lecun_normal((in_dim, out_dim), generator, device),
        "bias": torch.zeros(out_dim, device=device),
    }


def with_weight_norm(p: Params) -> Params:
    """Add the ``scale`` = ‖kernel‖ (axis 0) that makes the initial
    weight-normalised layer equal the plain one."""
    return {**p, "scale": torch.linalg.norm(p["kernel"], dim=0)}


def init_geometric_layer(
    layer_index: int,
    num_linear_layers: int,
    in_dim_layer: int,
    out_dim_layer: int,
    raw_in_dim: int,
    bias: float,
    inside_outside: bool,
    generator,
    device,
) -> Params:
    """Geometric (SAL/IGR) init of SDF geometry layer ``layer_index``: the
    initial SDF approximates a sphere of radius ``bias``."""
    sign = -1.0 if inside_outside else 1.0
    shape = (in_dim_layer, out_dim_layer)
    normal = torch.randn(shape, generator=generator, device=device)
    if layer_index == num_linear_layers - 1:
        mean = sign * np.sqrt(np.pi) / np.sqrt(in_dim_layer)
        kernel = mean + 1e-4 * normal
        b = torch.full((out_dim_layer,), -sign * bias, device=device)
    else:
        kernel = (np.sqrt(2.0) / np.sqrt(out_dim_layer)) * normal
        if layer_index == 0:
            kernel[raw_in_dim:, :] = 0.0  # zero the encoded-input part
        b = torch.zeros(out_dim_layer, device=device)
    return {"kernel": kernel, "bias": b}
