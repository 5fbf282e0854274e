"""Pre-LN cross-attention block (mirror of
``neusky_tpu/nets/transformer.py::CrossAttentionBlock``), written as plain
matmuls and a softmax like the JAX code.

Parameters follow the flax tree: ``LayerNorm_{0,1,2}`` (scale, bias),
``MultiHeadDotProductAttention_0`` with ``query``/``key``/``value`` kernels
[in, heads, head_dim] and ``out`` kernel [heads, head_dim, out], and the
GELU feed-forward ``Dense_0`` / ``Dense_1``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from neusky_torch.nets.mlp import dense, lecun_normal

LN_EPS = 1e-6  # flax LayerNorm default


def layer_norm(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], LN_EPS)


def _proj(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """DenseGeneral to (heads, head_dim): [..., T, in] → [..., T, H, Dh]."""
    k = p["kernel"]
    y = x @ k.reshape(k.shape[0], -1) + p["bias"].reshape(-1)
    return y.reshape(*x.shape[:-1], k.shape[1], k.shape[2])


def multi_head_attention(p, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
    """flax ``MultiHeadDotProductAttention`` (no dropout, no mask):
    q_in [..., Q, H], kv_in [..., T, H] → [..., Q, H]."""
    query = _proj(p["query"], q_in)  # [..., Q, h, d]
    key = _proj(p["key"], kv_in)  # [..., T, h, d]
    value = _proj(p["value"], kv_in)
    depth = query.shape[-1]
    query = query / math.sqrt(depth)
    logits = torch.einsum("...qhd,...khd->...hqk", query, key)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", weights, value)
    wo = p["out"]["kernel"]  # [h, d, out]
    return out.reshape(*out.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1]) + p["out"]["bias"]


def cross_attention_block(p, q_tokens: torch.Tensor, kv_tokens: torch.Tensor) -> torch.Tensor:
    h = layer_norm(p["LayerNorm_0"], q_tokens)
    kv = layer_norm(p["LayerNorm_1"], kv_tokens)
    x = q_tokens + multi_head_attention(p["MultiHeadDotProductAttention_0"], h, kv)
    h = layer_norm(p["LayerNorm_2"], x)
    h = F.gelu(dense(p["Dense_0"], h), approximate="tanh")  # flax nn.gelu default
    return x + dense(p["Dense_1"], h)


def init_cross_attention_block(hidden: int, num_heads: int, generator, device):
    head_dim = hidden // num_heads

    def ln():
        return {"scale": torch.ones(hidden, device=device), "bias": torch.zeros(hidden, device=device)}

    def qkv():
        return {
            "kernel": lecun_normal((hidden, num_heads, head_dim), generator, device, fan_in=hidden),
            "bias": torch.zeros(num_heads, head_dim, device=device),
        }

    return {
        "LayerNorm_0": ln(),
        "LayerNorm_1": ln(),
        "LayerNorm_2": ln(),
        "MultiHeadDotProductAttention_0": {
            "query": qkv(),
            "key": qkv(),
            "value": qkv(),
            "out": {
                "kernel": lecun_normal((num_heads, head_dim, hidden), generator, device, fan_in=hidden),
                "bias": torch.zeros(hidden, device=device),
            },
        },
        "Dense_0": {"kernel": lecun_normal((hidden, 4 * hidden), generator, device),
                    "bias": torch.zeros(4 * hidden, device=device)},
        "Dense_1": {"kernel": lecun_normal((4 * hidden, hidden), generator, device),
                    "bias": torch.zeros(hidden, device=device)},
    }
