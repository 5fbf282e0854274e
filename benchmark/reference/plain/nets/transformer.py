"""Pre-LN cross-attention block and the transformer decoder built on it
(mirror of ``neusky_tpu/nets/transformer.py``), written as plain matmuls
and a softmax like the JAX code.

Parameters follow the flax tree: ``LayerNorm_{0,1,2}`` (scale, bias),
``MultiHeadDotProductAttention_0`` with ``query``/``key``/``value`` kernels
[in, heads, head_dim] and ``out`` kernel [heads, head_dim, out], and the
GELU feed-forward ``Dense_0`` / ``Dense_1``.  The decoder adds
``query_embed``, ``kv_embed``, ``block_{i}``, ``LayerNorm_0`` and ``out``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.plain.nets.mlp import dense, init_dense, lecun_normal

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


class TransformerDecoder:
    """Queries from the per-element input ``x``, keys and values from the
    conditioning (a 2-D ``[N, cond_dim]`` input is one token, a 3-D
    ``[N, T, cond_dim]`` input T tokens), ``num_layers`` cross-attention
    blocks, a final LayerNorm and the ``out`` dense: ``__call__(p, x,
    conditioning)`` → ``[N, out_dim]``."""

    def __init__(self, hidden_features: int, num_heads: int, num_layers: int, out_dim: int):
        self.hidden_features = hidden_features
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.out_dim = out_dim

    def init(self, in_dim: int, conditioning_dim: int, generator, device):
        h = self.hidden_features
        p = {"query_embed": init_dense(in_dim, h, generator, device),
             "kv_embed": init_dense(conditioning_dim, h, generator, device)}
        for i in range(self.num_layers):
            p[f"block_{i}"] = init_cross_attention_block(h, self.num_heads, generator, device)
        p["LayerNorm_0"] = {"scale": torch.ones(h, device=device), "bias": torch.zeros(h, device=device)}
        p["out"] = init_dense(h, self.out_dim, generator, device)
        return p

    def __call__(self, p, x: torch.Tensor, conditioning: torch.Tensor) -> torch.Tensor:
        kv = conditioning[..., None, :] if conditioning.dim() == x.dim() else conditioning
        q = dense(p["query_embed"], x)[..., None, :]
        kv = dense(p["kv_embed"], kv)
        for i in range(self.num_layers):
            q = cross_attention_block(p[f"block_{i}"], q, kv)
        return dense(p["out"], layer_norm(p["LayerNorm_0"], q)[..., 0, :])
