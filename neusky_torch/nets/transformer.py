"""Pre-LN cross-attention block and the transformer decoder built on it
(mirror of ``neusky_tpu/nets/transformer.py``), written as plain matmuls
and a softmax like the JAX code.

Parameters follow the flax tree: ``LayerNorm_{0,1,2}`` (scale, bias),
``MultiHeadDotProductAttention_0`` with ``query``/``key``/``value`` kernels
[in, heads, head_dim] and ``out`` kernel [heads, head_dim, out], and the
GELU feed-forward ``Dense_0`` / ``Dense_1``.  The decoder adds
``query_embed``, ``kv_embed``, ``block_{i}``, ``LayerNorm_0`` and ``out``.

**The folded path.**  The decoder has one query token, and its key/value
tokens are the same in every block.  When the conditioning is a sequence
of more than one token (a 3-D ``[..., T, cond_dim]`` input with T > 1, as
RENI's ``[M, 100, 4]`` latent tokens are), no block embeds, normalises or
projects them.  ``kv_embed``'s kernel and bias, centred over the H
features, form C [cond_dim + 1, H], and the tokens with a 1 appended,
each over its σ, form ts [..., T, cond_dim + 1]: the normalised embedded
tokens are xn = (kv − mean)/σ = ts C, with σ² = t (C Cᵀ / H) tᵀ + 1e-6 as
``LayerNorm`` takes it.  In a block with ``LayerNorm_1`` scale s and bias
b, the key and value kernels W_k, W_v and biases b_k, b_v, and q_h the
scaled query of head h:

- logits_h = ts · (C (s ⊙ W_k,h) q_h) + q_h · (b W_k,h + b_k,h)
- out_h = (Σ_t w_t ts_t) C (s ⊙ W_v,h) + (b W_v,h + b_v,h), as Σ_t w_t = 1

— the same function as the explicit block, not an approximation: in
float64 the two agree to round-off, and in float32 each lies as close to
the float64 answer as the other.  Per query and block the products fall
from 2·T·H² multiply-adds to 2·heads·T·(cond_dim + 1), and no
[..., T, H] tensor is made.  A 2-D conditioning (one token: the DDF's
``Attention`` conditioning on the positions) takes the explicit path,
where folding saves nothing.  Each decoder call on the folded path adds 1
to the counter ``attention.folded_kv``
(:func:`neusky_torch.utils.profiling.count`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from neusky_torch.nets.mlp import dense, init_dense, lecun_normal
from neusky_torch.utils import profiling

LN_EPS = 1e-6  # flax LayerNorm default
FOLDED_KV = "attention.folded_kv"  # counter: decoder calls on the folded path


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


def normalised_tokens(p: Dict[str, torch.Tensor], tokens: torch.Tensor):
    """``F.layer_norm(dense(p, tokens))``, without scale or bias, as its
    two factors (ts [..., T, in + 1], C [in + 1, H]) with xn = ts C (module
    docstring)."""
    c = torch.cat([p["kernel"], p["bias"][None]], dim=0)
    c = c - c.mean(dim=-1, keepdim=True)
    t = torch.cat([tokens, torch.ones_like(tokens[..., :1])], dim=-1)
    var = torch.sum((t @ (c @ c.T / c.shape[-1])) * t, dim=-1, keepdim=True)
    return t * torch.rsqrt(var + LN_EPS), c


def folded_attention(p, ln, q_in: torch.Tensor, ts: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``multi_head_attention(p, q_in, layer_norm(ln, ts @ c))`` from the
    factors alone: ``ln``'s scale, C and the key kernel fold into each
    query; C and the value kernel apply to the attention-weighted sum of
    ts (module docstring)."""
    query = _proj(p["query"], q_in)  # [..., Q, h, d]
    query = query / math.sqrt(query.shape[-1])
    wk, wv = p["key"]["kernel"], p["value"]["kernel"]  # [H, h, d]
    scale = ln["scale"][:, None, None]
    key = torch.einsum("...qhd,ihd->...qhi", query, torch.einsum("ic,chd->ihd", c, wk * scale))
    shift = torch.einsum("...qhd,hd->...qh", query, torch.einsum("c,chd->hd", ln["bias"], wk) + p["key"]["bias"])
    logits = key.flatten(-3, -2) @ ts.transpose(-1, -2) + shift.flatten(-2)[..., None]  # [..., Q·h, T]
    pooled = (torch.softmax(logits, dim=-1) @ ts).unflatten(-2, key.shape[-3:-1])  # [..., Q, h, in + 1]
    bias_v = torch.einsum("c,chd->hd", ln["bias"], wv) + p["value"]["bias"]
    out = torch.einsum("...qhi,ihd->...qhd", pooled, torch.einsum("ic,chd->ihd", c, wv * scale)) + bias_v
    wo = p["out"]["kernel"]  # [h, d, out]
    return out.reshape(*out.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1]) + p["out"]["bias"]


def cross_attention_block(p, q_tokens: torch.Tensor, kv_tokens) -> torch.Tensor:
    """One block over the embedded tokens, or over the factors (ts, C) of
    their normalisation (:func:`normalised_tokens`), which ``LayerNorm_1``
    and the attention fold onto (:func:`folded_attention`)."""
    h = layer_norm(p["LayerNorm_0"], q_tokens)
    attn = p["MultiHeadDotProductAttention_0"]
    if isinstance(kv_tokens, tuple):
        x = q_tokens + folded_attention(attn, p["LayerNorm_1"], h, *kv_tokens)
    else:
        x = q_tokens + multi_head_attention(attn, h, layer_norm(p["LayerNorm_1"], kv_tokens))
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
    conditioning)`` → ``[N, out_dim]``.  More than one token takes the
    folded path (module docstring)."""

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
        if kv.shape[-2] > 1:
            profiling.count(FOLDED_KV)
            kv = normalised_tokens(p["kv_embed"], kv)  # shared by every block
        else:
            kv = dense(p["kv_embed"], kv)
        for i in range(self.num_layers):
            q = cross_attention_block(p[f"block_{i}"], q, kv)
        return dense(p["out"], layer_norm(p["LayerNorm_0"], q)[..., 0, :])
