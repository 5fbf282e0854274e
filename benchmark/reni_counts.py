"""The yardstick's arithmetic of a RENI++ prior-training step: the FLOPs of
the matrix products that the folded decoder needs, forward and backward.

Counted from the shapes alone, as the program's folded path
(``neusky_torch/nets/transformer.py``, module docstring) computes the
decoder: the T latent tokens stay as their K = cond + 1 = 5 factors and no
block projects them.  A product of an [m, k] and a [k, n] operand is
2·m·k·n FLOPs forward, and as much again in the backward for each operand
that needs a gradient: the query's input (directions alone) needs none,
every other operand does (the decoder's weights, and through z the
posteriors).  Elementwise work, normalisations, softmaxes and the Adam
update are not counted.  Per pixel and block that is about 0.35 MFLOP
forward at RENI's widths, where the explicit blocks' key and value
projections alone would be 2·2·T·H² = 6.6 MFLOP."""

from __future__ import annotations

DIR_FEATURES = 10  # |d_z|, |d_xy| and their NeRF encoding (2 frequencies, sin and cos)
TOKEN_WIDTH = 4  # the SO(2)-invariant features of one latent vector
OUT = 3


def _mm(m: int, k: int, n: int, grads: int) -> int:
    """An [m, k] × [k, n] product with ``grads`` of its two operands
    needing a gradient: forward and backward FLOPs."""
    return 2 * m * k * n * (1 + grads)


def step_flops(pixels: int, tokens: int, hidden: int, heads: int, blocks: int) -> float:
    """FLOPs of one step's decoder products at ``pixels`` P, ``tokens`` T
    latent vectors a pixel, width ``hidden`` H, ``heads`` and ``blocks``."""
    p, t, h, k = pixels, tokens, hidden, TOKEN_WIDTH + 1
    dh = h // heads
    n = _mm(p, DIR_FEATURES, h, 1)  # query_embed: the weight's gradient alone
    n += _mm(k, h, k, 2)  # C Cᵀ, σ²'s Gram matrix
    n += _mm(p * t, k, k, 2)  # t (C Cᵀ / H)
    per_block = (
        _mm(p, h, h, 2)  # the query projection
        + 2 * _mm(k, h, h, 2)  # C (s ⊙ W_k), C (s ⊙ W_v)
        + 2 * _mm(1, h, h, 2)  # b W_k, b W_v
        + heads * _mm(p, dh, k, 2)  # each head's query against C s W_k
        + heads * _mm(p, dh, 1, 2)  # each head's query against its key shift
        + p * _mm(heads, k, t, 2)  # logits: the heads' keys against ts
        + p * _mm(heads, t, k, 2)  # the softmax weights' sums of ts
        + heads * _mm(p, k, dh, 2)  # the pooled factors through C s W_v
        + _mm(p, h, h, 2)  # the output projection
        + 2 * _mm(p, h, 4 * h, 2)  # the feed-forward pair
    )
    n += blocks * per_block
    n += _mm(p, h, OUT, 2)  # out
    return float(n)
