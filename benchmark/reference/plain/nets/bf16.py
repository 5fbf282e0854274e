"""The bf16 product of the port: ``a @ b`` with both inputs rounded to
bfloat16 and the products summed in float32 (JAX
``jnp.dot(a.astype(bf16), b.astype(bf16), preferred_element_type=float32)``).
Every bf16 product of the FiLM layers, the FiLM mapping network and the SDF
MLPs goes through :func:`bf16_matmul`.

A product of two bfloat16 values is exact in float32, so the function is
fixed up to the order of the sums.  Its gradients are those of JAX's: the
cotangent of each bf16-rounded input is rounded to bfloat16 (the transpose
of the cast), i.e. ``dA = bf16(g @ bf16(B)ᵀ)`` and ``dB = bf16(bf16(A)ᵀ @ g)``.

- On the CPU: float32 products of the rounded inputs (autograd rounds the
  cotangents at the casts).
- On a CUDA tensor: bf16 × bf16 → float32 on the tensor cores
  (``torch.mm(..., out_dtype=torch.float32)``), in :class:`_Bf16MatMul`,
  whose backward runs on the tensor cores too.  Its float32 cotangent ``g``
  is split into two bfloat16 parts, ``g ≈ hi + lo`` to about 2⁻¹⁷ of ``g``,
  and each part is multiplied exactly, so the backward keeps the float32
  cotangent as the CPU's does instead of rounding it to 8 bits.
"""

from __future__ import annotations

import torch


def _mm_f32(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    return torch.mm(a16, b16, out_dtype=torch.float32)


def _mm_split(g: torch.Tensor, b16: torch.Tensor, g_first: bool) -> torch.Tensor:
    """``g @ b16`` (``g_first``) or ``b16 @ g`` for a float32 ``g``, as two
    exact bf16 products of g's high and low parts summed in float32."""
    hi = g.bfloat16()
    lo = (g - hi.float()).bfloat16()
    if g_first:
        return _mm_f32(hi, b16).add_(_mm_f32(lo, b16))
    return _mm_f32(b16, hi).add_(_mm_f32(b16, lo))


class _Bf16MatMul(torch.autograd.Function):
    """a [M, K], b [K, N] float32 on the card → [M, N] float32."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.bfloat16(), b.bfloat16()
        ctx.save_for_backward(a16, b16)
        return _mm_f32(a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g = g.float()
        da = _mm_split(g, b16.t(), g_first=True).bfloat16().float() if ctx.needs_input_grad[0] else None
        db = _mm_split(g, a16.t(), g_first=False).bfloat16().float() if ctx.needs_input_grad[1] else None
        return da, db


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K], b [K, N] (float32) → [..., N] float32: the product of
    their bfloat16 roundings, summed in float32 (see the module
    docstring)."""
    if not a.is_cuda:
        return a.bfloat16().float() @ b.bfloat16().float()
    lead = a.shape[:-1]
    out = _Bf16MatMul.apply(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*lead, b.shape[-1])


def matmul(a: torch.Tensor, b: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """``a @ b``; with ``bf16`` the bf16 product (JAX ``compute_dtype``)."""
    return bf16_matmul(a, b) if bf16 else a @ b
