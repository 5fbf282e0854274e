"""SIREN, FiLM-SIREN and the FiLM mapping network (mirror of
``neusky_tpu/nets/siren.py``).

Layers are plain functions of parameter dicts keyed like the flax tree
(kernels ``[in, out]``):

- ``Siren``: ``{"SineLayer_i": {kernel, bias}, "out_kernel", "out_bias"}``;
  a sine layer is sin(ω·(x W + b));
- ``MappingNetwork``: ``{"kernel_i", "bias_i", "kernel_out", "bias_out"}``,
  a LeakyReLU(0.2) MLP emitting (frequencies, phase shifts);
- ``FiLMSiren``: ``{"MappingNetwork_0": {...}, "film_kernel_i",
  "film_bias_i", "out_kernel", "out_bias"}``; FiLM layer i is
  sin((15·f_i + 30)·(h W_i + b_i) + p_i).

Initialisation follows the JAX schemes (drawn from a ``torch.Generator``):
SIREN first layer U(±1/in), hidden U(±√(6/in)/ω); FiLM hidden and output
layers U(±√(6/in)/25); mapping kernels Kaiming-normal for LeakyReLU(0.2),
the output kernel scaled by 0.25; biases U(±1/√in).

``bf16=True`` on a FiLM-SIREN runs the FiLM layers' products in bf16 (JAX
``compute_dtype``: ``dot(x.astype(bf16), w.astype(bf16),
preferred_element_type=float32)``, :func:`~benchmark.reference.plain.nets.bf16.bf16_matmul`).
The parameters, the accumulation, the affine of the frequencies, the sine
and the output layer stay float32.  ``mapping_bf16=True`` (JAX
``mapping_compute_dtype``) runs the mapping network's products in bf16 too
and rounds its (frequencies, phases) outputs to bfloat16; the FiLM layer
upcasts them to float32 before ``15·f + 30`` and the sine.
``per_layer_heads=True`` (JAX ``per_layer_mapping_heads``) has the mapping
network emit one (frequency, phase) pair per FiLM layer from its own column
block of ``kernel_out``: the same function, with no [N, 2·layers·H] tensor.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.plain.nets.bf16 import matmul

Params = Dict[str, torch.Tensor]


def _uniform(shape, bound: float, generator, device) -> torch.Tensor:
    return (torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0) * bound


def _siren_first_init(in_dim: int, out_dim: int, generator, device) -> torch.Tensor:
    return _uniform((in_dim, out_dim), 1.0 / in_dim, generator, device)


def _siren_hidden_init(in_dim: int, out_dim: int, omega: float, generator, device) -> torch.Tensor:
    """Also the FiLM ``frequency_init`` (ω = 25)."""
    return _uniform((in_dim, out_dim), math.sqrt(6.0 / in_dim) / omega, generator, device)


def _kaiming_leaky_init(in_dim: int, out_dim: int, generator, device) -> torch.Tensor:
    std = math.sqrt(2.0 / (1.0 + 0.2**2)) / math.sqrt(in_dim)
    return std * torch.randn((in_dim, out_dim), generator=generator, device=device)


def _bias_init(fan_in: int, out_dim: int, generator, device) -> torch.Tensor:
    return _uniform((out_dim,), 1.0 / math.sqrt(fan_in), generator, device)


class Siren:
    """SIREN MLP: ``hidden_layers + 1`` sine layers, then a linear (or sine)
    output layer."""

    def __init__(self, hidden_layers: int, hidden_features: int, out_dim: int, outermost_linear: bool = True,
                 first_omega_0: float = 30.0, hidden_omega_0: float = 30.0):
        self.hidden_layers = hidden_layers
        self.hidden_features = hidden_features
        self.out_dim = out_dim
        self.outermost_linear = outermost_linear
        self.first_omega_0 = first_omega_0
        self.hidden_omega_0 = hidden_omega_0

    def _omegas(self):
        n = self.hidden_layers + (1 if self.outermost_linear else 2)
        return [self.first_omega_0] + [self.hidden_omega_0] * (n - 1)

    def init(self, in_dim: int, generator, device) -> Params:
        h = self.hidden_features
        p = {}
        dims = [in_dim] + [h] * (self.hidden_layers + 1)
        if not self.outermost_linear:
            dims.append(self.out_dim)
        for i, omega in enumerate(self._omegas()):
            k = (_siren_first_init(dims[i], dims[i + 1], generator, device) if i == 0
                 else _siren_hidden_init(dims[i], dims[i + 1], omega, generator, device))
            p[f"SineLayer_{i}"] = {"kernel": k, "bias": _bias_init(dims[i], dims[i + 1], generator, device)}
        if self.outermost_linear:
            p["out_kernel"] = _siren_hidden_init(h, self.out_dim, self.hidden_omega_0, generator, device)
            p["out_bias"] = _bias_init(h, self.out_dim, generator, device)
        return p

    def __call__(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        for i, omega in enumerate(self._omegas()):
            lp = p[f"SineLayer_{i}"]
            x = torch.sin(omega * (x @ lp["kernel"] + lp["bias"]))
        if self.outermost_linear:
            x = x @ p["out_kernel"] + p["out_bias"]
        return x


class MappingNetwork:
    """FiLM mapping network: z → (frequencies, phase shifts), each
    ``[..., out_dim / 2]``.  With ``head_block`` (= the consuming SIREN's
    width H) it returns one (frequency, phase) pair per FiLM layer instead,
    each from its own column block of ``kernel_out``: the same numbers, with
    no [N, out_dim] tensor.  With ``bf16`` every product is a bf16 product
    and the outputs are bfloat16."""

    def __init__(self, hidden_layers: int, hidden_features: int, out_dim: int, head_block: int = 0,
                 bf16: bool = False):
        self.hidden_layers = hidden_layers
        self.hidden_features = hidden_features
        self.out_dim = out_dim
        self.head_block = head_block
        self.bf16 = bf16

    def init(self, in_dim: int, generator, device) -> Params:
        p = {}
        for i in range(self.hidden_layers):
            p[f"kernel_{i}"] = _kaiming_leaky_init(in_dim, self.hidden_features, generator, device)
            p[f"bias_{i}"] = _bias_init(in_dim, self.hidden_features, generator, device)
            in_dim = self.hidden_features
        p["kernel_out"] = _kaiming_leaky_init(in_dim, self.out_dim, generator, device) * 0.25
        p["bias_out"] = _bias_init(in_dim, self.out_dim, generator, device)
        return p

    def _dense(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return matmul(x, w, self.bf16) + b

    def _out(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        y = self._dense(x, w, b)
        return y.bfloat16() if self.bf16 else y

    def __call__(self, p: Params, z: torch.Tensor):
        x = z
        for i in range(self.hidden_layers):
            x = torch.nn.functional.leaky_relu(self._dense(x, p[f"kernel_{i}"], p[f"bias_{i}"]), 0.2)
        w, b = p["kernel_out"], p["bias_out"]
        if self.head_block:
            h, half = self.head_block, self.out_dim // 2
            return [
                (self._out(x, w[:, i * h:(i + 1) * h], b[i * h:(i + 1) * h]),
                 self._out(x, w[:, half + i * h:half + (i + 1) * h], b[half + i * h:half + (i + 1) * h]))
                for i in range(half // h)
            ]
        freqs, phases = torch.chunk(self._out(x, w, b), 2, dim=-1)
        return freqs, phases


class FiLMSiren:
    """FiLM-conditioned SIREN: ``__call__(p, x, conditioning)``; ``x`` is the
    per-query input (directions), ``conditioning`` drives the mapping
    network (positions).  ``hidden_layers`` FiLM layers, then a linear
    output layer."""

    def __init__(self, hidden_layers: int, hidden_features: int, mapping_network_layers: int,
                 mapping_network_features: int, out_dim: int, bf16: bool = False, mapping_bf16: bool = False,
                 per_layer_heads: bool = False):
        self.hidden_layers = hidden_layers
        self.hidden_features = hidden_features
        self.out_dim = out_dim
        self.bf16 = bf16
        self.per_layer_heads = per_layer_heads
        self.mapping = MappingNetwork(mapping_network_layers, mapping_network_features,
                                      2 * hidden_layers * hidden_features,
                                      head_block=hidden_features if per_layer_heads else 0, bf16=mapping_bf16)

    def init(self, in_dim: int, conditioning_dim: int, generator, device) -> Params:
        h = self.hidden_features
        p = {"MappingNetwork_0": self.mapping.init(conditioning_dim, generator, device)}
        for i in range(self.hidden_layers):
            p[f"film_kernel_{i}"] = (_siren_first_init(in_dim, h, generator, device) if i == 0
                                     else _siren_hidden_init(in_dim, h, 25.0, generator, device))
            p[f"film_bias_{i}"] = _bias_init(in_dim, h, generator, device)
            in_dim = h
        p["out_kernel"] = _siren_hidden_init(h, self.out_dim, 25.0, generator, device)
        p["out_bias"] = _bias_init(h, self.out_dim, generator, device)
        return p

    def __call__(self, p: Params, x: torch.Tensor, conditioning: torch.Tensor) -> torch.Tensor:
        mapped = self.mapping(p["MappingNetwork_0"], conditioning)
        hf = self.hidden_features
        h = x
        for i in range(self.hidden_layers):
            w, b = p[f"film_kernel_{i}"], p[f"film_bias_{i}"]
            lin = matmul(h, w, self.bf16) + b
            if self.per_layer_heads:
                f, ph = mapped[i]
            else:
                f, ph = (m[..., i * hf:(i + 1) * hf] for m in mapped)
            h = torch.sin((f.float() * 15.0 + 30.0) * lin + ph.float())
        return h @ p["out_kernel"] + p["out_bias"]
