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

``bf16=True`` on a FiLM-SIREN rounds the FiLM layers' matmul inputs to
bfloat16 and runs the product in float32 (JAX ``use_bf16_compute``:
``dot(x.astype(bf16), w.astype(bf16), preferred_element_type=float32)``).
Every product of two bfloat16 values is exact in float32, so this is the
same function up to the order of the sums.  The parameters, the
accumulation, the affine of the frequencies, the sine and the output layer
stay float32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

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
    no [N, out_dim] tensor."""

    def __init__(self, hidden_layers: int, hidden_features: int, out_dim: int, head_block: int = 0):
        self.hidden_layers = hidden_layers
        self.hidden_features = hidden_features
        self.out_dim = out_dim
        self.head_block = head_block

    def init(self, in_dim: int, generator, device) -> Params:
        p = {}
        for i in range(self.hidden_layers):
            p[f"kernel_{i}"] = _kaiming_leaky_init(in_dim, self.hidden_features, generator, device)
            p[f"bias_{i}"] = _bias_init(in_dim, self.hidden_features, generator, device)
            in_dim = self.hidden_features
        p["kernel_out"] = _kaiming_leaky_init(in_dim, self.out_dim, generator, device) * 0.25
        p["bias_out"] = _bias_init(in_dim, self.out_dim, generator, device)
        return p

    def __call__(self, p: Params, z: torch.Tensor):
        x = z
        for i in range(self.hidden_layers):
            x = torch.nn.functional.leaky_relu(x @ p[f"kernel_{i}"] + p[f"bias_{i}"], 0.2)
        w, b = p["kernel_out"], p["bias_out"]
        if self.head_block:
            h, half = self.head_block, self.out_dim // 2
            return [
                (x @ w[:, i * h:(i + 1) * h] + b[i * h:(i + 1) * h],
                 x @ w[:, half + i * h:half + (i + 1) * h] + b[half + i * h:half + (i + 1) * h])
                for i in range(half // h)
            ]
        freqs, phases = torch.chunk(x @ w + b, 2, dim=-1)
        return freqs, phases


class FiLMSiren:
    """FiLM-conditioned SIREN: ``__call__(p, x, conditioning)``; ``x`` is the
    per-query input (directions), ``conditioning`` drives the mapping
    network (positions).  ``hidden_layers`` FiLM layers, then a linear
    output layer."""

    def __init__(self, hidden_layers: int, hidden_features: int, mapping_network_layers: int,
                 mapping_network_features: int, out_dim: int, bf16: bool = False):
        self.hidden_layers = hidden_layers
        self.hidden_features = hidden_features
        self.out_dim = out_dim
        self.bf16 = bf16
        self.mapping = MappingNetwork(mapping_network_layers, mapping_network_features,
                                      2 * hidden_layers * hidden_features)

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
        freqs, phases = self.mapping(p["MappingNetwork_0"], conditioning)
        hf = self.hidden_features
        h = x
        for i in range(self.hidden_layers):
            w, b = p[f"film_kernel_{i}"], p[f"film_bias_{i}"]
            lin = (h.bfloat16().float() @ w.bfloat16().float() if self.bf16 else h @ w) + b
            f = freqs[..., i * hf:(i + 1) * hf] * 15.0 + 30.0
            h = torch.sin(f * lin + phases[..., i * hf:(i + 1) * hf])
        return h @ p["out_kernel"] + p["out_bias"]
