"""Proposal density field: hash grid + tiny MLP → density (mirror of
``neusky_tpu/fields/density_field.py``).

Parameters (flax tree): ``{"params": {"hash_table": [L, F, T],
"dense_0": {kernel, bias}, ..., "dense_out": {kernel, bias}}}``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from benchmark.reference.plain.core.scene import contraction_to_unit_cube
from benchmark.reference.plain.nets.mlp import dense, init_dense
from benchmark.reference.plain.ops.hashgrid import HashGridConfig, HashGridEncoding


def trunc_exp(x: torch.Tensor, cap: float = 15.0) -> torch.Tensor:
    """exp with a clamped input."""
    return torch.exp(torch.clamp(x, -cap, cap))


@dataclasses.dataclass(frozen=True)
class DensityFieldConfig:
    hidden_dim: int = 16
    num_layers: int = 2
    hash: HashGridConfig = HashGridConfig(
        num_levels=5, features_per_level=2, log2_hashmap_size=17,
        base_res=16, max_res=128,
    )
    contraction_order: str = "l2"
    stochastic_table_grad: bool = True
    stochastic_forward: bool = True


class HashMLPDensityField:
    """positions [N, S, 3] (world) → densities [N, S, 1]."""

    def __init__(self, config: DensityFieldConfig):
        self.config = config
        self.encoding = HashGridEncoding(config.hash)

    def init(self, generator, device):
        c = self.config
        p = {"hash_table": self.encoding.init(generator, device)}
        in_dim = self.encoding.out_dim
        for i in range(c.num_layers - 1):
            p[f"dense_{i}"] = init_dense(in_dim, c.hidden_dim, generator, device)
            in_dim = c.hidden_dim
        p["dense_out"] = init_dense(in_dim, 1, generator, device)
        return {"params": p}

    def apply(self, params, positions: torch.Tensor, stoch_u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``stoch_u`` ([N·S] uniforms, the explicit draw of the JAX
        ``jax.random.uniform(rng, (N·S,))``) turns on the stochastic-corner
        table gradient (and, with ``stochastic_forward``, the sampled
        forward); ``None`` → exact encode (the JAX ``rng=None`` path)."""
        c = self.config
        p = params["params"]
        shape = positions.shape[:-1]
        x = contraction_to_unit_cube(positions.reshape(-1, 3), c.contraction_order)
        if not c.stochastic_table_grad:
            stoch_u = None
        h = self.encoding(
            p["hash_table"], x, custom_take=True, stoch_u=stoch_u,
            stoch_fwd=c.stochastic_forward,
        )
        for i in range(c.num_layers - 1):
            h = torch.relu(dense(p[f"dense_{i}"], h))
        density = trunc_exp(dense(p["dense_out"], h) - 1.0)
        return density.reshape(*shape, 1)
