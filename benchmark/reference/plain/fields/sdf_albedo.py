"""SDF + albedo field (mirror of ``neusky_tpu/fields/sdf_albedo.py``).

Geometry net: [xyz, NeRF-PE, hash features] → softplus(β=100) MLP
(weight-normalised, geometric init) → [sdf, geo_feat]; colour net:
[xyz, PE, geo_feat] → ReLU MLP → sigmoid albedo; NeuS alpha from the SDF,
its spatial gradient and the learned variance.

The spatial gradient (``gradient_mode="forward"``) is computed as in
``_geo_with_grad_analytic``: the hash encode's d/dx is closed-form (the
three extra outputs of the ``_LevelEncodeDx*`` Functions), the contraction
and PE Jacobians come from ``torch.func.jvp`` of those param-free maps, and
the MLP's three tangents are carried BY HAND (linear layer, then
softplus_beta's slope).  The eikonal loss then back-propagates through
ordinary first-order autograd; no forward-mode AD ever passes through a
custom Function.

``use_bf16_compute`` (JAX ``WNDense.compute_dtype``) makes every geometry
and colour product a bf16 product.  The tangents are then rounded to
bfloat16 where JAX's ``jax.linearize`` of the bf16 MLP rounds them: at each
layer's product, with the kernel (whose tangent is zero) rounded too.

Parameters (flax tree): ``{"params": {"hash_table", "geo_{l}": {kernel,
bias, scale}, "col_{l}": {...}, "variance": [1]}}``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from benchmark.reference.plain.core.rays import RaySamples
from benchmark.reference.plain.core.scene import contraction_to_unit_cube
from benchmark.reference.plain.nets.bf16 import matmul
from benchmark.reference.plain.nets.density import neus_alpha
from benchmark.reference.plain.nets.mlp import (
    dense_kernel,
    init_dense,
    init_geometric_layer,
    softplus_beta,
    softplus_beta_with_slope,
    wn_dense,
    with_weight_norm,
)
from benchmark.reference.plain.ops.encodings import nerf_encoding, nerf_encoding_dim
from benchmark.reference.plain.ops.hashgrid import HashGridConfig, HashGridEncoding


@dataclasses.dataclass(frozen=True)
class SDFAlbedoFieldConfig:
    num_layers: int = 2
    hidden_dim: int = 256
    geo_feat_dim: int = 256
    num_layers_color: int = 2
    hidden_dim_color: int = 256
    bias: float = 0.1
    beta_init: float = 0.1
    use_grid_feature: bool = True
    inside_outside: bool = False
    weight_norm: bool = True
    predict_shininess: bool = False
    hash: HashGridConfig = HashGridConfig()
    contraction_order: str = "l2"
    position_encoding_freqs: int = 6
    use_position_encoding: bool = True
    gradient_mode: str = "forward"
    stochastic_table_grads: bool = False
    use_bf16_compute: bool = False
    stochastic_dxt: bool = False


class SDFAlbedoField:
    def __init__(self, config: SDFAlbedoFieldConfig):
        self.config = config
        self.bf16 = config.use_bf16_compute
        self.encoding = HashGridEncoding(config.hash)
        c = config
        self.pe_dim = nerf_encoding_dim(3, c.position_encoding_freqs) if c.use_position_encoding else 0
        grid_dim = self.encoding.out_dim if c.use_grid_feature else 0
        self.geo_dims = [3 + self.pe_dim + grid_dim] + [c.hidden_dim] * c.num_layers + [1 + c.geo_feat_dim]
        col_out = 4 if c.predict_shininess else 3
        self.col_dims = [3 + self.pe_dim + c.geo_feat_dim] + [c.hidden_dim_color] * c.num_layers_color + [col_out]

    def init(self, generator, device):
        c = self.config
        p = {}
        if c.use_grid_feature:
            p["hash_table"] = self.encoding.init(generator, device)
        n_lin = len(self.geo_dims) - 1
        for l in range(n_lin):
            layer = init_geometric_layer(
                l, n_lin, self.geo_dims[l], self.geo_dims[l + 1], 3, c.bias,
                c.inside_outside, generator, device,
            )
            p[f"geo_{l}"] = with_weight_norm(layer) if c.weight_norm else layer
        for l in range(len(self.col_dims) - 1):
            layer = init_dense(self.col_dims[l], self.col_dims[l + 1], generator, device)
            p[f"col_{l}"] = with_weight_norm(layer) if c.weight_norm else layer
        p["variance"] = torch.full((1,), c.beta_init, device=device)
        return {"params": p}

    # ---- pieces ----

    def _pe(self, positions: torch.Tensor) -> torch.Tensor:
        c = self.config
        return nerf_encoding(positions, c.position_encoding_freqs, 0.0, float(c.position_encoding_freqs - 1))

    def _contract(self, positions: torch.Tensor) -> torch.Tensor:
        return contraction_to_unit_cube(positions, self.config.contraction_order)

    def _geo_input(self, p, positions, custom_take=False, stoch_salt=None) -> torch.Tensor:
        c = self.config
        feats = [positions]
        if c.use_position_encoding:
            feats.append(self._pe(positions))
        if c.use_grid_feature:
            feats.append(
                self.encoding(
                    p["hash_table"], self._contract(positions), custom_take=custom_take,
                    stoch_salt=stoch_salt,
                    stoch_dxt=(c.stochastic_dxt and stoch_salt is not None),
                )
            )
        return torch.cat(feats, dim=-1)

    def _geo_layers(self, p):
        return [p[f"geo_{l}"] for l in range(len(self.geo_dims) - 1)]

    def _geo_mlp(self, p, h: torch.Tensor) -> torch.Tensor:
        layers = self._geo_layers(p)
        for i, lp in enumerate(layers):
            h = wn_dense(lp, h, self.config.weight_norm, self.bf16)
            if i < len(layers) - 1:
                h = softplus_beta(h, 100.0)
        return h

    def _geo_mlp_with_tangents(self, p, h: torch.Tensor, th: torch.Tensor):
        """The geometry MLP and its tangents: h [M, in], th [3, M, in] →
        (out [M, 1+G], t_out [3, M, 1+G])."""
        layers = self._geo_layers(p)
        for i, lp in enumerate(layers):
            k = dense_kernel(lp, self.config.weight_norm)
            h = matmul(h, k, self.bf16) + lp["bias"]
            th = matmul(th, k, self.bf16)
            if i < len(layers) - 1:
                h, slope = softplus_beta_with_slope(h, 100.0)
                th = th * slope
        return h, th

    def geo(self, params, positions, custom_take=False, stoch_salt=None):
        """positions [M, 3] → (sdf [M, 1], geo_feat [M, G])."""
        h = self._geo_mlp(params["params"], self._geo_input(params["params"], positions, custom_take, stoch_salt))
        return h[..., :1], h[..., 1:]

    def sdf_only(self, params, positions: torch.Tensor, stoch_salt=None) -> torch.Tensor:
        """The SDF at ``positions`` [..., 3] → [M, 1] through the exact
        all-level encode (K1 in its backward); with ``stoch_salt`` the table
        gradient samples one corner per (sample, level), while the value and
        the position cotangent stay exact."""
        return self.geo(params, positions.reshape(-1, 3), custom_take=True, stoch_salt=stoch_salt)[0]

    def inv_s(self, params) -> torch.Tensor:
        return torch.clamp(torch.exp(params["params"]["variance"] * 10.0), 1e-6, 1e6)

    def colour(self, params, positions, geo_feat) -> torch.Tensor:
        c = self.config
        p = params["params"]
        feats = [positions]
        if c.use_position_encoding:
            feats.append(self._pe(positions))
        feats.append(geo_feat)
        h = torch.cat(feats, dim=-1)
        n = len(self.col_dims) - 1
        for l in range(n):
            h = wn_dense(p[f"col_{l}"], h, c.weight_norm, self.bf16)
            if l < n - 1:
                h = torch.relu(h)
        return torch.sigmoid(h)

    # ---- full forward over ray samples ----

    def field_outputs(
        self,
        params,
        ray_samples: RaySamples,
        return_alphas: bool = False,
        cos_anneal_ratio: float = 1.0,
        stoch_salt: Optional[torch.Tensor] = None,
    ) -> dict:
        n, s = ray_samples.num_rays, ray_samples.num_samples
        positions = ray_samples.start_positions().reshape(-1, 3)
        sdf, geo_feat, gradients = self.geo_with_grad(params, positions, stoch_salt)
        colours = self.colour(params, positions, geo_feat)
        if self.config.predict_shininess:
            albedo, shininess = colours[..., :3], colours[..., 3:]
        else:
            albedo, shininess = colours, None
        normals = gradients / torch.sqrt(torch.sum(gradients**2, dim=-1, keepdim=True) + 1e-12)
        out = {
            "sdf": sdf.reshape(n, s, 1),
            "gradient": gradients.reshape(n, s, 3),
            "normal": normals.reshape(n, s, 3),
            "albedo": albedo.reshape(n, s, 3),
        }
        if shininess is not None:
            out["shininess"] = shininess.reshape(n, s, 1)
        if return_alphas:
            out["alpha"] = neus_alpha(
                out["sdf"], out["gradient"], ray_samples.directions,
                ray_samples.deltas, self.inv_s(params), cos_anneal_ratio,
            )
        return out

    def geo_with_grad(self, params, positions: torch.Tensor, stoch_salt=None):
        """(sdf, geo_feat, d sdf / d position)."""
        if self.config.gradient_mode == "forward":
            return self._geo_with_grad_analytic(params, positions, stoch_salt)
        x = positions.detach().requires_grad_(True)
        sdf, geo_feat = self.geo(params, x)
        (gradients,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
        return sdf, geo_feat, gradients

    def _geo_with_grad_analytic(self, params, positions: torch.Tensor, stoch_salt=None):
        c = self.config
        p = params["params"]
        m = positions.shape[0]
        eye = torch.eye(3, dtype=positions.dtype, device=positions.device)
        basis = [eye[a].expand(m, 3) for a in range(3)]

        parts = [positions]
        t_parts = [torch.stack(basis)]  # [3, M, 3]
        if c.use_position_encoding:
            parts.append(self._pe(positions))
            t_parts.append(torch.stack([torch.func.jvp(self._pe, (positions,), (t,))[1] for t in basis]))
        if c.use_grid_feature:
            x01 = self._contract(positions)
            feats, dfeats_dx01 = self.encoding.encode_with_dx(p["hash_table"], x01, stoch_salt=stoch_salt)
            parts.append(feats)
            # d(encode)/d(position) = d(encode)/d(x01) · J_contraction
            dx01 = torch.stack([torch.func.jvp(self._contract, (positions,), (t,))[1] for t in basis])
            t_parts.append(torch.einsum("mbf,amb->amf", dfeats_dx01, dx01))
        h = torch.cat(parts, dim=-1)
        th = torch.cat(t_parts, dim=-1)  # [3, M, in]
        hidden, t_hidden = self._geo_mlp_with_tangents(p, h, th)
        gradients = t_hidden[..., 0].t()  # [M, 3]
        return hidden[..., :1], hidden[..., 1:], gradients
