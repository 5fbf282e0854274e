"""Directional distance field (mirror of ``neusky_tpu/fields/ddf.py``):
termination distance from the bounding sphere, per inward direction.

Inputs are sphere points and directions already rotated into each point's
local frame (``models/ddf_model.py``).  Position and direction encodings:
``nerf`` (2 frequencies, the canonical one), ``hash``, ``sh`` (real
spherical harmonics of 4 levels) or ``none``; each keeps the raw input in
front.  Conditioning: ``FiLM`` (FiLM-SIREN with the directions as input and
the positions driving the mapping network, the canonical one), ``Concat``
(SIREN on [directions, positions]) or ``Attention`` (the transformer
decoder, ``nets/transformer.py``: the directions are the query, the
positions one key/value token).  Heads: ``ddf`` (one distance) or
``pddf`` (a softmax mixture of Dirac distances, with the reference's
activation applied twice).  The output is scaled to 2·ddf_radius.

A ``hash`` encoding goes through the all-level exact encode
(``custom_take=True``): its table gradient is one K1 launch per encode.
It computes what the JAX package's plain encode does (exact forward,
exact table gradient, true position cotangent).

FiLM precision and layout (``nets/siren.py``): ``use_bf16_compute`` runs
the FiLM layers' products in bf16, ``use_bf16_mapping`` the mapping
network's products and its (frequencies, phases) outputs, and
``film_per_layer_heads`` gives each FiLM layer its own mapping head.
The canonical FiLM field (:meth:`DirectionalDistanceField.film_kernel_takes`)
also has a fused forward, ``ops/ddf_film_cuda.py``, which the visibility
query takes on the card (``models/neusky.py::NeuSkyModel._fuses_ddf``).

Parameters (flax tree): ``{"net": {...}, "pos_hash_table": [L, F, T],
"dir_hash_table": [L, F, T]}``, the tables present with their encodings.
"""

from __future__ import annotations

import dataclasses

import torch

from neusky_torch.nets.siren import FiLMSiren, Siren
from neusky_torch.nets.transformer import TransformerDecoder
from neusky_torch.ops.ddf_film_cuda import WIDTH
from neusky_torch.ops.encodings import nerf_encoding, nerf_encoding_dim, sh_encoding
from neusky_torch.ops.hashgrid import HashGridConfig, HashGridEncoding

_DDF_HASH = HashGridConfig(num_levels=16, features_per_level=2, log2_hashmap_size=19, base_res=16, max_res=2048)


@dataclasses.dataclass(frozen=True)
class DDFFieldConfig:
    position_encoding_type: str = "hash"  # hash | nerf | sh | none
    direction_encoding_type: str = "nerf"
    hash: HashGridConfig = _DDF_HASH
    conditioning: str = "FiLM"  # FiLM | Concat | Attention
    termination_output_activation: str = "sigmoid"  # sigmoid | tanh | relu
    probability_of_hit_output_activation: str = "sigmoid"
    hidden_layers: int = 5
    hidden_features: int = 256
    mapping_layers: int = 5
    mapping_features: int = 256
    num_attention_heads: int = 8
    num_attention_layers: int = 6
    predict_probability_of_hit: bool = False
    ddf_type: str = "ddf"  # ddf | pddf
    num_dirac_components: int = 2
    eta_T: float = 1.0
    epsilon_s: float = 1e-5
    first_omega_0: float = 30.0
    hidden_omega_0: float = 30.0
    use_bf16_compute: bool = True
    use_bf16_mapping: bool = False
    film_per_layer_heads: bool = False


_ACTIVATIONS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu}


class DirectionalDistanceField:
    """``__call__(params, origins [M, 3], local directions [M, 3])`` → dict
    with ``expected_termination_dist`` [M] (+ ``probability_of_hit`` [M])."""

    def __init__(self, config: DDFFieldConfig, ddf_radius: float = 1.0):
        c = config
        self.config = config
        self.ddf_radius = ddf_radius
        self.distance_scale = 2.0 * ddf_radius  # the sigmoid's (0, 1) to distances
        self.pos_hash = HashGridEncoding(c.hash) if c.position_encoding_type == "hash" else None
        self.dir_hash = HashGridEncoding(c.hash) if c.direction_encoding_type == "hash" else None
        self.n_depth = c.num_dirac_components
        self.n_weight = c.num_dirac_components - 1
        depth_out = 1 if c.ddf_type == "ddf" else self.n_depth + self.n_weight
        out_features = depth_out + (1 if c.predict_probability_of_hit else 0)
        if c.conditioning == "Concat":
            self.net = Siren(c.hidden_layers, c.hidden_features, out_features, outermost_linear=True,
                             first_omega_0=c.first_omega_0, hidden_omega_0=c.hidden_omega_0)
        elif c.conditioning == "FiLM":
            self.net = FiLMSiren(c.hidden_layers, c.hidden_features, c.mapping_layers, c.mapping_features,
                                 out_features, bf16=c.use_bf16_compute, mapping_bf16=c.use_bf16_mapping,
                                 per_layer_heads=c.film_per_layer_heads)
        elif c.conditioning == "Attention":
            self.net = TransformerDecoder(c.hidden_features, c.num_attention_heads, c.num_attention_layers,
                                          out_features)
        else:
            raise ValueError(c.conditioning)

    def film_kernel_takes(self) -> bool:
        """Whether ``ops/ddf_film_cuda.py``'s fused forward computes this
        field: FiLM conditioning at width 256 (the FiLM layers and the
        mapping network), NeRF position and direction encodings, bf16 FiLM
        products, an fp32 mapping network with one shared head, and a single
        sigmoid distance out."""
        c = self.config
        return (c.conditioning == "FiLM" and c.position_encoding_type == "nerf"
                and c.direction_encoding_type == "nerf" and c.ddf_type == "ddf"
                and not c.predict_probability_of_hit and c.termination_output_activation == "sigmoid"
                and c.use_bf16_compute and not c.use_bf16_mapping and not c.film_per_layer_heads
                and c.hidden_features == WIDTH and c.mapping_features == WIDTH
                and c.hidden_layers >= 1 and c.mapping_layers >= 1)

    def _enc_dim(self, kind: str) -> int:
        if kind == "hash":
            return 3 + self.config.hash.out_dim
        if kind == "nerf":
            return 3 + nerf_encoding_dim(3, 2)
        if kind == "sh":
            return 3 + 16
        return 3

    def init(self, generator, device):
        c = self.config
        pos_dim = self._enc_dim(c.position_encoding_type)
        dir_dim = self._enc_dim(c.direction_encoding_type)
        p = {}
        if self.pos_hash is not None:
            p["pos_hash_table"] = self.pos_hash.init(generator, device)
        if self.dir_hash is not None:
            p["dir_hash_table"] = self.dir_hash.init(generator, device)
        if c.conditioning == "Concat":
            p["net"] = self.net.init(dir_dim + pos_dim, generator, device)
        else:
            p["net"] = self.net.init(dir_dim, pos_dim, generator, device)
        return p

    @staticmethod
    def _encode(kind: str, x: torch.Tensor, x01: torch.Tensor, enc, table) -> torch.Tensor:
        if kind == "hash":
            return torch.cat([x, enc(table, x01, custom_take=True)], dim=-1)
        if kind == "nerf":
            return torch.cat([x, nerf_encoding(x, 2, 0.0, 2.0)], dim=-1)
        if kind == "sh":
            return torch.cat([x, sh_encoding(x, 4)], dim=-1)
        return x

    def __call__(self, p, origins: torch.Tensor, directions: torch.Tensor) -> dict:
        c = self.config
        pos = self._encode(
            c.position_encoding_type, origins,
            torch.clamp((origins / self.ddf_radius + 1.0) / 2.0, 0.0, 1.0), self.pos_hash, p.get("pos_hash_table"),
        )
        dirs = self._encode(
            c.direction_encoding_type, directions,
            torch.clamp((directions + 1.0) / 2.0, 0.0, 1.0), self.dir_hash, p.get("dir_hash_table"),
        )
        if c.conditioning == "Concat":
            raw = self.net(p["net"], torch.cat([dirs, pos], dim=-1))
        else:  # FiLM and Attention: (x, conditioning)
            raw = self.net(p["net"], dirs, pos)
        act = _ACTIVATIONS[c.termination_output_activation]
        if c.ddf_type == "pddf":
            dists = act(act(raw[..., : self.n_depth]))
            w = raw[..., self.n_depth : self.n_depth + self.n_weight]
            w = torch.cat([w, 1.0 - w], dim=-1)
            logits = c.eta_T * w / (c.epsilon_s + dists)
            exp_dist = torch.sum(torch.softmax(logits, dim=-1) * dists, dim=-1)
        else:
            exp_dist = act(raw[..., 0])
        out = {"expected_termination_dist": exp_dist * self.distance_scale}
        if c.predict_probability_of_hit:
            out["probability_of_hit"] = _ACTIVATIONS[c.probability_of_hit_output_activation](raw[..., -1])
        return out
