"""RENI++ checkpoints in PyTorch's layout ↔ the port's decoder parameters
(the port's own copy of ``neusky_tpu/engine/reni_convert.py``).

A published RENI++ decoder is a nerfstudio checkpoint whose ``pipeline``
state dict holds the field under ``_model.field.``, the train/eval latent
banks (``train_mu``, ``train_logvar``, ``eval_mu``, ``eval_logvar``) left
out of the load.  :func:`filter_reni_state_dict` does that filtering;
:func:`torch_state_to_params` maps the names and layouts onto the port's
``RENIField`` tree, which keeps the flax names and layouts
(``convert.py``): ``nn.Linear`` weights ``[out, in]`` transpose to kernels
``[in, out]``; ``nn.MultiheadAttention``'s packed ``in_proj_weight [3H, H]``
splits into query / key / value kernels ``[H, heads, head_dim]``;
``out_proj`` becomes the ``out`` kernel ``[heads, head_dim, H]``; LayerNorm
``weight`` / ``bias`` become ``scale`` / ``bias``.
``TORCH_NAME_ALIASES`` lists the naming variants accepted.  A key that maps
nowhere, or a leaf that no key fills, raises ``KeyError`` with the whole
inventory.  :func:`params_to_torch_state` is the exact inverse.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from neusky_torch.convert import convert_params
from neusky_torch.fields.reni import RENIFieldConfig
from neusky_torch.tree import tree_items

Array = np.ndarray
StateDict = Dict[str, Array]

RENI_PREFIX = "_model.field."
RENI_EXCLUDE = ("train_logvar", "eval_logvar", "train_mu", "eval_mu")


def filter_reni_state_dict(pipeline_state: Dict[str, "object"]) -> StateDict:
    """Keep ``_model.field.*`` minus the latent banks; strip the prefix."""
    out: StateDict = {}
    for k, v in pipeline_state.items():
        if not k.startswith(RENI_PREFIX):
            continue
        if any(s in k for s in RENI_EXCLUDE):
            continue
        out[k[len(RENI_PREFIX):]] = np.asarray(
            v.detach().cpu().numpy() if hasattr(v, "detach") else v
        )
    return out


# ---------------------------------------------------------------------------
# transforms: torch tensor(s) → decoder leaf


def _linear_w(t: Array) -> Array:
    return np.ascontiguousarray(t.T)  # [out, in] → [in, out]


def _identity(t: Array) -> Array:
    return np.asarray(t)


def _mha_qkv(heads: int):
    """torch packed/unpacked projection weight [H_out, H_in] →
    flax kernel [H_in, heads, head_dim]."""

    def f(t: Array) -> Array:
        h_out, h_in = t.shape
        return np.ascontiguousarray(t.T.reshape(h_in, heads, h_out // heads))

    return f


def _mha_qkv_bias(heads: int):
    def f(t: Array) -> Array:
        return np.asarray(t).reshape(heads, t.shape[0] // heads)

    return f


def _mha_out(heads: int):
    """torch out_proj.weight [H, H] → flax out kernel [heads, head_dim, H]."""

    def f(t: Array) -> Array:
        h_out, h_in = t.shape
        return np.ascontiguousarray(t.T.reshape(heads, h_in // heads, h_out))

    return f


# a decoder path is a tuple of dict keys under params["params"]
FlaxPath = Tuple[str, ...]
# one rule: (flax_path, [(torch_name_or_packedspec, transform)])
# a packedspec "name[a:b]" slices the first axis of tensor ``name``.
Rule = Tuple[FlaxPath, List[Tuple[str, Callable[[Array], Array]]]]


def _attention_rules(cfg: RENIFieldConfig) -> List[Rule]:
    h = cfg.hidden_features
    heads = cfg.num_attention_heads
    rules: List[Rule] = [
        (("decoder", "query_embed", "kernel"), [("decoder.query_embed.weight", _linear_w)]),
        (("decoder", "query_embed", "bias"), [("decoder.query_embed.bias", _identity)]),
        (("decoder", "kv_embed", "kernel"), [("decoder.kv_embed.weight", _linear_w)]),
        (("decoder", "kv_embed", "bias"), [("decoder.kv_embed.bias", _identity)]),
        (("decoder", "LayerNorm_0", "scale"), [("decoder.norm_out.weight", _identity)]),
        (("decoder", "LayerNorm_0", "bias"), [("decoder.norm_out.bias", _identity)]),
        (("decoder", "out", "kernel"), [("decoder.out.weight", _linear_w)]),
        (("decoder", "out", "bias"), [("decoder.out.bias", _identity)]),
    ]
    for i in range(cfg.num_attention_layers):
        b = ("decoder", f"block_{i}")
        t = f"decoder.blocks.{i}"
        attn = b + ("MultiHeadDotProductAttention_0",)
        rules += [
            (b + ("LayerNorm_0", "scale"), [(f"{t}.norm_q.weight", _identity)]),
            (b + ("LayerNorm_0", "bias"), [(f"{t}.norm_q.bias", _identity)]),
            (b + ("LayerNorm_1", "scale"), [(f"{t}.norm_kv.weight", _identity)]),
            (b + ("LayerNorm_1", "bias"), [(f"{t}.norm_kv.bias", _identity)]),
            (attn + ("query", "kernel"),
             [(f"{t}.attn.in_proj_weight[0:{h}]", _mha_qkv(heads))]),
            (attn + ("key", "kernel"),
             [(f"{t}.attn.in_proj_weight[{h}:{2 * h}]", _mha_qkv(heads))]),
            (attn + ("value", "kernel"),
             [(f"{t}.attn.in_proj_weight[{2 * h}:{3 * h}]", _mha_qkv(heads))]),
            (attn + ("query", "bias"),
             [(f"{t}.attn.in_proj_bias[0:{h}]", _mha_qkv_bias(heads))]),
            (attn + ("key", "bias"),
             [(f"{t}.attn.in_proj_bias[{h}:{2 * h}]", _mha_qkv_bias(heads))]),
            (attn + ("value", "bias"),
             [(f"{t}.attn.in_proj_bias[{2 * h}:{3 * h}]", _mha_qkv_bias(heads))]),
            (attn + ("out", "kernel"),
             [(f"{t}.attn.out_proj.weight", _mha_out(heads))]),
            (attn + ("out", "bias"), [(f"{t}.attn.out_proj.bias", _identity)]),
            (b + ("LayerNorm_2", "scale"), [(f"{t}.norm_ff.weight", _identity)]),
            (b + ("LayerNorm_2", "bias"), [(f"{t}.norm_ff.bias", _identity)]),
            (b + ("Dense_0", "kernel"), [(f"{t}.ff1.weight", _linear_w)]),
            (b + ("Dense_0", "bias"), [(f"{t}.ff1.bias", _identity)]),
            (b + ("Dense_1", "kernel"), [(f"{t}.ff2.weight", _linear_w)]),
            (b + ("Dense_1", "bias"), [(f"{t}.ff2.bias", _identity)]),
        ]
    return rules


# naming variants accepted for each canonical torch name (rewrites applied
# before rule matching): ``nn.MultiheadAttention`` and ``nn.Transformer``
# layer names, nested decoder modules
TORCH_NAME_ALIASES: List[Tuple[str, str]] = [
    ("decoder.layers.", "decoder.blocks."),          # nn.ModuleList naming
    ("decoder.decoder.blocks.", "decoder.blocks."),  # nested Decoder module
    ("decoder.norm.", "decoder.norm_out."),
    (".self_attn.", ".attn."),
    (".cross_attn.", ".attn."),
    (".multihead_attn.", ".attn."),
    (".norm1.", ".norm_q."),
    (".norm2.", ".norm_ff."),
    (".linear1.", ".ff1."),
    (".linear2.", ".ff2."),
]


def _canonicalise_names(sd: StateDict) -> StateDict:
    out: StateDict = {}
    for k, v in sd.items():
        for old, new in TORCH_NAME_ALIASES:
            if old in k:
                k = k.replace(old, new)
        out[k] = v
    return out


def _fetch(sd: StateDict, spec: str, used: set) -> Array:
    """Resolve ``name`` or ``name[a:b]`` (first-axis slice) from sd."""
    if spec.endswith("]"):
        name, _, sl = spec[:-1].rpartition("[")
        a, b = (int(s) for s in sl.split(":"))
        used.add(name)
        return np.asarray(sd[name])[a:b]
    used.add(spec)
    return np.asarray(sd[spec])


def torch_state_to_params(state: StateDict, config: RENIFieldConfig, device="cpu") -> dict:
    """Filtered torch state dict → the port's ``{"params": {"decoder":
    ...}}`` tree of tensors on ``device``.  Raises ``KeyError`` with the
    full unmatched inventory (both sides) on any mismatch."""
    if config.conditioning != "Attention":
        raise NotImplementedError(
            f"the converter covers the canonical Attention decoder (got conditioning={config.conditioning!r})")
    sd = _canonicalise_names(state)
    flat: Dict[str, Array] = {}
    used: set = set()
    missing: List[str] = []
    for flax_path, sources in _attention_rules(config):
        try:
            parts = [_fetch(sd, spec, used) for spec, _ in sources]
        except KeyError:
            missing.append(".".join(flax_path) + " ← " + ", ".join(s for s, _ in sources))
            continue
        flat["/".join(("params",) + flax_path)] = sources[0][1](parts[0])
    unused = sorted(set(sd) - used)
    if missing or unused:
        lines = ["torch → port RENI++ mapping incomplete:"]
        if missing:
            lines.append("  unmatched decoder leaves (expected torch names):")
            lines += [f"    {m}" for m in missing]
        if unused:
            lines.append("  unconsumed torch tensors:")
            lines += [f"    {k}  shape={tuple(np.asarray(sd[k]).shape)}" for k in unused]
            lines.append("  extend TORCH_NAME_ALIASES / _attention_rules for this checkpoint's naming")
        raise KeyError("\n".join(lines))
    return convert_params(flat, device=device)


def convert_torch_reni_checkpoint(ckpt_path: str, config: RENIFieldConfig, device="cpu") -> dict:
    """A published RENI++ nerfstudio checkpoint
    (``latent_dim_100/nerfstudio_models/step-000050000.ckpt``) → the port's
    decoder tree.  Read with ``torch.load(weights_only=True)``: tensors and
    plain containers only."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state = ckpt["pipeline"] if "pipeline" in ckpt else ckpt
    return torch_state_to_params(filter_reni_state_dict(state), config, device)


def params_to_torch_state(params: dict, config: RENIFieldConfig) -> StateDict:
    """The port's ``RENIField`` params (tensors or arrays, with or without
    the outer ``"params"``) → a state dict in PyTorch's layout and the
    canonical names.  Exact inverse of :func:`torch_state_to_params`."""
    if config.conditioning != "Attention":
        raise NotImplementedError("Attention decoder only (see the converter)")
    tree = params["params"] if "params" in params else params
    flat = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in tree_items(tree)}

    def leaf(path: FlaxPath) -> np.ndarray:
        return flat["/".join(path)]

    out: StateDict = {}

    def put_linear(torch_name: str, path: FlaxPath):
        out[f"{torch_name}.weight"] = np.ascontiguousarray(leaf(path + ("kernel",)).T)
        out[f"{torch_name}.bias"] = leaf(path + ("bias",))

    def put_ln(torch_name: str, path: FlaxPath):
        out[f"{torch_name}.weight"] = leaf(path + ("scale",))
        out[f"{torch_name}.bias"] = leaf(path + ("bias",))

    put_linear("decoder.query_embed", ("decoder", "query_embed"))
    put_linear("decoder.kv_embed", ("decoder", "kv_embed"))
    put_ln("decoder.norm_out", ("decoder", "LayerNorm_0"))
    put_linear("decoder.out", ("decoder", "out"))
    for i in range(config.num_attention_layers):
        b = ("decoder", f"block_{i}")
        t = f"decoder.blocks.{i}"
        put_ln(f"{t}.norm_q", b + ("LayerNorm_0",))
        put_ln(f"{t}.norm_kv", b + ("LayerNorm_1",))
        put_ln(f"{t}.norm_ff", b + ("LayerNorm_2",))
        put_linear(f"{t}.ff1", b + ("Dense_0",))
        put_linear(f"{t}.ff2", b + ("Dense_1",))
        attn = b + ("MultiHeadDotProductAttention_0",)
        ws, bs = [], []
        for proj in ("query", "key", "value"):
            k = leaf(attn + (proj, "kernel"))  # [H_in, heads, head_dim]
            ws.append(np.ascontiguousarray(k.reshape(k.shape[0], -1).T))  # [H, H_in]
            bs.append(leaf(attn + (proj, "bias")).reshape(-1))
        out[f"{t}.attn.in_proj_weight"] = np.concatenate(ws, axis=0)
        out[f"{t}.attn.in_proj_bias"] = np.concatenate(bs, axis=0)
        ok = leaf(attn + ("out", "kernel"))  # [heads, head_dim, H]
        out[f"{t}.attn.out_proj.weight"] = np.ascontiguousarray(ok.reshape(-1, ok.shape[-1]).T)
        out[f"{t}.attn.out_proj.bias"] = leaf(attn + ("out", "bias"))
    return out
