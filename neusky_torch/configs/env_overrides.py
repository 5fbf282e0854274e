"""Environment-variable A/B knobs (mirror of
``neusky_tpu/configs/env_overrides.py``): the same ``NEUSKY_*`` names reach
the same config fields, so a run of the port and a run of the JAX package
built from one environment train one configuration.

- ``NEUSKY_BENCH_BF16=1``: bf16 products in the SDF geometry and colour
  MLPs (float32 parameters and accumulation).
- ``NEUSKY_VIS_CHUNK=<n>``: visibility query chunk size.
- ``NEUSKY_EXACT_PROPOSAL_FWD=1``: exact 8-corner proposal forward.
- ``NEUSKY_EXACT_TABLE_GRADS=1``: exact 8-corner SDF table gradients.
- ``NEUSKY_STOCH_DXT={0,1}``: one sampled corner for the position
  cotangent of the level-set encode's backward.
- ``NEUSKY_BF16_MAPPING={0,1}``: the FiLM mapping network in bf16 (its
  products and its (frequencies, phases) outputs; the sine stays float32).
- ``NEUSKY_FILM_HEADS={0,1}``: one (frequency, phase) head per FiLM layer.
- ``NEUSKY_VECTORIZED={0,1}``: recorded and set; no effect in the port
  (``HashGridConfig.vectorized``).
- ``NEUSKY_PROP_LEVELS=<n>`` / ``NEUSKY_PROP_LOG2=<n>``: the proposal
  fields' hash grids (levels / table size).
- ``NEUSKY_DDF_ENCODING={nerf,hash}``: the DDF position encoding.
- ``NEUSKY_BF16_TABLES={0,1}``: gather hash-table corners through bf16.
- ``NEUSKY_VIS_REMAT={full,dots}``: the visibility chunks' recompute
  policy (``dots`` keeps the matrix products for the backward).
- ``NEUSKY_FUSED_GT={0,1}``: one proposal and field pass over the scene
  rays and the DDF ground-truth rays together
  (``NeuSkyModel.forward_with_ddf_gt``).
- ``NEUSKY_DDF_HASH_LEVELS=<n>`` / ``NEUSKY_DDF_HASH_LOG2=<n>``: the DDF
  hash grid (read with ``NEUSKY_DDF_ENCODING=hash``).

A value of ``0``, ``false``, ``off`` or ``no`` turns a ``{0,1}`` knob off;
an empty or unset variable leaves the field as the config has it.
"""

from __future__ import annotations

import dataclasses
import os

_OFF = ("0", "false", "off", "no")


def _on(name: str) -> bool:
    return os.environ[name].strip().lower() not in _OFF


def apply_env_knobs(cfg):
    """Return ``cfg`` (a ``NeuSkyModelConfig``) with any set ``NEUSKY_*``
    knob applied."""
    env = os.environ.get
    if env("NEUSKY_BENCH_BF16", ""):
        cfg = dataclasses.replace(cfg, sdf_field=dataclasses.replace(cfg.sdf_field, use_bf16_compute=True))
    if env("NEUSKY_VIS_CHUNK", ""):
        cfg = dataclasses.replace(cfg, visibility_query_chunk=int(os.environ["NEUSKY_VIS_CHUNK"]))
    if env("NEUSKY_EXACT_PROPOSAL_FWD", ""):
        cfg = dataclasses.replace(cfg, proposal_fields=tuple(
            dataclasses.replace(p, stochastic_forward=False) for p in cfg.proposal_fields))
    for name, key in (("NEUSKY_PROP_LEVELS", "num_levels"), ("NEUSKY_PROP_LOG2", "log2_hashmap_size")):
        if env(name, ""):
            n = int(os.environ[name])
            cfg = dataclasses.replace(cfg, proposal_fields=tuple(
                dataclasses.replace(p, hash=dataclasses.replace(p.hash, **{key: n})) for p in cfg.proposal_fields))
    if env("NEUSKY_EXACT_TABLE_GRADS", ""):
        cfg = dataclasses.replace(cfg, sdf_field=dataclasses.replace(cfg.sdf_field, stochastic_table_grads=False))
    if env("NEUSKY_BF16_MAPPING", "") != "":
        cfg = _replace_ddf_field(cfg, use_bf16_mapping=_on("NEUSKY_BF16_MAPPING"))
    if env("NEUSKY_FILM_HEADS", "") != "":
        cfg = _replace_ddf_field(cfg, film_per_layer_heads=_on("NEUSKY_FILM_HEADS"))
    if env("NEUSKY_STOCH_DXT", "") != "":
        cfg = dataclasses.replace(
            cfg, sdf_field=dataclasses.replace(cfg.sdf_field, stochastic_dxt=_on("NEUSKY_STOCH_DXT")))
    if env("NEUSKY_VIS_REMAT", ""):
        cfg = dataclasses.replace(cfg, visibility_remat_policy=os.environ["NEUSKY_VIS_REMAT"])
    if env("NEUSKY_FUSED_GT", "") != "":
        cfg = dataclasses.replace(cfg, fused_ddf_gt_pass=_on("NEUSKY_FUSED_GT"))
    if env("NEUSKY_DDF_HASH_LEVELS", "") or env("NEUSKY_DDF_HASH_LOG2", ""):
        h = cfg.ddf.field.hash
        if env("NEUSKY_DDF_HASH_LEVELS", ""):
            h = dataclasses.replace(h, num_levels=int(os.environ["NEUSKY_DDF_HASH_LEVELS"]))
        if env("NEUSKY_DDF_HASH_LOG2", ""):
            h = dataclasses.replace(h, log2_hashmap_size=int(os.environ["NEUSKY_DDF_HASH_LOG2"]))
        cfg = _replace_ddf_field(cfg, hash=h)
    if env("NEUSKY_DDF_ENCODING", ""):
        cfg = _replace_ddf_field(cfg, position_encoding_type=os.environ["NEUSKY_DDF_ENCODING"])
    if env("NEUSKY_VECTORIZED", "") != "":
        cfg = _set_all_hashgrids(cfg, vectorized=_on("NEUSKY_VECTORIZED"))
    if env("NEUSKY_BF16_TABLES", "") != "":
        cfg = _set_all_hashgrids(cfg, bf16_gather=_on("NEUSKY_BF16_TABLES"))
    return cfg


def _replace_ddf_field(cfg, **updates):
    return dataclasses.replace(cfg, ddf=dataclasses.replace(
        cfg.ddf, field=dataclasses.replace(cfg.ddf.field, **updates)))


def _set_all_hashgrids(cfg, **updates):
    """Replace fields of every ``HashGridConfig`` anywhere in the config
    tree."""
    from neusky_torch.ops.hashgrid import HashGridConfig

    def walk(node):
        if isinstance(node, HashGridConfig):
            return dataclasses.replace(node, **updates)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name)) for f in dataclasses.fields(node)
                if dataclasses.is_dataclass(getattr(node, f.name)) or isinstance(getattr(node, f.name), tuple)
            })
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node

    return walk(cfg)


KNOBS = (
    "NEUSKY_BENCH_BF16", "NEUSKY_VIS_CHUNK", "NEUSKY_EXACT_PROPOSAL_FWD", "NEUSKY_EXACT_TABLE_GRADS",
    "NEUSKY_STOCH_DXT", "NEUSKY_BF16_MAPPING", "NEUSKY_FILM_HEADS", "NEUSKY_PROP_LEVELS", "NEUSKY_PROP_LOG2",
    "NEUSKY_VECTORIZED", "NEUSKY_DDF_ENCODING", "NEUSKY_BF16_TABLES", "NEUSKY_DDF_HASH_LEVELS",
    "NEUSKY_DDF_HASH_LOG2", "NEUSKY_FUSED_GT", "NEUSKY_VIS_REMAT",
)


def knob_summary() -> dict:
    """The knobs that are set, for a result's JSON line."""
    return {k: os.environ[k] for k in KNOBS if os.environ.get(k, "") != ""}


def effective_summary(cfg) -> dict:
    """The resolved values of the knob-controlled settings, for a result's
    JSON line (an unset knob then still says what ran)."""
    return {
        "sdf_bf16_compute": bool(cfg.sdf_field.use_bf16_compute),
        "ddf_bf16_compute": bool(cfg.ddf.field.use_bf16_compute),
        "ddf_bf16_mapping": bool(cfg.ddf.field.use_bf16_mapping),
        "ddf_film_per_layer_heads": bool(cfg.ddf.field.film_per_layer_heads),
        "visibility_query_chunk": int(cfg.visibility_query_chunk),
        "proposal_stochastic_forward": [bool(p.stochastic_forward) for p in cfg.proposal_fields],
        "sdf_stochastic_table_grads": bool(cfg.sdf_field.stochastic_table_grads),
        "sdf_stochastic_dxt": bool(cfg.sdf_field.stochastic_dxt),
        "ddf_position_encoding": cfg.ddf.field.position_encoding_type,
        "ddf_hash_levels": cfg.ddf.field.hash.num_levels,
        "ddf_hash_log2": cfg.ddf.field.hash.log2_hashmap_size,
        "sdf_hash_vectorized": bool(cfg.sdf_field.hash.vectorized),
        "hash_bf16_gather": bool(cfg.sdf_field.hash.bf16_gather),
        "fused_ddf_gt_pass": bool(cfg.fused_ddf_gt_pass),
        "visibility_remat_policy": cfg.visibility_remat_policy,
        "proposal_hash_levels": [p.hash.num_levels for p in cfg.proposal_fields],
        "proposal_hash_log2": [p.hash.log2_hashmap_size for p in cfg.proposal_fields],
    }
