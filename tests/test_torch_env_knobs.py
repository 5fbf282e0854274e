"""The port's ``NEUSKY_*`` knobs (``neusky_torch/configs/env_overrides.py``)
against the JAX package's (``neusky_tpu/configs/env_overrides.py``): each
knob reaches its port field (mirror of ``tests/test_env_knobs.py``), the
port's config and ``effective_summary`` equal JAX's for the same
environment, and with each knob set alone the canonical config builds a
model and the tiny recipe takes a training step on the CPU."""

import dataclasses
import os
from unittest import mock

import numpy as np
import pytest

from neusky_tpu.configs import env_overrides as j_env
from neusky_tpu.configs.neusky_config import neusky_model_config as j_neusky_model_config

from neusky_torch.configs import env_overrides as t_env
from neusky_torch.configs.neusky_config import neusky_model_config
from neusky_torch.configs.tiny_config import tiny_model_config
from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine.trainer import Trainer, TrainerConfig
from neusky_torch.models.neusky import NeuSkyModel
from neusky_torch.models.pipeline import PipelineConfig
from neusky_torch.sampling.ddf_sampler import DDFSamplerConfig
from torch_parity import one_torch_thread, to_torch_config  # noqa: F401 (one_torch_thread: the fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# a value of each knob that changes the canonical config
KNOB_VALUES = {
    "NEUSKY_BENCH_BF16": "1",
    "NEUSKY_VIS_CHUNK": "512",
    "NEUSKY_EXACT_PROPOSAL_FWD": "1",
    "NEUSKY_EXACT_TABLE_GRADS": "1",
    "NEUSKY_STOCH_DXT": "1",
    "NEUSKY_BF16_MAPPING": "1",
    "NEUSKY_FILM_HEADS": "1",
    "NEUSKY_PROP_LEVELS": "3",
    "NEUSKY_PROP_LOG2": "12",
    "NEUSKY_VECTORIZED": "1",
    "NEUSKY_DDF_ENCODING": "hash",
    "NEUSKY_BF16_TABLES": "1",
    "NEUSKY_DDF_HASH_LEVELS": "4",
    "NEUSKY_DDF_HASH_LOG2": "12",
    "NEUSKY_FUSED_GT": "1",
    "NEUSKY_VIS_REMAT": "dots",
}
CLEAN = {k: "" for k in KNOB_VALUES}


def _env(**knobs):
    return mock.patch.dict(os.environ, {**CLEAN, **knobs})


def _cfg(**knobs):
    with _env(**knobs):
        return t_env.apply_env_knobs(neusky_model_config(num_train_data=8, num_eval_data=2))


def test_the_port_has_jax_s_sixteen_knobs():
    with _env(**KNOB_VALUES):
        assert t_env.knob_summary() == j_env.knob_summary() == KNOB_VALUES
    assert len(t_env.KNOBS) == 16


def test_defaults_untouched():
    assert _cfg() == neusky_model_config(num_train_data=8, num_eval_data=2)
    with _env():
        assert t_env.knob_summary() == {}


def test_each_knob_reaches_its_field():
    assert _cfg(NEUSKY_BENCH_BF16="1").sdf_field.use_bf16_compute
    assert _cfg(NEUSKY_VIS_CHUNK="65536").visibility_query_chunk == 65536
    assert all(not p.stochastic_forward for p in _cfg(NEUSKY_EXACT_PROPOSAL_FWD="1").proposal_fields)
    assert not _cfg(NEUSKY_EXACT_TABLE_GRADS="1").sdf_field.stochastic_table_grads
    assert _cfg(NEUSKY_STOCH_DXT="1").sdf_field.stochastic_dxt
    assert not _cfg(NEUSKY_STOCH_DXT="0").sdf_field.stochastic_dxt
    assert _cfg(NEUSKY_BF16_MAPPING="1").ddf.field.use_bf16_mapping
    assert not _cfg(NEUSKY_BF16_MAPPING="off").ddf.field.use_bf16_mapping
    assert _cfg(NEUSKY_FILM_HEADS="yes").ddf.field.film_per_layer_heads
    assert all(p.hash.num_levels == 3 for p in _cfg(NEUSKY_PROP_LEVELS="3").proposal_fields)
    assert all(p.hash.log2_hashmap_size == 12 for p in _cfg(NEUSKY_PROP_LOG2="12").proposal_fields)
    vec = _cfg(NEUSKY_VECTORIZED="1")
    assert vec.sdf_field.hash.vectorized and all(p.hash.vectorized for p in vec.proposal_fields)
    bft = _cfg(NEUSKY_BF16_TABLES="1")
    assert bft.sdf_field.hash.bf16_gather and all(p.hash.bf16_gather for p in bft.proposal_fields)
    assert bft.ddf.field.hash.bf16_gather
    assert not _cfg(NEUSKY_BF16_TABLES="0").sdf_field.hash.bf16_gather
    assert _cfg(NEUSKY_VIS_REMAT="dots").visibility_remat_policy == "dots"
    assert _cfg(NEUSKY_FUSED_GT="1").fused_ddf_gt_pass
    assert not _cfg(NEUSKY_FUSED_GT="false").fused_ddf_gt_pass
    assert _cfg(NEUSKY_DDF_ENCODING="hash").ddf.field.position_encoding_type == "hash"
    dh = _cfg(NEUSKY_DDF_HASH_LEVELS="8", NEUSKY_DDF_HASH_LOG2="15")
    assert dh.ddf.field.hash.num_levels == 8 and dh.ddf.field.hash.log2_hashmap_size == 15
    assert dh.sdf_field.hash.num_levels == 16  # only the DDF grid changes


ENVS = {**{k: {k: v} for k, v in KNOB_VALUES.items()}, "all": KNOB_VALUES,
        "all_off": {k: "0" for k in ("NEUSKY_STOCH_DXT", "NEUSKY_BF16_MAPPING", "NEUSKY_FILM_HEADS",
                                     "NEUSKY_VECTORIZED", "NEUSKY_BF16_TABLES", "NEUSKY_FUSED_GT")}}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_port_config_and_effective_summary_equal_jax(name):
    """For the same environment the port's config is JAX's, field for
    field, and so is ``effective_summary``."""
    with _env(**ENVS[name]):
        want = j_env.apply_env_knobs(j_neusky_model_config(num_train_data=8, num_eval_data=2))
        got = t_env.apply_env_knobs(neusky_model_config(num_train_data=8, num_eval_data=2))
    assert got == to_torch_config(want)
    assert t_env.effective_summary(got) == j_env.effective_summary(want)


@pytest.mark.parametrize("knob", sorted(KNOB_VALUES))
def test_each_knob_alone_builds_the_canonical_model(knob):
    model = NeuSkyModel(_cfg(**{knob: KNOB_VALUES[knob]}), device="cpu")
    assert model.ddf is not None


@pytest.fixture(scope="module")
def tiny_scene():
    return generate_synthetic_scene(SyntheticSceneConfig(num_cameras=6, width=24, height=24))


@pytest.mark.parametrize("knob", sorted(KNOB_VALUES))
def test_each_knob_alone_takes_a_tiny_cpu_step(knob, tiny_scene):
    """The tiny recipe with the knob: one ``Trainer`` step, every loss
    finite, the DDF's terms in the record."""
    with _env(**{knob: KNOB_VALUES[knob]}):
        cfg = t_env.apply_env_knobs(tiny_model_config())
    assert cfg != tiny_model_config()
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(4, 32), num_sky_rays=32),
                     tiny_scene["cameras"], tiny_scene["images"], tiny_scene["masks"], device="cpu")
    pipe = PipelineConfig(visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=2, num_rays_per_sample=16),
                          num_sky_rays=32)
    trainer = Trainer(TrainerConfig(max_num_iterations=10, steps_per_log=1, seed=0),
                      NeuSkyModel(cfg, device="cpu"), pipe, dm, device="cpu")
    rec = trainer.run(1)[-1]
    assert all(np.isfinite(v) for v in rec.values()), rec
    assert "depth_l1_loss" in rec and "sdf_level_set_visibility_loss" in rec
    assert rec["step"] == 1


def test_set_all_hashgrids_walks_tuples_and_nested_configs():
    cfg = t_env._set_all_hashgrids(tiny_model_config(), bf16_gather=True)
    grids = [cfg.sdf_field.hash, cfg.ddf.field.hash, *(p.hash for p in cfg.proposal_fields)]
    assert all(g.bf16_gather for g in grids)
    assert dataclasses.replace(cfg.sdf_field, hash=tiny_model_config().sdf_field.hash) == tiny_model_config().sdf_field
