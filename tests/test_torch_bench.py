"""The port's bench (``neusky_torch/bench.py``) on the CPU at tiny width:
``bench.build`` with the tiny recipe's model (``tiny_model_config(8, 2)``)
in place of the canonical one, and otherwise what ``bench.py:85-118``
builds.  Its rays a step are JAX's count (``neusky_tpu`` ``Trainer._count_
rays`` and bench's own sum: 8 × 128 scene + 8 × 128 DDF-fit + 256 sky =
2,304); the fused and the split step give equal losses (1e-6 relative) on
one batch from the same params and draws; ``NEUSKY_BENCH_SPLIT`` and
``NEUSKY_BENCH_NATIVE`` choose as ``bench.py:107`` and ``:119`` do; and the
bench itself refuses to run without a card."""

import os
import types

import pytest
import torch

from neusky_tpu.configs.tiny_config import tiny_model_config as j_tiny_model_config
from neusky_tpu.engine.trainer import Trainer as JTrainer
from neusky_tpu.models.pipeline import PipelineConfig as JPipelineConfig
from neusky_tpu.sampling.ddf_sampler import DDFSamplerConfig as JDDFSamplerConfig

from neusky_torch import bench
from neusky_torch.configs.tiny_config import tiny_model_config
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def no_bench_env(monkeypatch):
    for name in ("NEUSKY_BENCH_SPLIT", "NEUSKY_BENCH_NATIVE"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _build():
    return bench.build("cpu", tiny_model_config(8, 2))


def test_rays_per_step_is_jaxs_count(no_bench_env):
    b = _build()
    batch = b.datamanager.next_train(1)
    j_pipe = JPipelineConfig(visibility_train_sampler=JDDFSamplerConfig(
        num_samples_on_sphere=8, num_rays_per_sample=128, only_sample_upper_hemisphere=True, concentration=20.0),
        num_sky_rays=256)
    j_cfg = j_tiny_model_config(8, 2)
    jax_side = types.SimpleNamespace(model=types.SimpleNamespace(config=j_cfg, ddf=j_cfg.ddf), pipeline_config=j_pipe)
    s = j_pipe.visibility_train_sampler
    bench_py_sum = batch["pixel_coords"].shape[0] + s.num_samples_on_sphere * s.num_rays_per_sample + batch[
        "sky_cam_idx"].shape[0]  # bench.py:137-150
    assert b.rays_per_step == JTrainer._count_rays(jax_side, batch) == bench_py_sum == 2304
    assert b.pipeline == bench.pipeline() and b.config == tiny_model_config(8, 2)


def test_fused_and_split_steps_give_equal_losses(no_bench_env):
    fused = _build()
    no_bench_env.setenv("NEUSKY_BENCH_SPLIT", "1")
    split = _build()
    batches = [b.datamanager.next_train(1) for b in (fused, split)]
    for k, v in batches[0].items():
        if torch.is_tensor(v):
            assert torch.equal(v, batches[1][k]), k
    out = [b.step(b.params, batch, 1.0, generator=b.generator) for b, batch in zip((fused, split), batches)]
    assert torch.isfinite(out[0]["total_loss"])
    torch.testing.assert_close(out[1]["total_loss"], out[0]["total_loss"], rtol=1e-6, atol=0)
    for k, v in out[0]["loss_dict"].items():
        torch.testing.assert_close(out[1]["loss_dict"][k], v, rtol=1e-6, atol=1e-9, msg=k)


# bench.py:119 (`if os.environ.get("NEUSKY_BENCH_SPLIT", "")`) and :107
# (`os.environ.get("NEUSKY_BENCH_NATIVE", "1") not in ("0", "", "false")`)
@pytest.mark.parametrize("split, want_split", [(None, False), ("", False), ("1", True), ("0", True)])
@pytest.mark.parametrize("native, want_native", [(None, True), ("1", True), ("0", False), ("", False),
                                                 ("false", False), ("no", True)])
def test_bench_knobs_choose_as_jaxs(no_bench_env, split, want_split, native, want_native):
    for name, value in (("NEUSKY_BENCH_SPLIT", split), ("NEUSKY_BENCH_NATIVE", native)):
        if value is not None:
            no_bench_env.setenv(name, value)
    b = _build()
    assert b.step.__qualname__.split(".")[0] == ("make_train_step_split" if want_split else "make_train_step")
    assert (b.datamanager._native is not None) == want_native


def test_bench_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("NEUSKY_BF16_MAPPING", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    assert "NEUSKY_BF16_MAPPING" not in os.environ  # refused before its default was set
