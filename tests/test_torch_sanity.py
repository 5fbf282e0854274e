"""``neusky_torch/tools/train_sanity.py --tiny`` against the loss curve of
JAX's ``tools/train_sanity.py --tiny`` on the CPU: 3 steps of the tiny
recipe on the 16 px synthetic scene (8 images × 128 rays, 8 × 128 vMF rays,
256 sky rays a step), from the same converted parameters, on the same
batches, with JAX's draws of every step fed to the port.

The JAX tool is a script of the JAX package and stays unedited: the test
builds what it builds (``apply_env_knobs(tiny_model_config(8, 2))``, the
scene, the data manager, ``PRNGKey(0)`` params, the five Adam groups for
steps + 1, the key stream ``fold_in(PRNGKey(1), 0)`` split once a step)
and runs its jitted step; the port runs through ``build_run`` and
``run_sanity``, the tool's own loop.

Tolerance: the total loss and the batch PSNR of each step to 1e-4
relative, the one-step tests' bound (``tests/test_torch_cli_step.py``;
reached: ~1e-6).  The tool's DDF rounds its FiLM inputs to bfloat16 and
the Adam updates carry any difference into the next steps, so the bound is
held at every step, not only the first.
"""

import json

import jax
import numpy as np
import pytest
import torch

from neusky_tpu.configs.env_overrides import apply_env_knobs as j_knobs
from neusky_tpu.configs.tiny_config import tiny_model_config as j_tiny
from neusky_tpu.data.datamanager import DataManager as JDataManager, DataManagerConfig as JDMConfig
from neusky_tpu.data.pixel_sampler import PixelSamplerConfig as JPSConfig
from neusky_tpu.data.synthetic import SyntheticSceneConfig as JSceneConfig, generate_synthetic_scene as j_scene
from neusky_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from neusky_tpu.engine.optimizers import default_neusky_optimizer_groups as j_groups
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.models.pipeline import PipelineConfig as JPipe
from neusky_tpu.parallel.mesh import make_train_step as j_make_train_step
from neusky_tpu.sampling.ddf_sampler import DDFSamplerConfig as JDDFSampler

from neusky_torch.tools import train_sanity
from neusky_torch.tree import tree_items
from torch_parity import flat_jax, jax_ddf_draws, jax_scene_draws, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS = 3
RTOL = 1e-4
RECORD_KEYS = {"step", "ddf_encoding", "psnr", "psnr_fg", "ddf_depth_psnr", "total_loss", "s_val", "elapsed_s",
               "sky_pixel_loss", "rgb_l1_loss", "fg_mask_loss", "eikonal_loss"}


@pytest.fixture(scope="module")
def jax_curve():
    """JAX's tool, step for step: (config, params before the first step,
    the key of each step, the total loss and PSNR of each step)."""
    cfg = j_knobs(j_tiny(num_train_data=8, num_eval_data=2))
    model = JModel(cfg)
    pipe = JPipe(visibility_train_sampler=JDDFSampler(num_samples_on_sphere=8, num_rays_per_sample=128,
                                                      only_sample_upper_hemisphere=True, concentration=20.0),
                 num_sky_rays=256)
    scene = j_scene(JSceneConfig(num_cameras=8, width=16, height=16))
    dm = JDataManager(JDMConfig(pixel_sampler=JPSConfig(images_per_batch=8, rays_per_image=128), num_sky_rays=256),
                      scene["cameras"], scene["images"], scene["masks"])
    params = jax.jit(model.init)(jax.random.PRNGKey(0))  # jitted: eagerly the init goes op by op
    start = flat_jax(params)
    optimizer = j_build_optimizer(params, j_groups(STEPS + 1))
    opt_state = optimizer.init(params)
    step_fn = j_make_train_step(model, pipe, optimizer)
    rng = jax.random.fold_in(jax.random.PRNGKey(1), 0)
    keys, curve = [], []
    for i in range(STEPS):
        batch = dm.next_train(i)
        rng, k = jax.random.split(rng)
        keys.append(k)
        params, opt_state, aux = step_fn(params, opt_state, batch, k, np.float32(i))
        curve.append((float(aux["total_loss"]), float(aux["metrics"]["psnr"])))
    return cfg, pipe, start, keys, curve


def test_train_sanity_tiny_curve_matches_jax(jax_curve, capsys):
    cfg, pipe, start, keys, curve = jax_curve
    run = train_sanity.build_run(train_sanity.parse_args([str(STEPS), "1", "--tiny", "--device", "cpu"]))
    with torch.no_grad():
        for k, t in tree_items(run.params):
            t.copy_(torch.from_numpy(np.array(start[k])))

    def draws(i):
        d = jax_scene_draws(cfg, keys[i], 8 * 128)
        d["ddf"] = jax_ddf_draws(cfg, pipe, keys[i])
        return d

    got = []
    assert train_sanity.run_sanity(run, draws, lambda i, aux: got.append(
        (float(aux["total_loss"]), float(aux["metrics"]["psnr"])))) == 0
    assert len(got) == STEPS
    for i, ((loss_t, psnr_t), (loss_j, psnr_j)) in enumerate(zip(got, curve)):
        np.testing.assert_allclose([loss_t, psnr_t], [loss_j, psnr_j], rtol=RTOL, err_msg=f"step {i + 1}")
    assert curve[-1][0] != curve[0][0]  # the params moved
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert set(lines[0]) == {"env_knobs", "effective"} and lines[0]["env_knobs"] == {}
    records = lines[1:]
    assert [r["step"] for r in records] == [1, 2, 3] and all(set(r) == RECORD_KEYS for r in records)
    for r, (loss, psnr) in zip(records, got):
        assert r["total_loss"] == round(loss, 4) and r["psnr"] == round(psnr, 3)


def test_train_sanity_segment_and_resume(tmp_path, capsys):
    """``--segment-steps 1`` stops after step 1 with its checkpoint (exit
    code 3, JAX's); ``--resume`` goes on from it to the end: the
    checkpoint of step 2, the batch stream moved to the resume step."""
    argv = ["2", "1", "--tiny", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")]
    assert train_sanity.main(argv + ["--segment-steps", "1"]) == 3
    assert json.loads((tmp_path / "ckpt" / "latest.json").read_text()) == {"step": 1}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"segment_done_at": 1}
    run = train_sanity.build_run(train_sanity.parse_args(argv + ["--resume"]))
    assert run.start == 1 and run.optimizer.count == 1
    assert train_sanity.run_sanity(run) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert {"resumed_from": 1} in lines and lines[-1] == {"ckpt": str(tmp_path / "ckpt"), "step": 2}
    assert [r["step"] for r in lines if "total_loss" in r] == [2]
