"""The port's standalone DDF trainer against the JAX package, on the CPU,
and ``cli train ddf`` end to end.

The scene is JAX's tiny recipe (``neusky-tiny``: 2×32 FiLM-SIREN DDF on NeRF
encodings, its FiLM inputs in float32: with the recipe's bf16 rounding,
inputs an ulp apart round to neighbouring bf16 values, which
``test_torch_joint_slice.py`` holds) with JAX's initial params, on the synthetic scene (6 cameras,
16×16; its sky pixels feed the sky-ray loss).  Each step takes 2 × 16 vMF
rays at κ = 20 and 8 sky rays; JAX's vMF and multi-view draws are fed to
the port, and both datamanagers draw the same sky pixels.

Tolerances: each step's losses and depth PSNR to 1e-4 relative; Adam's
first and second moments after 20 steps (running averages of the
gradients) to 1e-3 of each leaf's largest entry; the DDF's movement to
1e-3 of each leaf's largest movement plus one float32 ulp of the entry a
step (the cosine schedule warms up over 500 steps, so the moves are ~3e-5,
and each update rounds a leaf near 1 to ~1.2e-7); depth images to 1e-4
relative.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from neusky_tpu.configs.tiny_config import tiny_model_config as j_tiny
from neusky_tpu.data.datamanager import DataManager as JDM, DataManagerConfig as JDMConfig
from neusky_tpu.data.pixel_sampler import PixelSamplerConfig as JPS
from neusky_tpu.data.synthetic import SyntheticSceneConfig as JScene, generate_synthetic_scene as j_scene
from neusky_tpu.engine import ddf_trainer as j_ddf
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.sampling.ddf_sampler import DDFSamplerConfig as JSampler

from neusky_torch import cli as t_cli
from neusky_torch.data.datamanager import DataManager as TDM, DataManagerConfig as TDMConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig as TPS
from neusky_torch.data.synthetic import SyntheticSceneConfig as TScene, generate_synthetic_scene as t_scene
from neusky_torch.engine import ddf_trainer as t_ddf
from neusky_torch.engine.checkpoint import STATE_FILE
from neusky_torch.models.neusky import NeuSkyModel as TModel
from neusky_torch.ops import hashgrid
from neusky_torch.tree import tree_items
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture)
    flat_jax, jax_sphere_uniforms, jax_to_torch_params, jax_vmf_draws, max_rel_err, one_torch_thread,
    to_torch_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCENE = dict(num_cameras=6, width=16, height=16)
SAMPLER = dict(num_samples_on_sphere=2, num_rays_per_sample=16, only_sample_upper_hemisphere=True, concentration=20.0)
STEPS = 20


def _jax_step_draws(rng, sampler, steps):
    """The draws of ``steps`` steps of ``neusky_tpu`` ``DDFTrainer.run``
    from its key: per step ``rng, k = split(rng)``, ``split(k, 3)`` =
    (k_sample, k_gt, k_ddf); the vMF rays from k_sample, the multi-view
    sphere points from ``split(k_ddf)[0]`` (the GT pass draws nothing with
    its gradients stopped)."""
    n = sampler.num_samples_on_sphere * sampler.num_rays_per_sample
    out = []
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        k_sample, _, k_ddf = jax.random.split(k, 3)
        out.append({"vmf": jax_vmf_draws(k_sample, sampler),
                    "multi_view_u": jax_sphere_uniforms(jax.random.split(k_ddf)[0], n)})
    return out


@pytest.fixture(scope="module")
def pair():
    cfg_j = j_tiny(6, 2)
    cfg_j = dataclasses.replace(cfg_j, ddf=dataclasses.replace(
        cfg_j.ddf, field=dataclasses.replace(cfg_j.ddf.field, use_bf16_compute=False)))
    jm, tm = JModel(cfg_j), TModel(to_torch_config(cfg_j), device="cpu")
    params_j = jax.jit(jm.init)(jax.random.PRNGKey(0))
    js, ts = j_scene(JScene(**SCENE)), t_scene(TScene(**SCENE))
    jdm = JDM(JDMConfig(pixel_sampler=JPS(2, 16)), js["cameras"], js["images"], js["masks"])
    tdm = TDM(TDMConfig(pixel_sampler=TPS(2, 16)), ts["cameras"], ts["images"], ts["masks"], device="cpu")
    kw = dict(max_num_iterations=STEPS, steps_per_log=1, num_sky_rays=8)
    jt = j_ddf.DDFTrainer(j_ddf.DDFTrainerConfig(sampler=JSampler(**SAMPLER), **kw), jm, params_j, datamanager=jdm)
    params_t = jax_to_torch_params(params_j)
    frozen = {k: v.clone() for k, v in tree_items(params_t)}
    tt = t_ddf.DDFTrainer(t_ddf.DDFTrainerConfig(sampler=to_torch_config(JSampler(**SAMPLER)), **kw), tm, params_t,
                          datamanager=tdm)
    draws = _jax_step_draws(jt.rng, jt.config.sampler, STEPS)
    return dict(jt=jt, tt=tt, params_t=params_t, frozen=frozen, draws=draws, start=flat_jax(params_j["ddf_field"]))


def test_ddf_trainer_steps_match_jax(pair, monkeypatch):
    """20 steps on the same draws: every step's record, the DDF's movement;
    the scene params untouched and no hash-table gradient scattered."""
    jt, tt = pair["jt"], pair["tt"]
    calls = []
    dispatch = hashgrid.scatter_levels
    monkeypatch.setattr(hashgrid, "scatter_levels", lambda r, v, t: calls.append(r.shape) or dispatch(r, v, t))
    hist_j = jt.run()
    hist_t = tt.run(draws=pair["draws"])
    assert calls == [] and [r["step"] for r in hist_t] == [r["step"] for r in hist_j] == list(range(1, STEPS + 1))
    for rt, rj in zip(hist_t, hist_j):
        assert sorted(rt) == sorted(rj) == sorted(
            ["step", "total_loss", "depth_psnr", "depth_l1_loss", "sdf_l2_loss", "multi_view_loss", "sky_ray_loss"])
        for k in rj:
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, err_msg=f"step {rj['step']} {k}")
    start, want = pair["start"], flat_jax(jt.ddf_params)
    for k, v in tree_items(tt.ddf_params):
        moved_j = want[k].astype(np.float64) - start[k]
        moved_t = v.detach().numpy().astype(np.float64) - start[k]
        assert np.abs(moved_j).max() > 0, k
        ulp = np.spacing(np.maximum(np.abs(want[k]), np.abs(start[k]))).astype(np.float64)
        excess = np.abs(moved_t - moved_j) - (1e-3 * np.abs(moved_j).max() + STEPS * ulp)
        assert excess.max() <= 0, (k, excess.max())
    # Adam's moments: the gradients' running averages, free of the leaves' rounding
    adam_j = jt.opt_state.inner_states["ddf_field"].inner_state[0]
    mu_j, nu_j = flat_jax(adam_j.mu["ddf_field"]), flat_jax(adam_j.nu["ddf_field"])
    state_t = tt.optimizer.optimizer.state
    for k, v in tree_items(tt.ddf_params):
        for name, want_m in (("exp_avg", mu_j[k]), ("exp_avg_sq", nu_j[k])):
            err = max_rel_err(state_t[v][name].numpy(), want_m)
            assert err < 1e-3, (k, name, err)
    assert all(torch.equal(pair["frozen"][k], v) for k, v in tree_items(pair["params_t"]))
    assert all(not v.requires_grad for _, v in tree_items(tt.frozen_scene))

    images_j = jt.render_eval_depth_images(num_views=3, width=8, height=6)
    images_t = tt.render_eval_depth_images(num_views=3, width=8, height=6)
    assert images_t.shape == images_j.shape == (3, 6, 8)
    assert max_rel_err(images_t, images_j) < 1e-4


def test_cli_train_ddf_synthetic_demo(tmp_path, capsys):
    """``train neusky-tiny --synthetic-demo`` for one step, then ``train ddf
    --synthetic-demo`` from it for 2 (the ddf recipe's 8 × 128 vMF rays):
    one log line, a checkpoint at step 2 in which only ``ddf_field``
    moved; without ``--load-dir`` it exits."""
    run, out = tmp_path / "run", tmp_path / "ddf"
    common = ["--synthetic-demo", "--device", "cpu", "--rays-per-batch", "64"]
    t_cli.main(["train", "neusky-tiny", *common, "--max-iterations", "1", "--output-dir", str(run)])
    capsys.readouterr()
    t_cli.main(["train", "ddf", *common, "--max-iterations", "2", "--load-dir", str(run), "--output-dir", str(out)])
    logs = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(logs) == 1 and logs[0]["step"] == 2 and all(np.isfinite(v) for v in logs[0].values())
    assert json.loads((out / "latest.json").read_text()) == {"step": 2}
    before = dict(tree_items(torch.load(run / "checkpoints" / "step-000000001" / STATE_FILE, weights_only=True)["params"]))
    after = dict(tree_items(torch.load(out / "checkpoints" / "step-000000002" / STATE_FILE, weights_only=True)["params"]))
    assert sorted(after) == sorted(before)
    moved = {k.split("/")[0] for k in after if not torch.equal(after[k], before[k])}
    assert moved == {"ddf_field"}
    with pytest.raises(SystemExit, match="--load-dir"):
        t_cli.main(["train", "ddf", *common])
