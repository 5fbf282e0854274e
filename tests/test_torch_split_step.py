"""The port's split step (``parallel/mesh.py::make_train_step_split``) on
the CPU: against JAX's ``make_train_step_split`` on the tiny joint
configuration of ``tests/test_train_e2e.py::test_split_step_matches_fused``
(the same converted parameters, batch and JAX draws), against the port's
fused step, and behind ``TrainerConfig.use_split_step``.

Tolerances: against JAX, the total loss to 1e-4 relative and the
parameters after the update to 1e-5 absolute (JAX's own bounds,
``tests/test_train_e2e.py:343-345``).  Adam's first update is ±lr·sign(g)
wherever |g| ≫ eps, so an entry whose gradient is within the parity
tests' gradient tolerance of zero (1e-3 of its array's scale,
``tests/test_torch_joint_slice.py``) may take the other sign; it is held
to 2·lr.  Against the port's fused step, which sums the same two
gradients in one backward pass: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.engine.optimizers import OptimizerGroupConfig as JGroup, build_optimizer
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.models.pipeline import PipelineConfig as JPipe
from neusky_tpu.parallel.mesh import make_train_step_split as j_split
from neusky_tpu.sampling.ddf_sampler import DDFSamplerConfig

from neusky_torch.convert import convert_params
from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine.optimizers import GroupedAdam, OptimizerGroupConfig as TGroup
from neusky_torch.engine.trainer import Trainer, TrainerConfig
from neusky_torch.models.neusky import NeuSkyModel as TModel
from neusky_torch.parallel import mesh as t_mesh
from neusky_torch.tree import tree_items
from test_torch_slice import make_batch_pair
from test_train_e2e import tiny_model_config
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture)
    flat_jax, jax_ddf_draws, jax_scene_draws, one_torch_thread, to_torch_config,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GROUPS = ("proposal_networks", "fields", "illumination_field", "visibility_sigmoid", "ddf_field")
LR = 1e-3
PIPE = JPipe(visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=2, num_rays_per_sample=16),
             num_sky_rays=32)
CFG = tiny_model_config(use_visibility=True, fit_visibility=True)


def _torch_groups():
    return {n: TGroup(lr=LR, schedule="constant", max_steps=10) for n in GROUPS}


def _draws(tb, rng):
    draws = jax_scene_draws(CFG, rng, tb["pixel_coords"].shape[0])
    draws["ddf"] = jax_ddf_draws(CFG, PIPE, rng)
    return draws


def _port_step(make_step, flat_params, tb, rng):
    """One port step from the converted parameters → (params, aux, grads)."""
    model = TModel(to_torch_config(CFG), device="cpu")
    params = convert_params(flat_params)
    opt = GroupedAdam(params, _torch_groups())
    aux = make_step(model, to_torch_config(PIPE), opt)(params, tb, 0.0, _draws(tb, rng))
    grads = {k: (None if v.grad is None else v.grad.clone()) for k, v in tree_items(params)}
    return {k: v.detach() for k, v in tree_items(params)}, aux, grads


@pytest.fixture(scope="module")
def steps():
    """JAX's split step (compiled once) and the port's split and fused
    steps, from the same parameters, batch and draws."""
    jb, tb = make_batch_pair()
    jm = JModel(CFG)
    params_j = jax.jit(jm.init)(jax.random.PRNGKey(0))
    opt = build_optimizer(params_j, {n: JGroup(lr=LR, schedule="constant", max_steps=10) for n in GROUPS})
    rng = jax.random.PRNGKey(7)
    flat = flat_jax(params_j)  # the JAX step donates its parameters
    new_j, _, aux_j = j_split(jm, PIPE, opt)(params_j, opt.init(params_j), jb, rng, jnp.asarray(0.0))
    split = _port_step(t_mesh.make_train_step_split, flat, tb, rng)
    fused = _port_step(t_mesh.make_train_step, flat, tb, rng)
    return dict(new_j=flat_jax(new_j), aux_j=aux_j, split=split, fused=fused)


def test_split_step_loss_matches_jax(steps):
    aux_j, aux_t = steps["aux_j"], steps["split"][1]
    np.testing.assert_allclose(float(aux_t["total_loss"]), float(aux_j["total_loss"]), rtol=1e-4)
    assert sorted(aux_t["loss_dict"]) == sorted(aux_j["loss_dict"])
    assert "depth_l1_loss" in aux_t["loss_dict"] and "sky_pixel_loss" in aux_t["loss_dict"]
    for k, v in aux_j["loss_dict"].items():
        np.testing.assert_allclose(float(aux_t["loss_dict"][k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    assert sorted(aux_t["metrics"]) == sorted(aux_j["metrics"])


def test_split_step_parameters_match_jax(steps):
    params_t, _, grads_t = steps["split"]
    new_j = steps["new_j"]
    assert sorted(params_t) == sorted(new_j)
    moved = 0
    for k, got in params_t.items():
        got, want = got.numpy(), new_j[k]
        g = grads_t[k]
        if g is None:
            np.testing.assert_array_equal(got, want, err_msg=k)
            continue
        g = np.abs(g.numpy())
        flip_ok = g <= 1e-3 * max(g.max(), 1e-30)
        bad = (np.abs(got - want) > 1e-5) & ~flip_ok
        assert not bad.any(), (k, np.abs(got - want)[bad].max())
        assert (np.abs(got - want) <= 2 * LR + 1e-5).all(), k
        moved += k.split("/")[0] in GROUPS
    assert moved > 0


def test_split_step_matches_the_fused_step(steps):
    """Two gradient passes summed in ``.grad`` equal one pass over the sum."""
    (ps, aux_s, gs), (pf, aux_f, gf) = steps["split"], steps["fused"]
    np.testing.assert_allclose(float(aux_s["total_loss"]), float(aux_f["total_loss"]), rtol=1e-6)
    assert sorted(aux_s["loss_dict"]) == sorted(aux_f["loss_dict"])
    for k in aux_f["loss_dict"]:
        np.testing.assert_allclose(float(aux_s["loss_dict"][k]), float(aux_f["loss_dict"][k]), rtol=1e-6, err_msg=k)
    for k, v in pf.items():
        assert (gs[k] is None) == (gf[k] is None), k
        if gf[k] is not None:
            np.testing.assert_allclose(gs[k].numpy(), gf[k].numpy(), rtol=1e-6, atol=1e-6 * float(gf[k].abs().max()),
                                       err_msg=k)
        np.testing.assert_allclose(ps[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_trainer_takes_two_split_steps():
    """``use_split_step=True``: two steps with finite losses, the DDF terms
    in the log, the DDF and the scene fields trained."""
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=6, width=24, height=24))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=4, rays_per_image=32),
                                       num_sky_rays=32),
                     scene["cameras"], scene["images"], scene["masks"], device="cpu")
    trainer = Trainer(TrainerConfig(max_num_iterations=100, steps_per_log=1, seed=0, use_split_step=True),
                      TModel(to_torch_config(CFG), device="cpu"), to_torch_config(PIPE), dm, device="cpu")
    start = {k: v.detach().clone() for k, v in tree_items(trainer.params)}
    hist = trainer.run(2)
    assert [r["step"] for r in hist] == [1, 2]
    for rec in hist:
        assert all(np.isfinite(v) for v in rec.values())
        for k in ("depth_l1_loss", "sky_ray_loss", "ddf_depth_psnr", "rgb_l1_loss"):
            assert k in rec
    end = dict(tree_items(trainer.params))
    for group in ("ddf_field", "fields", "proposal_networks"):
        assert any(not torch.equal(start[k], v.detach()) for k, v in end.items() if k.startswith(group)), group
