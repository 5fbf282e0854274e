"""The scene training step of the PyTorch port against the JAX package, on
the tiny scene config of ``tests/test_train_e2e.py`` (no visibility, no
DDF fit) with the canonical frozen decoder (``fixed_decoder=True``).

The same converted parameters, the same batch and the same random draws
(re-derived from the JAX key tree, ``torch_parity.jax_scene_draws``) go
into ``neusky_tpu.models.pipeline.train_loss_fn`` and its port; the test
compares the total loss, every loss term, every trainable group's
gradients and the parameters after one optimizer step.  Both sides run on
the CPU in float32 (JAX's Pallas scatter is inactive on the CPU, where its
``_scatter_ft`` takes the XLA scatter; the port takes its plain version).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neusky_tpu.data.datamanager import DataManager as JDataManager, DataManagerConfig as JDMConfig
from neusky_tpu.data.pixel_sampler import PixelSamplerConfig as JPSConfig
from neusky_tpu.data.synthetic import SyntheticSceneConfig as JSceneConfig, generate_synthetic_scene as j_scene
from neusky_tpu.engine import optimizers as j_opt
from neusky_tpu.fields.density_field import DensityFieldConfig
from neusky_tpu.fields.reni import RENIFieldConfig
from neusky_tpu.fields.sdf_albedo import SDFAlbedoFieldConfig
from neusky_tpu.models.neusky import LossInclusions, NeuSkyModel as JModel, NeuSkyModelConfig
from neusky_tpu.models.pipeline import PipelineConfig as JPipe, train_loss_fn as j_train_loss
from neusky_tpu.ops.hashgrid import HashGridConfig
from neusky_tpu.sampling.proposal import ProposalSamplerConfig

from neusky_torch.core.cameras import Cameras
from neusky_torch.data.datamanager import DataManager as TDataManager, DataManagerConfig as TDMConfig
from neusky_torch.data.datamanager import batch_to_device
from neusky_torch.data.pixel_sampler import PixelSamplerConfig as TPSConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig as TSceneConfig, generate_synthetic_scene as t_scene
from neusky_torch.engine import optimizers as t_opt
from neusky_torch.models.neusky import NeuSkyModel as TModel
from neusky_torch.models.pipeline import PipelineConfig as TPipe, train_loss_fn as t_train_loss
from neusky_torch.tree import tree_items
from torch_parity import jax_scene_draws, jax_to_torch_params, flat_jax, max_rel_err, to_torch_config

TINY_HASH = HashGridConfig(num_levels=4, features_per_level=2, log2_hashmap_size=13, base_res=4, max_res=64)
TINY_PROP_HASH = HashGridConfig(num_levels=3, features_per_level=2, log2_hashmap_size=11, base_res=4, max_res=32)
GROUPS = ("proposal_networks", "fields", "illumination_field", "visibility_sigmoid")


def tiny_scene_config(stochastic_table_grads: bool) -> NeuSkyModelConfig:
    """``tests/test_train_e2e.py::tiny_model_config(False, False)`` with the
    canonical frozen decoder; optionally the canonical stochastic SDF
    table gradient."""
    return NeuSkyModelConfig(
        sdf_field=SDFAlbedoFieldConfig(
            num_layers=2, hidden_dim=64, geo_feat_dim=32, num_layers_color=2,
            hidden_dim_color=64, bias=0.3, hash=TINY_HASH,
            stochastic_table_grads=stochastic_table_grads,
        ),
        proposal=ProposalSamplerConfig(num_proposal_samples=(32, 16), num_final_samples=12),
        proposal_fields=(
            DensityFieldConfig(hidden_dim=16, num_layers=2, hash=TINY_PROP_HASH),
            DensityFieldConfig(hidden_dim=16, num_layers=2, hash=TINY_PROP_HASH),
        ),
        illumination=RENIFieldConfig(
            latent_dim=8, hidden_features=32, num_attention_heads=4,
            num_attention_layers=2, fixed_decoder=True,
        ),
        ddf=None,
        num_illumination_directions=12,
        use_visibility=False,
        fit_visibility_field=False,
        num_train_data=6,
        num_eval_data=2,
        losses=LossInclusions(hashgrid_density_grid_resolution=6, sdf_level_set_visibility=False),
    )


def make_batch_pair():
    """One JAX batch (host numpy + JAX cameras) and the same batch as CPU
    tensors with the port's cameras."""
    scene = j_scene(JSceneConfig(num_cameras=6, width=24, height=24))
    dm = JDataManager(
        JDMConfig(pixel_sampler=JPSConfig(images_per_batch=4, rays_per_image=32), num_sky_rays=32),
        scene["cameras"], scene["images"], scene["masks"],
    )
    jb = dm.next_train(0)
    cams = jb["cameras"]
    t_cams = Cameras(
        camera_to_worlds=torch.from_numpy(np.array(cams.camera_to_worlds)),
        fx=torch.from_numpy(np.array(cams.fx)), fy=torch.from_numpy(np.array(cams.fy)),
        cx=torch.from_numpy(np.array(cams.cx)), cy=torch.from_numpy(np.array(cams.cy)),
        width=cams.width, height=cams.height,
    )
    host = {k: v for k, v in jb.items() if k != "cameras"}
    return jb, batch_to_device(host, t_cams, "cpu")


@pytest.fixture(scope="module")
def scene_batch():
    return make_batch_pair()


def _run_both(stoch: bool, batch_pair, step: float = 100.0):
    jb, tb = batch_pair
    cfg_j = tiny_scene_config(stoch)
    jm = JModel(cfg_j)
    params_j = jm.init(jax.random.PRNGKey(0))
    rng = jax.random.PRNGKey(7)

    def loss(p):
        return j_train_loss(jm, JPipe(), p, rng, jb, jnp.asarray(step, jnp.float32))

    (total_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params_j)

    tm = TModel(to_torch_config(cfg_j), device="cpu")
    params_t = jax_to_torch_params(params_j)
    for k, v in tree_items(params_t):
        if k.split("/")[0] not in ("eval_latents", "illumination_decoder"):
            v.requires_grad_(True)
    draws = jax_scene_draws(cfg_j, rng, tb["pixel_coords"].shape[0])
    total_t, aux_t = t_train_loss(tm, TPipe(), params_t, tb, step, draws)
    total_t.backward()
    return dict(cfg_j=cfg_j, params_j=params_j, grads_j=grads_j, total_j=total_j, aux_j=aux_j,
                params_t=params_t, total_t=total_t, aux_t=aux_t)


@pytest.fixture(scope="module", params=[False, True], ids=["exact_sdf_grads", "stochastic_sdf_grads"])
def both(request, scene_batch):
    return _run_both(request.param, scene_batch)


# Tolerances: both sides are float32 and differ only in the order of
# reductions (XLA vs ATen sums, matmul blocking, transcendental
# approximations), which moves values by a few ulps; through the proposal
# resampling, the NeuS alphas (inv_s = e) and the 2-layer decoder those
# ulps grow to ~1e-5 relative.  Gradients are held per array at 1e-3 of the
# array's largest entry: large enough for the reordered float32 sums of the
# scatter and the eikonal double path, small against any wrong term.
LOSS_RTOL = 1e-4
GRAD_REL = 1e-3


def test_total_loss_matches(both):
    np.testing.assert_allclose(float(both["total_t"].detach()), float(both["total_j"]), rtol=LOSS_RTOL)


def test_every_loss_term_matches(both):
    lj, lt = both["aux_j"]["loss_dict"], both["aux_t"]["loss_dict"]
    assert sorted(lj) == sorted(lt)
    for k in lj:
        np.testing.assert_allclose(float(lt[k].detach()), float(lj[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def test_metrics_match(both):
    mj, mt = both["aux_j"]["metrics"], both["aux_t"]["metrics"]
    assert sorted(mj) == sorted(mt)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("group", GROUPS)
def test_group_gradients_match(both, group):
    gj = flat_jax(both["grads_j"])
    pt = dict(tree_items(both["params_t"]))
    keys = [k for k in gj if k.split("/")[0].startswith(group)]
    assert keys
    for k in keys:
        g_t = pt[k].grad
        g_t = np.zeros_like(gj[k]) if g_t is None else g_t.numpy()
        if np.abs(gj[k]).max() == 0:
            assert np.abs(g_t).max() == 0, k
            continue
        assert max_rel_err(g_t, gj[k]) < GRAD_REL, (k, max_rel_err(g_t, gj[k]))


def test_parameters_after_one_optimizer_step_match(both):
    """One Adam step of both optimizers from the parity gradients.  With
    constant schedules the first Adam update is ±lr·sign(g) wherever
    |g| ≫ eps, so entries whose JAX gradient is within the gradient
    tolerance of zero may legitimately flip sign; every other entry must
    land within 1e-6."""
    lr = 1e-3
    jgroups = {n: j_opt.OptimizerGroupConfig(lr=lr, schedule="constant", max_steps=10) for n in GROUPS}
    tgroups = {n: t_opt.OptimizerGroupConfig(lr=lr, schedule="constant", max_steps=10) for n in GROUPS}
    params_j, grads_j = both["params_j"], both["grads_j"]
    opt = j_opt.build_optimizer(params_j, jgroups)
    new_j = flat_jax(jax.jit(lambda p, g: optax.apply_updates(p, opt.update(g, opt.init(p), p)[0]))(
        params_j, grads_j))
    params_t = both["params_t"]
    t_optim = t_opt.GroupedAdam(params_t, tgroups)
    t_optim.step()
    gj = flat_jax(grads_j)
    for k, v in tree_items(params_t):
        got = v.detach().numpy()
        want = new_j[k]
        flip_ok = np.abs(gj[k]) <= GRAD_REL * max(np.abs(gj[k]).max(), 1e-30)
        bad = (np.abs(got - want) > 1e-6) & ~flip_ok
        assert not bad.any(), (k, np.abs(got - want).max())
        assert (np.abs(got - want) <= 2 * lr + 1e-6).all(), k


def test_optimizer_schedules_and_adam_match_optax():
    """The canonical five groups over 6 steps from the SAME gradients:
    optax multi_transform vs the port's GroupedAdam (schedules at optax's
    update count, frozen groups untouched)."""
    rng = np.random.default_rng(0)
    shapes = {
        "fields": (5, 3), "proposal_networks_0": (4,), "illumination_field": (2, 3),
        "visibility_sigmoid": (1,), "eval_latents": (3,), "illumination_decoder": (2, 2),
    }
    p0 = {k: {"w": rng.normal(size=s).astype(np.float32)} for k, s in shapes.items()}
    groups_j = {n: dataclasses.replace(g, warm_up_end=2, max_steps=6, warmup_steps=min(g.warmup_steps, 3))
                for n, g in j_opt.default_neusky_optimizer_groups(6).items()}
    groups_t = {n: to_torch_config(g) for n, g in groups_j.items()}
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    opt = j_opt.build_optimizer(pj, groups_j)
    state = opt.init(pj)
    pt = {k: {"w": torch.from_numpy(v["w"].copy())} for k, v in p0.items()}
    topt = t_opt.GroupedAdam(pt, groups_t)
    assert not pt["illumination_decoder"]["w"].requires_grad
    for step in range(6):
        g = {k: {"w": rng.normal(size=s).astype(np.float32)} for k, s in shapes.items()}
        upd, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, pj)
        pj = jax.tree_util.tree_map(lambda a, b: a + b, pj, upd)
        for k in pt:
            if pt[k]["w"].requires_grad:
                pt[k]["w"].grad = torch.from_numpy(g[k]["w"])
        topt.step()
        for k in pt:
            np.testing.assert_allclose(pt[k]["w"].detach().numpy(), np.asarray(pj[k]["w"]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} step {step}")


def test_synthetic_scene_and_batches_match():
    """The port's synthetic scene and numpy pixel sampler reproduce the JAX
    package's (same seed → same pixels).  The cameras, images and masks are
    equal bit for bit, silhouette pixels included: the port computes the
    cameras and the rendered rays in JAX's float32 order on the CPU."""
    for cfg in (dict(num_cameras=3, width=20, height=20), dict(num_cameras=8, width=64, height=64)):
        sj, st = j_scene(JSceneConfig(**cfg)), t_scene(TSceneConfig(**cfg))
        np.testing.assert_array_equal(st["cameras"].camera_to_worlds.numpy(),
                                      np.asarray(sj["cameras"].camera_to_worlds))
        np.testing.assert_array_equal(st["images"], sj["images"])
        np.testing.assert_array_equal(st["masks"], sj["masks"])
    dmj = JDataManager(JDMConfig(pixel_sampler=JPSConfig(images_per_batch=2, rays_per_image=8), num_sky_rays=4),
                       sj["cameras"], sj["images"], sj["masks"])
    dmt = TDataManager(TDMConfig(pixel_sampler=TPSConfig(images_per_batch=2, rays_per_image=8), num_sky_rays=4),
                       st["cameras"], st["images"], st["masks"], device="cpu")
    for _ in range(2):
        bj, bt = dmj.next_train(0), dmt.next_train(0)
        for k in ("image_indices", "ray_image_idx", "cam_idx", "pixel_coords", "sky_cam_idx", "sky_pixel_coords"):
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]), err_msg=k)
