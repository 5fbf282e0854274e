"""The joint training step of the PyTorch port (scene half + DDF visibility
+ DDF fit + the SDF level-set loss) against the JAX package, on the CPU.

The config is ``test_torch_slice``'s tiny scene config (canonical frozen
decoder, stochastic SDF table gradients) with a tiny FiLM-SIREN DDF on
NeRF encodings, DDF visibility over the upper hemisphere of 42 light
directions (k = 29 queried, in chunks of 200 queries), the level-set query
at a strided subset of 8 directions, and a 2 × 16 vMF DDF-fit batch.  The
same converted parameters, batch and draws (``jax_scene_draws`` and
``jax_ddf_draws``) go into both ``train_loss_fn``s.  The JAX step is built
once per module and compute dtype.

Tolerances follow ``test_torch_slice.py``: losses to 1e-4 relative,
gradients to 1e-3 of each array's scale.  With the canonical
``use_bf16_compute=True`` the DDF's gradients are held to 2e-3 of scale
(reached: 5.1e-4 in ``ddf_field``, every other group as in float32): an
input a few ulps apart may round to the neighbouring bfloat16 value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.core.rays import RaySamples as JRaySamples
from neusky_tpu.fields.ddf import DDFFieldConfig
from neusky_tpu.models.ddf_model import DDFModelConfig
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.models.pipeline import PipelineConfig as JPipe, train_loss_fn as j_train_loss
from neusky_tpu.sampling.ddf_sampler import DDFSamplerConfig, vmf_ddf_samples as j_vmf

from neusky_torch.core.rays import RaySamples as TRaySamples
from neusky_torch.data.datamanager import DataManager, DataManagerConfig
from neusky_torch.data.pixel_sampler import PixelSamplerConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig, generate_synthetic_scene
from neusky_torch.engine.trainer import Trainer, TrainerConfig
from neusky_torch.models import neusky as t_neusky
from neusky_torch.models.pipeline import train_loss_fn as t_train_loss
from neusky_torch.ops import hashgrid
from neusky_torch.sampling.ddf_sampler import vmf_ddf_samples as t_vmf
from neusky_torch.tree import tree_items
from test_torch_slice import make_batch_pair, tiny_scene_config
from torch_parity import (
    flat_jax, jax_ddf_draws, jax_gt_draws, jax_scene_draws, jax_to_torch_params, jax_vmf_draws, max_rel_err,
    to_torch_config, u32_tensor,
)

GROUPS = ("proposal_networks", "fields", "illumination_field", "visibility_sigmoid", "ddf_field")
LOSS_RTOL = 1e-4
GRAD_REL = {False: 1e-3, True: 2e-3}
STEP = 100.0


def tiny_joint_config(bf16: bool):
    cfg = tiny_scene_config(True)
    return dataclasses.replace(
        cfg,
        ddf=DDFModelConfig(field=DDFFieldConfig(
            position_encoding_type="nerf", hidden_layers=2, hidden_features=32, mapping_layers=2,
            mapping_features=32, use_bf16_compute=bf16,
        )),
        use_visibility=True, fit_visibility_field=True, num_illumination_directions=42,
        visibility_query_chunk=200, sdf_level_set_subset=8,
        losses=dataclasses.replace(cfg.losses, sdf_level_set_visibility=True),
    )


PIPE = JPipe(visibility_train_sampler=DDFSamplerConfig(num_samples_on_sphere=2, num_rays_per_sample=16))


def _trainable(params):
    for k, v in tree_items(params):
        if k.split("/")[0] not in ("eval_latents", "illumination_decoder"):
            v.requires_grad_(True)
    return params


@pytest.fixture(scope="module")
def batch_pair():
    return make_batch_pair()


@pytest.fixture(scope="module", params=[False, True], ids=["fp32", "bf16_compute"])
def joint(request, batch_pair):
    bf16 = request.param
    jb, tb = batch_pair
    cfg_j = tiny_joint_config(bf16)
    jm = JModel(cfg_j)
    params_j = jm.init(jax.random.PRNGKey(0))
    rng = jax.random.PRNGKey(7)
    loss = lambda p: j_train_loss(jm, PIPE, p, rng, jb, jnp.asarray(STEP, jnp.float32))
    (total_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params_j)

    tm = t_neusky.NeuSkyModel(to_torch_config(cfg_j), device="cpu")
    params_t = _trainable(jax_to_torch_params(params_j))
    draws = jax_scene_draws(cfg_j, rng, tb["pixel_coords"].shape[0])
    draws["ddf"] = jax_ddf_draws(cfg_j, PIPE, rng)
    total_t, aux_t = t_train_loss(tm, to_torch_config(PIPE), params_t, tb, STEP, draws)
    total_t.backward()
    return dict(bf16=bf16, params_j=params_j, grads_j=grads_j, total_j=total_j, aux_j=aux_j,
                params_t=params_t, total_t=total_t, aux_t=aux_t)


def test_joint_total_loss_matches(joint):
    np.testing.assert_allclose(float(joint["total_t"].detach()), float(joint["total_j"]), rtol=LOSS_RTOL)


def test_joint_every_loss_term_matches(joint):
    lj, lt = joint["aux_j"]["loss_dict"], joint["aux_t"]["loss_dict"]
    assert sorted(lj) == sorted(lt)
    for k in ("sdf_level_set_visibility_loss", "depth_l1_loss", "sdf_l2_loss", "multi_view_loss", "sky_ray_loss"):
        assert k in lt
    for k in lj:
        np.testing.assert_allclose(float(lt[k].detach()), float(lj[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def test_joint_metrics_match(joint):
    mj, mt = joint["aux_j"]["metrics"], joint["aux_t"]["metrics"]
    assert sorted(mj) == sorted(mt) and "ddf_depth_psnr" in mt
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=LOSS_RTOL, err_msg=k)


def test_converted_params_carry_the_ddf_tree(joint):
    """``convert_params`` carries every JAX leaf, the DDF's included, under
    its flax path and shape."""
    pj, pt = flat_jax(joint["params_j"]), dict(tree_items(joint["params_t"]))
    assert sorted(pj) == sorted(pt)
    assert any(k.startswith("ddf_field/params/field/net/MappingNetwork_0/") for k in pt)
    for k, v in pj.items():
        assert tuple(pt[k].shape) == v.shape, k


@pytest.mark.parametrize("group", GROUPS)
def test_joint_group_gradients_match(joint, group):
    gj = flat_jax(joint["grads_j"])
    pt = dict(tree_items(joint["params_t"]))
    keys = [k for k in gj if k.split("/")[0].startswith(group)]
    assert keys
    for k in keys:
        g_t = pt[k].grad
        g_t = np.zeros_like(gj[k]) if g_t is None else g_t.numpy()
        if np.abs(gj[k]).max() == 0:
            assert np.abs(g_t).max() == 0, k
            continue
        err = max_rel_err(g_t, gj[k])
        assert err < GRAD_REL[joint["bf16"]], (k, err)


# ---------------------------------------------------------------------------
# the pieces


@pytest.fixture(scope="module")
def models():
    cfg_j = tiny_joint_config(False)
    jm = JModel(cfg_j)
    params_j = jm.init(jax.random.PRNGKey(1))
    tm = t_neusky.NeuSkyModel(to_torch_config(cfg_j), device="cpu")
    return jm, tm, params_j


def test_top_k_order_matches_jax():
    """The upper-hemisphere prune's order (the strided level-set subset
    depends on it), with ties: the unrotated icosphere's z values repeat."""
    dirs = t_neusky.IcosahedronSampler(num_directions=42, apply_random_rotation=False).directions_np
    for z in (dirs[:, 2], np.random.default_rng(0).normal(size=492).astype(np.float32),
              np.array([0.5, 0.1, 0.5, -0.2, 0.1, 0.5, 0.0, 0.1, 0.9, 0.0], np.float32)):
        k = min(z.shape[0], z.shape[0] // 2 + 8)
        _, want = jax.lax.top_k(jnp.asarray(z), k)
        got = t_neusky.top_k_indices(torch.from_numpy(z), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ray_samples(n=24, seed=0):
    """Rays from points around the sphere, with depths that put some
    surface points outside the DDF sphere (the pull-back path)."""
    g = np.random.default_rng(seed)
    o = (g.normal(size=(n, 3)) * 0.3 + np.array([0.0, -1.6, 0.3])).astype(np.float32)
    d = (np.array([0.0, 1.0, -0.1]) + g.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    arr = dict(
        origins=o[:, None], directions=d[:, None], starts=np.zeros((n, 1, 1), np.float32),
        ends=np.ones((n, 1, 1), np.float32), pixel_area=np.ones((n, 1, 1), np.float32),
        camera_indices=np.zeros((n, 1, 1), np.int32), deltas=np.ones((n, 1, 1), np.float32),
        spacing_starts=np.zeros((n, 1, 1), np.float32), spacing_ends=np.ones((n, 1, 1), np.float32),
    )
    p2p = g.uniform(0.3, 3.2, (n, 1)).astype(np.float32)
    return (JRaySamples(**{k: jnp.asarray(v) for k, v in arr.items()}),
            TRaySamples(**{k: torch.from_numpy(v) for k, v in arr.items()}), p2p)


def test_compute_visibility_matches_jax(models):
    """Visibility, difference, the DDF's termination distances and the SDF
    at the strided termination points (stochastic salt), and the gradients
    of their sum into the DDF and the SDF field."""
    jm, tm, params_j = models
    rs_j, rs_t, p2p = _ray_samples()
    dirs = np.asarray(jm.illumination_sampler(jax.random.PRNGKey(5)))
    salt = jax.random.bits(jax.random.PRNGKey(6), dtype=jnp.uint32)
    thr, scale = 0.3, 25.0

    def run_j(p):
        return jm.compute_visibility(p, rs_j, jnp.asarray(p2p), jnp.asarray(dirs), jnp.asarray(thr),
                                     jnp.asarray(scale), False, True, salt)

    def scalar_j(p):
        out = run_j(p)
        return jnp.sum(out["visibility"]) + jnp.sum(out["sdf_at_termination"] ** 2)

    out_j = jax.jit(run_j)(params_j)
    params_t = _trainable(jax_to_torch_params(params_j))
    out_t = tm.compute_visibility(params_t, rs_t, torch.from_numpy(p2p), torch.from_numpy(dirs),
                                  torch.tensor(thr), torch.tensor(scale), False, True, u32_tensor(salt))
    assert out_t["visibility"].shape == (24, 1, 42) and out_t["sdf_at_termination"].shape == (24 * 8, 1)
    assert (np.linalg.norm(p2p * rs_t.directions[:, 0].numpy() + rs_t.origins[:, 0].numpy(), axis=-1) > 1).any()
    for k in ("visibility", "difference", "expected_termination_dist", "sdf_at_termination"):
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]), rtol=1e-5, atol=2e-6,
                                   err_msg=k)
    gj = flat_jax(jax.jit(jax.grad(scalar_j))(params_j))
    (torch.sum(out_t["visibility"]) + torch.sum(out_t["sdf_at_termination"] ** 2)).backward()
    pt = dict(tree_items(params_t))
    for k, g in gj.items():
        if k.split("/")[0] not in ("ddf_field", "fields"):
            continue
        got = np.zeros_like(g) if pt[k].grad is None else pt[k].grad.numpy()
        if np.abs(g).max() == 0:
            assert np.abs(got).max() == 0, k
            continue
        assert max_rel_err(got, g) < 1e-3, (k, max_rel_err(got, g))


@pytest.mark.parametrize("stop_gradients", [False, True], ids=["to_the_sdf", "stopped"])
def test_generate_ddf_ground_truth_matches_jax(models, stop_gradients):
    """The GT render of vMF sphere rays (eval-mode sampler, un-annealed,
    the pass's own stochastic table gradients): outputs, and gradients into
    the SDF field and the proposal fields (none when stopped)."""
    jm, tm, params_j = models
    rng_s, rng_gt = jax.random.PRNGKey(8), jax.random.PRNGKey(9)
    sampler = PIPE.visibility_train_sampler
    bundle_j = j_vmf(rng_s, sampler, ddf_sphere_radius=1.0)
    bundle_t = t_vmf(to_torch_config(sampler), jax_vmf_draws(rng_s, sampler), ddf_sphere_radius=1.0)

    def run_j(p):
        return jm.generate_ddf_ground_truth(p, rng_gt, bundle_j, stop_gradients=stop_gradients)

    def scalar_j(p):
        out = run_j(p)
        return jnp.sum(out["termination_dist"] * out["accumulations"]) + jnp.sum(out["normals"] ** 2)

    out_j = jax.jit(run_j)(params_j)
    params_t = _trainable(jax_to_torch_params(params_j))
    out_t = tm.generate_ddf_ground_truth(params_t, bundle_t, stop_gradients=stop_gradients,
                                         draws=jax_gt_draws(jm.config, rng_gt, 32))
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    if stop_gradients:
        assert not any(v.requires_grad for v in out_t.values())
        return
    gj = flat_jax(jax.jit(jax.grad(scalar_j))(params_j))
    (torch.sum(out_t["termination_dist"] * out_t["accumulations"]) + torch.sum(out_t["normals"] ** 2)).backward()
    pt = dict(tree_items(params_t))
    checked = 0
    for k, g in gj.items():
        if not k.split("/")[0].startswith(("fields", "proposal_networks")) or np.abs(g).max() == 0:
            continue
        assert max_rel_err(pt[k].grad.numpy(), g) < 1e-3, (k, max_rel_err(pt[k].grad.numpy(), g))
        checked += 1
    assert checked > 5


@pytest.mark.parametrize("method", ["learnable", "exponential_decay", "fixed"])
def test_visibility_threshold_matches_jax(models, method):
    """(threshold, sigmoid scale) of the occlusion sigmoid, before, during
    and after the exponential decay."""
    jm, _, params_j = models
    cfg_j = dataclasses.replace(jm.config, losses=dataclasses.replace(jm.config.losses, vis_sigmoid_method=method))
    jm2, tm2 = JModel(cfg_j), t_neusky.NeuSkyModel(to_torch_config(cfg_j), device="cpu")
    params_t = jax_to_torch_params(params_j)
    for step in (0.0, 1234.0, 50000.0, 60000.0):
        want = jm2._visibility_threshold(params_j, step)
        got = tm2._visibility_threshold(params_t, step)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6, err_msg=f"{method} step {step}")


def test_joint_step_scatters_once_per_differentiated_encode(batch_pair, monkeypatch):
    """One joint step dispatches the table-gradient scatter (K1 on the
    card) 7 times, once per hash-grid encode that a loss differentiates:
    the scene's 2 proposal fields, SDF ``field_outputs`` and density-grid
    SDF; the DDF ground-truth pass's SDF; the level-set SDF query; the
    DDF-fit SDF query.  The ground-truth pass's proposal encodes feed only
    the (non-differentiated) resampling, so no gradient reaches them, in
    JAX as here.  Rows: one per sample and level where the table gradient
    is stochastic, eight corners per sample where it is exact (the DDF-fit
    query)."""
    _, tb = batch_pair
    cfg = to_torch_config(tiny_joint_config(False))
    tm = t_neusky.NeuSkyModel(cfg, device="cpu")
    params = _trainable(tm.init(torch.Generator().manual_seed(0)))
    calls = []
    dispatch = hashgrid.scatter_levels
    monkeypatch.setattr(hashgrid, "scatter_levels", lambda r, v, t: calls.append(tuple(r.shape)) or dispatch(r, v, t))
    total, _ = t_train_loss(tm, to_torch_config(PIPE), params, tb, STEP, generator=torch.Generator().manual_seed(1))
    total.backward()
    n_scene, n_gt = 128, 32
    sdf_l = cfg.sdf_field.hash.num_levels
    assert sorted(calls) == sorted([
        (3, n_scene * 32), (3, n_scene * 16), (sdf_l, n_scene * 12), (sdf_l, 6**3),
        (sdf_l, n_gt * 12), (sdf_l, n_scene * 8), (sdf_l, n_gt * 8),
    ])


def test_joint_trainer_steps_on_cpu():
    """Two ``Trainer`` steps of the tiny joint config: finite losses, the
    DDF terms in the log, 2 × 16 DDF-fit rays counted, the DDF and the
    visibility sigmoid trained, the decoder frozen."""
    scene = generate_synthetic_scene(SyntheticSceneConfig(num_cameras=6, width=24, height=24))
    dm = DataManager(DataManagerConfig(pixel_sampler=PixelSamplerConfig(images_per_batch=4, rays_per_image=32),
                                       num_sky_rays=32),
                     scene["cameras"], scene["images"], scene["masks"], device="cpu")
    cfg = to_torch_config(tiny_joint_config(True))
    trainer = Trainer(TrainerConfig(max_num_iterations=100, steps_per_log=1, seed=0),
                      t_neusky.NeuSkyModel(cfg, device="cpu"), to_torch_config(PIPE), dm, device="cpu")
    start = {k: v.detach().clone() for k, v in tree_items(trainer.params)}
    hist = trainer.run(2)
    for rec in hist:
        assert all(np.isfinite(v) for v in rec.values())
        for k in ("sdf_level_set_visibility_loss", "depth_l1_loss", "sky_ray_loss", "ddf_depth_psnr"):
            assert k in rec
    assert trainer._count_rays(dm.next_train(0)) == 128 + 32 + 32
    end = dict(tree_items(trainer.params))
    for group in ("ddf_field", "visibility_sigmoid", "fields"):
        assert any(not torch.equal(start[k], v.detach()) for k, v in end.items() if k.startswith(group)), group
    assert all(torch.equal(start[k], v) for k, v in end.items() if k.startswith("illumination_decoder/"))
