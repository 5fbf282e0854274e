"""The port's DDF pieces against the JAX package, on the CPU, from the same
numpy parameters and draws: the SIREN nets (``nets/siren.py``), the DDF
field and model (``fields/ddf.py``, ``models/ddf_model.py``), the sphere
samplers (``sampling/ddf_sampler.py``) and the DDF training outputs and
losses with their gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.core.rays import RayBundle as JRayBundle
from neusky_tpu.fields.ddf import DDFFieldConfig
from neusky_tpu.models import ddf_model as jdm
from neusky_tpu.nets import siren as js
from neusky_tpu.ops.hashgrid import HashGridConfig
from neusky_tpu.sampling import ddf_sampler as jds

from neusky_torch.core.rays import RayBundle as TRayBundle
from neusky_torch.models import ddf_model as tdm
from neusky_torch.nets import siren as ts
from neusky_torch.sampling import ddf_sampler as tds
from neusky_torch.tree import tree_items
from torch_parity import (
    flat_jax, jax_sphere_uniforms, jax_to_torch_params, jax_vmf_draws, max_rel_err, to_torch_config,
)

# float32 on both sides, reordered sums: values to 1e-5 relative, parameter
# gradients per array to 1e-4 of the array's largest entry.
VAL_RTOL, GRAD_REL = 1e-5, 1e-4
# bf16 FiLM compute: both sides round the same float32 inputs to bfloat16,
# but an input a few float32 ulps apart can round to the neighbouring
# bfloat16 value (a step of 2^-8 relative), which moves one product by up
# to ~4e-3 of its value.  Outputs are held to 2e-4 absolute (one such flip
# in an output of scale 0.2), gradients to 1e-3 of each array's scale; the
# values reached are stated in each test.
BF16_VAL_ATOL, BF16_GRAD_REL = 2e-4, 1e-3

TINY_HASH = HashGridConfig(num_levels=3, features_per_level=2, log2_hashmap_size=10, base_res=4, max_res=32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _unit(shape, seed):
    x = _rand(shape, seed)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _trainable(params):
    for _, v in tree_items(params):
        v.requires_grad_(True)
    return params


def _grads_match(params_j, fn_j, params_t, loss_t, rel):
    gj = flat_jax(jax.grad(fn_j)(params_j))
    loss_t.backward()
    pt = dict(tree_items(params_t))
    assert sorted(gj) == sorted(pt)
    worst = 0.0
    for k, g in gj.items():
        got = pt[k].grad.numpy()
        err = max_rel_err(got, g)
        worst = max(worst, err)
        assert err < rel, (k, err)
    return worst


# ---------------------------------------------------------------------------
# nets/siren.py


@pytest.mark.parametrize("outermost_linear", [True, False], ids=["linear_out", "sine_out"])
def test_siren_matches_jax(outermost_linear):
    net_j = js.Siren(hidden_layers=2, hidden_features=16, out_dim=3, outermost_linear=outermost_linear)
    x = _rand((40, 5), 0, 0.5)
    pj = net_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    net_t = ts.Siren(2, 16, 3, outermost_linear=outermost_linear)
    assert {k: v.shape for k, v in flat_jax(pj["params"]).items()} == {
        k: tuple(v.shape) for k, v in tree_items(net_t.init(5, torch.Generator().manual_seed(0), "cpu"))}
    pt = _trainable(jax_to_torch_params(pj["params"]))
    out_t = net_t(pt, torch.from_numpy(x))
    out_j = net_j.apply(pj, jnp.asarray(x))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=VAL_RTOL, atol=1e-6)
    _grads_match(pj["params"], lambda p: jnp.sum(net_j.apply({"params": p}, jnp.asarray(x)) ** 2),
                 pt, torch.sum(out_t**2), GRAD_REL)


@pytest.mark.parametrize("head_block", [0, 8], ids=["one_head", "head_block"])
def test_mapping_network_matches_jax(head_block):
    net_j = js.MappingNetwork(hidden_layers=3, hidden_features=24, out_dim=2 * 3 * 8, head_block=head_block)
    z = _rand((30, 7), 1)
    pj = net_j.init(jax.random.PRNGKey(1), jnp.asarray(z))
    net_t = ts.MappingNetwork(3, 24, 48, head_block=head_block)
    pt = jax_to_torch_params(pj["params"])
    out_j, out_t = net_j.apply(pj, jnp.asarray(z)), net_t(pt, torch.from_numpy(z))
    if head_block:
        assert len(out_t) == len(out_j) == 3
        pairs = [(a, b) for (tj, tt) in zip(out_j, out_t) for a, b in zip(tj, tt)]
    else:
        pairs = list(zip(out_j, out_t))
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=VAL_RTOL, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_compute"])
def test_film_siren_matches_jax(bf16):
    """Outputs and every parameter's gradient.  Reached with bf16 compute:
    max |Δ| 2.2e-8 on outputs of scale 0.18, 4.8e-7 of scale in the worst
    gradient (no input rounds differently at this size; bounds
    ``BF16_*``)."""
    kw = dict(hidden_layers=3, hidden_features=32, mapping_network_layers=2, mapping_network_features=32,
              out_dim=2)
    net_j = js.FiLMSiren(**kw, compute_dtype=jnp.bfloat16 if bf16 else None)
    x, cond = _rand((64, 15), 2, 0.5), _rand((64, 15), 3, 0.5)
    pj = net_j.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(cond))
    net_t = ts.FiLMSiren(3, 32, 2, 32, 2, bf16=bf16)
    assert {k: v.shape for k, v in flat_jax(pj["params"]).items()} == {
        k: tuple(v.shape) for k, v in tree_items(net_t.init(15, 15, torch.Generator().manual_seed(0), "cpu"))}
    pt = _trainable(jax_to_torch_params(pj["params"]))
    out_t = net_t(pt, torch.from_numpy(x), torch.from_numpy(cond))
    out_j = np.asarray(net_j.apply(pj, jnp.asarray(x), jnp.asarray(cond)))
    if bf16:
        np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=BF16_VAL_ATOL)
    else:
        np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=VAL_RTOL, atol=1e-6)
    _grads_match(
        pj["params"],
        lambda p: jnp.sum(net_j.apply({"params": p}, jnp.asarray(x), jnp.asarray(cond)) ** 2),
        pt, torch.sum(out_t**2), BF16_GRAD_REL if bf16 else GRAD_REL,
    )


def test_film_siren_init_distributions():
    """The port's initialisers draw from the JAX schemes' distributions:
    bounds of the uniform ones, the standard deviation of the normal ones."""
    net = ts.FiLMSiren(2, 256, 2, 256, 1)
    p = net.init(15, 15, torch.Generator().manual_seed(0), "cpu")
    assert p["film_kernel_0"].abs().max() <= 1.0 / 15
    assert p["film_kernel_1"].abs().max() <= np.sqrt(6.0 / 256) / 25.0
    assert p["film_bias_1"].abs().max() <= 1.0 / 16.0
    std = np.sqrt(2.0 / 1.04) / np.sqrt(256)
    np.testing.assert_allclose(float(p["MappingNetwork_0"]["kernel_1"].std()), std, rtol=0.02)
    np.testing.assert_allclose(float(p["MappingNetwork_0"]["kernel_out"].std()), 0.25 * std, rtol=0.02)


# ---------------------------------------------------------------------------
# fields/ddf.py and models/ddf_model.py


def _ddf_config(pos: str, head: str, conditioning: str = "FiLM", bf16: bool = False) -> jdm.DDFModelConfig:
    return jdm.DDFModelConfig(field=DDFFieldConfig(
        position_encoding_type=pos, direction_encoding_type="nerf", hash=TINY_HASH, conditioning=conditioning,
        hidden_layers=2, hidden_features=32, mapping_layers=2, mapping_features=32, ddf_type=head,
        predict_probability_of_hit=head == "pddf", use_bf16_compute=bf16,
    ))


def _sphere_queries(m: int, seed: int):
    o = _unit((m, 3), seed)
    o[:, 2] = np.abs(o[:, 2])
    d = _unit((m, 3), seed + 1)
    d = np.where(np.sum(d * -o, -1, keepdims=True) < 0, -d, d).astype(np.float32)
    return o, d


@pytest.mark.parametrize("pos, head, conditioning", [
    ("nerf", "ddf", "FiLM"), ("nerf", "pddf", "FiLM"), ("hash", "ddf", "FiLM"), ("hash", "pddf", "FiLM"),
    ("none", "ddf", "Concat"),
])
def test_ddf_model_matches_jax(pos, head, conditioning):
    cfg = _ddf_config(pos, head, conditioning)
    jm, tm = jdm.DDFModel(cfg), tdm.DDFModel(to_torch_config(cfg))
    o, d = _sphere_queries(48, 4)
    pj = jm.init(jax.random.PRNGKey(3), jnp.asarray(o), jnp.asarray(d))
    assert {k: v.shape for k, v in flat_jax(pj).items()} == {
        k: tuple(v.shape) for k, v in tree_items(tm.init(torch.Generator().manual_seed(0), "cpu"))}
    pt = _trainable(jax_to_torch_params(pj))
    out_j = jm.apply(pj, jnp.asarray(o), jnp.asarray(d))
    out_t = tm.apply(pt, torch.from_numpy(o), torch.from_numpy(d))
    assert sorted(out_j) == sorted(out_t)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]), rtol=VAL_RTOL, atol=1e-6)

    def loss_j(p):
        out = jm.apply(p, jnp.asarray(o), jnp.asarray(d))
        return sum(jnp.sum(v**2) for v in out.values())

    _grads_match(pj, loss_j, pt, sum(torch.sum(v**2) for v in out_t.values()), GRAD_REL)


def test_localised_transforms_match_jax_including_the_poles():
    o = _unit((20, 3), 5)
    o[0] = [0.0, 0.0, 1.0]
    o[1] = [0.0, 0.0, -1.0]
    o[2] = [1e-8, 0.0, 1.0]
    got = tdm.get_localised_transforms(torch.from_numpy(o)).numpy()
    want = np.asarray(jdm.get_localised_transforms(jnp.asarray(o)))
    np.testing.assert_allclose(got, want, rtol=VAL_RTOL, atol=1e-6)
    np.testing.assert_array_equal(got[0, :, 0], [1.0, 0.0, 0.0])
    # a proper rotation everywhere: R^T R = I
    np.testing.assert_allclose(np.einsum("mji,mjk->mik", got, got), np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-6)
    d = _unit((20, 3), 6)
    np.testing.assert_allclose(
        tdm.localise_directions(torch.from_numpy(o), torch.from_numpy(d)).numpy(),
        np.asarray(jdm.localise_directions(jnp.asarray(o), jnp.asarray(d))), rtol=VAL_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# sampling/ddf_sampler.py


def test_sample_vmf_matches_jax_from_its_draws():
    rng = jax.random.PRNGKey(11)
    mu = _unit((4, 3), 7)
    k_u, k_t = jax.random.split(rng)
    u = jax.random.uniform(k_u, (4, 50), minval=1e-7, maxval=1.0)
    z = jax.random.normal(k_t, (4, 50, 3))
    want = np.asarray(jds.sample_vmf(rng, jnp.asarray(mu), 20.0, 50))
    got = tds.sample_vmf(torch.from_numpy(mu), 20.0, torch.from_numpy(np.asarray(u)),
                         torch.from_numpy(np.asarray(z))).numpy()
    np.testing.assert_allclose(got, want, rtol=VAL_RTOL, atol=2e-6)
    # concentrated around the mean: E[cos] = coth κ − 1/κ = 0.95 at κ = 20
    assert abs(np.mean(np.sum(got * mu[:, None], -1)) - 0.95) < 0.02


@pytest.mark.parametrize("kind", ["vmf", "uniform"])
def test_ddf_ray_samplers_match_jax(kind):
    cfg = jds.DDFSamplerConfig(num_samples_on_sphere=3, num_rays_per_sample=20, concentration=20.0)
    rng = jax.random.PRNGKey(12)
    if kind == "vmf":
        want = jds.vmf_ddf_samples(rng, cfg, ddf_sphere_radius=1.5)
        got = tds.vmf_ddf_samples(to_torch_config(cfg), jax_vmf_draws(rng, cfg), ddf_sphere_radius=1.5)
    else:
        k_p, k_d = jax.random.split(rng)
        want = jds.uniform_ddf_samples(rng, cfg, ddf_sphere_radius=1.5)
        draws = {"sphere_u": jax_sphere_uniforms(k_p, 3), "dir_u": jax_sphere_uniforms(k_d, 60)}
        got = tds.uniform_ddf_samples(to_torch_config(cfg), draws, ddf_sphere_radius=1.5)
    np.testing.assert_allclose(got.origins.numpy(), np.asarray(want.origins), rtol=VAL_RTOL, atol=2e-6)
    np.testing.assert_allclose(got.directions.numpy(), np.asarray(want.directions), rtol=VAL_RTOL, atol=2e-6)
    assert (got.origins[:, 2] >= 0).all()
    assert (torch.sum(got.directions * -got.origins, -1) >= 0).all()


# ---------------------------------------------------------------------------
# ddf_train_outputs and ddf_loss_dict


def _sdf_j(p):
    return (jnp.linalg.norm(p, axis=-1) - 0.4)[:, None]


def _sdf_t(p):
    return (torch.linalg.norm(p, dim=-1) - 0.4)[:, None]


_ALL_LOSS_OPTIONS = dict(
    losses=jdm.DDFLossConfig(depth_l1=True, depth_l2=True, sdf_l1=True, sdf_l2=True, prob_hit=True),
    scene_center_weight_include_z=True, mask_to_circumference=True, inverse_depth_weight=True,
)


@pytest.mark.parametrize("variant", ["fp32", "bf16_compute", "pddf_every_loss_option"])
def test_ddf_train_outputs_and_losses_match_jax(variant):
    """Every output and loss term, the gradient of the total into every
    DDF parameter and into the ground-truth termination distances (the
    path by which the DDF losses reach the SDF).  The last variant takes
    the pddf head with the probability of hit, every DDF loss term and
    every depth-loss option, with the SDF gradient stopped.  Reached with
    bf16 compute: outputs to 5.5e-7 relative (away from zero), losses to
    7e-8, the worst gradient 3.6e-4 of its array's scale."""
    bf16 = variant == "bf16_compute"
    cfg = _ddf_config("nerf", "ddf", bf16=bf16)
    stop_sdf = variant == "pddf_every_loss_option"
    if stop_sdf:
        cfg = dataclasses.replace(_ddf_config("nerf", "pddf"), **_ALL_LOSS_OPTIONS)
    jm, tm = jdm.DDFModel(cfg), tdm.DDFModel(to_torch_config(cfg))
    m, k = 64, 16
    o, d = _sphere_queries(m, 8)
    pj = jm.init(jax.random.PRNGKey(4), jnp.asarray(o), jnp.asarray(d))
    term = np.abs(_rand((m, 1), 9, 0.6)) + 0.2
    mask = (np.random.default_rng(10).uniform(size=(m, 1)) > 0.3).astype(np.float32)
    sky_o, sky_d = _rand((k, 3), 11, 0.3), _unit((k, 3), 12)
    rng = jax.random.PRNGKey(13)

    def run_j(p, term_dist):
        batch = {"termination_dist": term_dist, "mask": jnp.asarray(mask),
                 "sky_ray_bundle": JRayBundle.create(jnp.asarray(sky_o), jnp.asarray(sky_d))}
        rb = JRayBundle.create(jnp.asarray(o), jnp.asarray(d))
        out = jdm.ddf_train_outputs(jm, p, rng, rb, batch, sdf_at_pos_fn=_sdf_j, stop_sdf_gradients=stop_sdf)
        return out, jdm.ddf_loss_dict(cfg, out, batch, 1.0)

    (out_j, ld_j) = run_j(pj, jnp.asarray(term))
    pt = _trainable(jax_to_torch_params(pj))
    term_t = torch.from_numpy(term).requires_grad_(True)
    batch_t = {"termination_dist": term_t, "mask": torch.from_numpy(mask),
               "sky_ray_bundle": TRayBundle.create(torch.from_numpy(sky_o), torch.from_numpy(sky_d))}
    out_t = tdm.ddf_train_outputs(
        tm, pt, TRayBundle.create(torch.from_numpy(o), torch.from_numpy(d)), batch_t, sdf_at_pos_fn=_sdf_t,
        stop_sdf_gradients=stop_sdf, multi_view_u=jax_sphere_uniforms(jax.random.split(rng)[0], m))
    ld_t = tdm.ddf_loss_dict(to_torch_config(cfg), out_t, batch_t, 1.0)
    assert sorted(out_j) == sorted(out_t)
    assert sorted(ld_j) == sorted(ld_t)
    assert len(ld_t) == (8 - 1 if stop_sdf else 4)  # every term but the normal loss, or the canonical four
    rtol = 1e-4 if bf16 else VAL_RTOL
    for key in out_j:
        np.testing.assert_allclose(out_t[key].detach().numpy(), np.asarray(out_j[key]), rtol=rtol, atol=1e-5,
                                   err_msg=key)
    for key in ld_j:
        np.testing.assert_allclose(float(ld_t[key]), float(ld_j[key]), rtol=rtol, atol=1e-7, err_msg=key)

    def total_j(p, t):
        return sum(run_j(p, t)[1].values())

    gp, gterm = jax.grad(total_j, argnums=(0, 1))(pj, jnp.asarray(term))
    sum(ld_t.values()).backward()
    rel = BF16_GRAD_REL if bf16 else GRAD_REL
    assert max_rel_err(term_t.grad.numpy(), np.asarray(gterm)) < rel
    pt_flat = dict(tree_items(pt))
    for key, g in flat_jax(gp).items():
        assert max_rel_err(pt_flat[key].grad.numpy(), g) < rel, key
