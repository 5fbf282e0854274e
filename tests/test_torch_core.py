"""The port's small modules against their JAX counterparts on the same
inputs: core/ (colour, spherical, rays, scene, cameras), ops/encodings,
nets (softplus_beta, neus_alpha), sampling (proposal, icosphere sampler),
shading/lambertian and the scene losses.  Values are float32 and agree to
float32 rounding of reordered reductions (rtol 1e-5 unless stated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.core import cameras as jcam, colour as jcol, rays as jrays, scene as jscene, spherical as jsph
from neusky_tpu.models import losses as jloss
from neusky_tpu.nets import density as jden, mlp as jmlp
from neusky_tpu.ops import encodings as jenc
from neusky_tpu.sampling import illumination as jill, proposal as jprop
from neusky_tpu.shading import lambertian as jlam

from neusky_torch.core import cameras as tcam, colour as tcol, rays as trays, scene as tscene, spherical as tsph
from neusky_torch.models import losses as tloss
from neusky_torch.nets import density as tden, mlp as tmlp
from neusky_torch.ops import encodings as tenc
from neusky_torch.sampling import illumination as till, proposal as tprop
from neusky_torch.shading import lambertian as tlam
from torch_parity import to_torch_config

RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.detach().numpy() if torch.is_tensor(t) else t, np.asarray(j), rtol=rtol, atol=atol)


def _bundles(n=32):
    o = RNG.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = RNG.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[: n // 2] = -1.5 * d[: n // 2] + 0.1  # half of them aim at the sphere
    return (jrays.RayBundle.create(jnp.asarray(o), jnp.asarray(d)),
            trays.RayBundle.create(_t(o), _t(d)))


def test_colour_forward_and_straight_through_gradient():
    x = np.array([-0.1, 0.0, 0.002, 0.2, 0.9, 1.5, 4.0], np.float32)
    _close(tcol.linear_to_sRGB(_t(x)), jcol.linear_to_sRGB(jnp.asarray(x)))
    _close(tcol.sRGB_to_linear(_t(x)), jcol.sRGB_to_linear(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    tcol.linear_to_sRGB(xt).sum().backward()
    _close(xt.grad, jax.grad(lambda v: jnp.sum(jcol.linear_to_sRGB(v)))(jnp.asarray(x)))


@pytest.mark.parametrize("order", [1, 3, 7])
def test_icosphere_and_sampler_match(order):
    np.testing.assert_array_equal(tsph.icosphere_vertices(order), jsph.icosphere_vertices(order))
    s_j, s_t = jill.IcosahedronSampler(num_directions=10 * order * order + 2), till.IcosahedronSampler(
        num_directions=10 * order * order + 2)
    key = jax.random.PRNGKey(order)
    q = _t(jax.random.normal(key, (4,)))
    _close(s_t("cpu", rotation_normals=q), s_j(key), atol=1e-6)
    _close(s_t("cpu", apply_random_rotation=False), s_j(None))


def test_ray_sphere_intersection_and_colliders():
    bj, bt = _bundles()
    _close(tsph.ray_sphere_intersection(bt.origins * 0.3, bt.directions, 1.0),
           jsph.ray_sphere_intersection(bj.origins * 0.3, bj.directions, 1.0))
    for fn_t, fn_j in ((tscene.sphere_collider, jscene.sphere_collider),):
        rt, rj = fn_t(bt, 1.0, 0.05), fn_j(bj, 1.0, 0.05)
        _close(rt.nears, rj.nears)
        _close(rt.fars, rj.fars)
    aabb = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    rt, rj = tscene.aabb_collider(bt, _t(aabb), 0.05), jscene.aabb_collider(bj, jnp.asarray(aabb), 0.05)
    _close(rt.nears, rj.nears)
    _close(rt.fars, rj.fars)


@pytest.mark.parametrize("order", ["l2", "linf"])
def test_contraction(order):
    x = RNG.uniform(-3, 3, (64, 3)).astype(np.float32)
    _close(tscene.contraction_to_unit_cube(_t(x), order), jscene.contraction_to_unit_cube(jnp.asarray(x), order))


def test_cameras_generate_rays_at():
    c2w = jsph.look_at_target(jnp.array([[1.2, 0.3, 0.35], [-1.0, 0.5, 0.2]]), jnp.zeros((2, 3)))[..., :3, :]
    jc = jcam.Cameras(camera_to_worlds=c2w, fx=jnp.full((2,), 40.0), fy=jnp.full((2,), 40.0),
                      cx=jnp.full((2,), 24.0), cy=jnp.full((2,), 24.0), width=48, height=48)
    tc = tcam.Cameras(camera_to_worlds=_t(c2w), fx=torch.full((2,), 40.0), fy=torch.full((2,), 40.0),
                      cx=torch.full((2,), 24.0), cy=torch.full((2,), 24.0), width=48, height=48)
    np.testing.assert_allclose(
        tsph.look_at_target(np.array([[1.2, 0.3, 0.35], [-1.0, 0.5, 0.2]]), np.zeros((2, 3)))[..., :3, :],
        np.asarray(c2w), atol=1e-6)
    idx = np.array([0, 1, 1, 0], np.int32)
    coords = RNG.uniform(0, 48, (4, 2)).astype(np.float32)
    rj, rt = jc.generate_rays_at(jnp.asarray(idx), jnp.asarray(coords)), tc.generate_rays_at(_t(idx), _t(coords))
    for k in ("origins", "directions", "pixel_area", "directions_norm"):
        _close(getattr(rt, k), getattr(rj, k))


def test_nerf_encoding():
    x = RNG.uniform(-1, 1, (10, 3)).astype(np.float32)
    _close(tenc.nerf_encoding(_t(x), 6, 0.0, 5.0), jenc.nerf_encoding(jnp.asarray(x), 6, 0.0, 5.0), atol=2e-5)
    _close(tenc.nerf_encoding(_t(x), 2, 0.0, 2.0), jenc.nerf_encoding(jnp.asarray(x), 2, 0.0, 2.0), atol=2e-5)


def test_softplus_beta_value_slope_and_overflow_guard():
    x = np.array([-1.0, -0.01, 0.0, 0.05, 0.19, 0.21, 3.0, 50.0], np.float32)
    _close(tmlp.softplus_beta(_t(x)), jmlp.softplus_beta(jnp.asarray(x)))
    y, slope = tmlp.softplus_beta_with_slope(_t(x))
    _close(y, jmlp.softplus_beta(jnp.asarray(x)))
    _close(slope, jax.vmap(jax.grad(lambda v: jmlp.softplus_beta(v)))(jnp.asarray(x)))
    assert torch.isfinite(slope).all()


def test_neus_alpha_and_compositing():
    n, s = 16, 8
    sdf = RNG.normal(size=(n, s, 1)).astype(np.float32) * 0.2
    g = RNG.normal(size=(n, s, 3)).astype(np.float32)
    d = RNG.normal(size=(n, s, 3)).astype(np.float32)
    dl = RNG.uniform(0.01, 0.1, (n, s, 1)).astype(np.float32)
    for ratio in (1.0, 0.3):
        a_t = tden.neus_alpha(_t(sdf), _t(g), _t(d), _t(dl), torch.tensor([20.0]), ratio)
        a_j = jden.neus_alpha(jnp.asarray(sdf), jnp.asarray(g), jnp.asarray(d), jnp.asarray(dl), jnp.asarray([20.0]), ratio)
        _close(a_t, a_j)
    w_t, tr_t = trays.weights_and_transmittance_from_alphas(a_t)
    w_j, tr_j = jrays.weights_and_transmittance_from_alphas(a_j)
    _close(w_t, w_j)
    _close(tr_t, tr_j)
    dens = RNG.uniform(0, 5, (n, s, 1)).astype(np.float32)
    _close(trays.weights_from_densities(_t(dens), _t(dl)), jrays.weights_from_densities(jnp.asarray(dens), jnp.asarray(dl)))


def test_proposal_sample_with_the_same_jitters():
    bj, bt = _bundles(24)
    bj, bt = jscene.sphere_collider(bj), tscene.sphere_collider(bt)
    cfg_j = jprop.ProposalSamplerConfig(num_proposal_samples=(16, 8), num_final_samples=6)
    cfg_t = to_torch_config(cfg_j)

    def dens_j(p):
        return jnp.exp(-jnp.sum(p**2, -1, keepdims=True) * 3.0) * 20.0

    def dens_t(p):
        return torch.exp(-torch.sum(p**2, -1, keepdim=True) * 3.0) * 20.0

    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 3)
    jit = [_t(jax.random.uniform(k, (24, 1))) for k in keys]
    for step in (None, 0.0, 300.0):
        rs_j, wl_j, _ = jprop.proposal_sample(key, bj, [dens_j] * 2, cfg_j, train=True,
                                              step=None if step is None else jnp.float32(step))
        rs_t, wl_t, _ = tprop.proposal_sample(bt, [dens_t] * 2, cfg_t, train=True, step=step, jitters=jit)
        _close(rs_t.starts, rs_j.starts, atol=2e-6)
        _close(rs_t.spacing_ends, rs_j.spacing_ends, atol=2e-6)
        for a, b in zip(wl_t, wl_j):
            _close(a, b, atol=2e-6)
    rs_j, _, _ = jprop.proposal_sample(None, bj, [dens_j] * 2, cfg_j, train=False)
    rs_t, _, _ = tprop.proposal_sample(bt, [dens_t] * 2, cfg_t, train=False)
    _close(rs_t.ends, rs_j.ends, atol=2e-6)


def test_lambertian_composite_and_gradients():
    n, s, d = 6, 5, 12
    alb = RNG.uniform(size=(n, s, 3)).astype(np.float32)
    nrm = RNG.normal(size=(n, s, 3)).astype(np.float32)
    dirs = RNG.normal(size=(d, 3)).astype(np.float32)
    light = RNG.uniform(0, 3, (n, d, 3)).astype(np.float32)
    bg = RNG.uniform(size=(n, 3)).astype(np.float32)
    w = RNG.uniform(0, 0.2, (n, s, 1)).astype(np.float32)
    vis = RNG.uniform(size=(n, 1, d)).astype(np.float32)
    for v in (None, vis):
        args_j = [jnp.asarray(a) for a in (alb, nrm, dirs, light)] + [None if v is None else jnp.asarray(v),
                                                                       jnp.asarray(bg), jnp.asarray(w)]
        args_t = [_t(a).requires_grad_(True) for a in (alb, nrm, dirs, light)] + [None if v is None else _t(v),
                                                                                   _t(bg), _t(w)]
        for clip in (False, True):
            _close(tlam.lambertian_composite(*args_t, clip_output=clip), jlam.lambertian_composite(*args_j, clip_output=clip))
        tlam.lambertian_composite(*args_t).sum().backward()
        g_j = jax.grad(lambda a, b, l: jnp.sum(jlam.lambertian_composite(a, b, args_j[2], l, *args_j[4:])),
                       argnums=(0, 1, 2))(args_j[0], args_j[1], args_j[3])
        for gt, gj in zip((args_t[0].grad, args_t[1].grad, args_t[3].grad), g_j):
            _close(gt, gj, atol=1e-5)


def test_scene_losses_and_their_gradients():
    n = 40
    img = RNG.uniform(size=(n, 3)).astype(np.float32)
    img[:5] = 1.0
    pred = RNG.uniform(size=(n, 3)).astype(np.float32)
    pred[:5] = 1.0  # exact ties: the |x| gradient at 0 follows JAX (+1)
    mask = (RNG.uniform(size=(n, 1)) > 0.5).astype(np.float32)
    grads = RNG.normal(size=(n, 7, 3)).astype(np.float32)
    cases = {
        "l1": (lambda m, p: m.l1_loss(p, img_(m)), pred),
        "eikonal": (lambda m, p: m.eikonal_loss(p), grads),
        "fg_mask": (lambda m, p: m.fg_mask_loss(p[:, :1], mask_(m)), pred),
        "sky_pixel": (lambda m, p: m.sky_pixel_loss(p, img_(m), mask_(m), 0.1), pred),
        "ground_plane": (lambda m, p: m.ground_plane_loss(p, mask_(m)[:, 0]), pred - 0.5),
        "hashgrid_density": (lambda m, p: m.hashgrid_density_loss(p - 0.5), pred),
    }

    def img_(m):
        return _t(img) if m is tloss else jnp.asarray(img)

    def mask_(m):
        return _t(mask) if m is tloss else jnp.asarray(mask)

    for name, (fn, x) in cases.items():
        xt = _t(x).requires_grad_(True)
        lt = fn(tloss, xt)
        lt.backward()
        lj, gj = jax.value_and_grad(lambda v: fn(jloss, v))(jnp.asarray(x))
        _close(lt, lj, err_msg=name) if False else _close(lt, lj)
        _close(xt.grad, gj, atol=1e-6)


def test_interlevel_loss_and_gradient():
    n, s0, s1 = 8, 12, 6

    def edges(k):
        e = np.sort(RNG.uniform(size=(n, k + 1)).astype(np.float32), axis=-1)
        return e[:, :-1, None], e[:, 1:, None]

    prop_s, prop_e = edges(s0)
    fin_s, fin_e = edges(s1)
    wp = RNG.uniform(size=(n, s0, 1)).astype(np.float32)
    wf = RNG.uniform(size=(n, s1, 1)).astype(np.float32)

    class S:
        def __init__(self, a, b):
            self.spacing_starts, self.spacing_ends = a, b

    wt = _t(wp).requires_grad_(True)
    lt = tloss.interlevel_loss([wt, _t(wf)], [S(_t(prop_s), _t(prop_e)), S(_t(fin_s), _t(fin_e))])
    lt.backward()
    f = lambda w: jloss.interlevel_loss(
        [w, jnp.asarray(wf)], [S(jnp.asarray(prop_s), jnp.asarray(prop_e)), S(jnp.asarray(fin_s), jnp.asarray(fin_e))])
    lj, gj = jax.value_and_grad(f)(jnp.asarray(wp))
    _close(lt, lj)
    _close(wt.grad, gj)
