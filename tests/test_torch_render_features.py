"""The port's rotations about z, equirectangular cameras, Blinn-Phong
compositing and render features (``engine/render_features.py``: the sun
shadow map, the sky-visibility probe, a frame of the illumination-rotation
animation) against the JAX package on the CPU, from the same inputs (numpy,
seeded) and the same converted parameters.

Model: the tiny recipe (``tiny_model_config``) with the DDF's FiLM inputs in
float32 (``use_bf16_compute=False``; the bf16 path is held by
``tests/test_torch_joint_slice.py``).  The eval forward draws nothing.

Tolerances: rotations, rays and the compositor's values to 1e-6 (float32);
the compositor's gradients to 1e-5 of each array's scale; shadow maps,
probes and frames to 2e-5 absolute (float32 sums in another order through
the proposal sampler, the SDF field and the DDF).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.configs.tiny_config import tiny_model_config as j_tiny
from neusky_tpu.core import cameras as jcam, spherical as jsph
from neusky_tpu.engine import render_features as j_rf
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.shading import lambertian as jlam

from neusky_torch.core import cameras as tcam, spherical as tsph
from neusky_torch.engine import render_features as t_rf
from neusky_torch.models.neusky import NeuSkyModel as TModel
from neusky_torch.shading import lambertian as tlam
from torch_parity import jax_to_torch_params, jitted, max_rel_err, one_torch_thread, to_torch_config  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(5)
MAP_ATOL = 2e-5


def fp32_tiny(num_train=2, num_eval=1):
    cfg = j_tiny(num_train, num_eval)
    return dataclasses.replace(cfg, ddf=dataclasses.replace(
        cfg.ddf, field=dataclasses.replace(cfg.ddf.field, use_bf16_compute=False)))


@pytest.fixture(scope="module")
def pair():
    cfg_j = fp32_tiny()
    jm = JModel(cfg_j)
    params_j = jax.jit(jm.init)(jax.random.PRNGKey(0))
    # non-zero sky latents: the sky of zero latents is symmetric about z
    lat = params_j["eval_latents"]["eval_latents"]
    params_j["eval_latents"]["eval_latents"] = jnp.asarray(0.5 * RNG.normal(size=lat.shape), jnp.float32)
    tm = TModel(to_torch_config(cfg_j), device="cpu")
    return jm, params_j, tm, jax_to_torch_params(params_j)


def _camera_pair(res=8, dist=1.2, height=0.4):
    c2w = np.array(jsph.look_at_target(jnp.asarray([[dist, 0.3, height]], jnp.float32), jnp.zeros((1, 3))))[:, :3]
    kw = dict(width=res, height=res)
    jc = jcam.Cameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.full((1,), 0.9 * res), fy=jnp.full((1,), 0.9 * res),
                      cx=jnp.full((1,), res / 2.0), cy=jnp.full((1,), res / 2.0), **kw)
    tc = tcam.Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.full((1,), 0.9 * res),
                      fy=torch.full((1,), 0.9 * res), cx=torch.full((1,), res / 2.0), cy=torch.full((1,), res / 2.0),
                      **kw)
    return jc.generate_rays(0), tc.generate_rays(0)


# ---------------------------------------------------------------------------
# rotations and cameras


@pytest.mark.parametrize("gamma", [0.7, -2.5, [0.0, 1.0, 3.0], [[0.3, 4.0], [-1.0, 6.2]]])
def test_rot_z_matches_jax(gamma):
    got = tsph.rot_z(torch.tensor(gamma, dtype=torch.float32)).numpy()
    want = np.asarray(jsph.rot_z(jnp.asarray(gamma, jnp.float32)))
    assert got.shape == want.shape == np.shape(gamma) + (3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsph.rot_z(gamma).numpy(), got)  # Python floats and lists too


def test_equirect_camera_rays_match_jax():
    """A 32 × 64 panorama from a rotated, translated camera: origins,
    directions, norms and pixel areas as JAX's; the nerfstudio y-up frame
    (top rows look up the camera's +y)."""
    h, w = 32, 64
    c2w = np.array(jsph.look_at_target(jnp.asarray([[0.5, -1.0, 0.3]], jnp.float32), jnp.zeros((1, 3))))[:, :3]
    kw = dict(width=w, height=h, camera_type=int(jcam.CameraType.EQUIRECTANGULAR))
    rb_j = jcam.Cameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.ones(1), fy=jnp.ones(1), cx=jnp.full((1,), w / 2.0),
                        cy=jnp.full((1,), h / 2.0), **kw).generate_rays(0)
    rb_t = tcam.Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.ones(1), fy=torch.ones(1),
                        cx=torch.full((1,), w / 2.0), cy=torch.full((1,), h / 2.0), **kw).generate_rays(0)
    for name in ("origins", "directions", "directions_norm", "pixel_area"):
        np.testing.assert_allclose(getattr(rb_t, name).numpy(), np.asarray(getattr(rb_j, name)), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    up = c2w[0, :3, 1]
    dirs = rb_t.directions.numpy().reshape(h, w, 3)
    assert np.allclose(np.linalg.norm(dirs, axis=-1), 1.0, atol=1e-5)
    assert (dirs[0] @ up).mean() > 0.9 and (dirs[-1] @ up).mean() < -0.9


def test_unknown_camera_type_raises():
    with pytest.raises(ValueError, match="unknown camera type"):
        tcam.Cameras(camera_to_worlds=torch.eye(4)[None, :3], fx=torch.ones(1), fy=torch.ones(1), cx=torch.ones(1),
                     cy=torch.ones(1), width=2, height=2, camera_type=7).generate_rays(0)


# ---------------------------------------------------------------------------
# Blinn-Phong


def _shading_inputs(n=5, s=4, d=9):
    nrm = RNG.normal(size=(n, s, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dirs = RNG.normal(size=(d, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    view = RNG.normal(size=(n, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    return dict(
        albedos=RNG.uniform(0, 1, (n, s, 3)).astype(np.float32), normals=nrm, light_directions=dirs,
        light_colours=RNG.uniform(0, 3, (n, d, 3)).astype(np.float32),
        background_illumination=RNG.uniform(0, 1, (n, 3)).astype(np.float32),
        weights=RNG.uniform(0, 0.3, (n, s, 1)).astype(np.float32),
        shininess=RNG.uniform(1, 20, (n, s, 1)).astype(np.float32), view_dirs_world=view,
    )


@pytest.mark.parametrize("vis", [None, "ray", "sample"])
@pytest.mark.parametrize("clip", [False, True])
def test_blinn_phong_composite_matches_jax(vis, clip):
    """Values and the gradients of every input of a weighted sum of the
    pixels (mirror of ``tests/test_shading.py:53``)."""
    x = _shading_inputs()
    n, s, d = x["albedos"].shape[0], x["albedos"].shape[1], x["light_directions"].shape[0]
    if vis is not None:
        x["visibility"] = RNG.uniform(0, 1, (n, 1 if vis == "ray" else s, d)).astype(np.float32)
    names = list(x)
    wsum = RNG.normal(size=(n, 3)).astype(np.float32)

    def j_fn(*args):
        kw = dict(zip(names, args))
        return jlam.blinn_phong_composite(visibility=kw.pop("visibility", None), clip_output=clip, **kw)

    want = j_fn(*[jnp.asarray(x[k]) for k in names])
    grads_j = jax.grad(lambda *a: jnp.sum(j_fn(*a) * wsum), argnums=tuple(range(len(names))))(
        *[jnp.asarray(x[k]) for k in names])
    ts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in x.items()}
    kw = dict(ts)
    got = tlam.blinn_phong_composite(visibility=kw.pop("visibility", None), clip_output=clip, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    (got * torch.from_numpy(wsum)).sum().backward()
    for k, g in zip(names, grads_j):
        assert max_rel_err(ts[k].grad.numpy(), g) < 1e-5, (k, max_rel_err(ts[k].grad.numpy(), g))
    # the specular lobe brightens the count-normalised Lambertian (JAX's check)
    lam = tlam.lambertian_composite(*(ts[k] for k in ("albedos", "normals", "light_directions", "light_colours")),
                                    ts.get("visibility"), ts["background_illumination"], ts["weights"],
                                    clip_output=clip)
    assert bool(torch.all(got >= lam - 1e-5))


# ---------------------------------------------------------------------------
# render features


def test_render_shadow_map_matches_jax(pair):
    """Camera rays at an 8 × 8 view, a low sigmoid scale and threshold 0 so
    the untrained DDF's visibility is not saturated; the accumulation mask
    and JAX's keys."""
    jm, params_j, tm, params_t = pair
    rb_j, rb_t = _camera_pair()
    kw = dict(azimuth_deg=30.0, elevation_deg=50.0, threshold=0.0, sigmoid_scale=5.0, accumulation_mask_threshold=0.15)
    want = jitted(j_rf.render_shadow_map, jm, params_j, rb_j, jax.random.PRNGKey(7), **kw)
    got = t_rf.render_shadow_map(tm, params_t, rb_t, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (64,)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=MAP_ATOL, err_msg=k)
    masked = got["accumulation"] <= 0.15
    assert got["shadow_map"][~masked].std() > 1e-3 and masked.any() and (~masked).any()
    assert np.all(got["shadow_map"][masked] == 0)


def test_render_shadow_probe_matches_jax(pair):
    jm, params_j, tm, params_t = pair
    pos = np.array([0.1, -0.2, 0.3], np.float32)
    kw = dict(side_length=16, threshold=0.0, sigmoid_scale=5.0)
    want = jitted(j_rf.render_shadow_probe, jm, params_j, pos, jax.random.PRNGKey(0), **kw)
    got = t_rf.render_shadow_probe(tm, params_t, pos, **kw)
    assert got.shape == want.shape == (8, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=MAP_ATOL)
    assert got.std() > 1e-3


def test_rotated_animation_frame_matches_jax(pair, tmp_path):
    """Frame 1 of 4 (the sky turned 90° about z) over an 8 × 8 view, as
    JAX renders it; a second call reads the frame back from its cache, and
    the sequence file holds the frames."""
    jm, params_j, tm, params_t = pair
    rb_j, rb_t = _camera_pair()
    cfg = dict(num_frames=4, chunk_size=64, start_frame=1, end_frame=2)
    want = j_rf.render_illumination_animation(
        jm, params_j, rb_j, 0, jax.random.PRNGKey(0), j_rf.AnimationConfig(output_dir=str(tmp_path / "j"), **cfg))
    got = t_rf.render_illumination_animation(tm, params_t, rb_t, 0,
                                             t_rf.AnimationConfig(output_dir=str(tmp_path / "t"), **cfg))
    assert got.shape == want.shape == (1, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=MAP_ATOL)
    unrotated = t_rf.render_illumination_animation(
        tm, params_t, rb_t, 0, t_rf.AnimationConfig(output_dir=str(tmp_path / "t0"), num_frames=4, chunk_size=64,
                                                     end_frame=1))
    assert np.abs(unrotated - got).max() > 1e-4  # the rotation reaches the sky
    cached = tmp_path / "t" / "render_frames" / "frame_1.npy"
    np.save(cached, np.zeros_like(got[0]))
    again = t_rf.render_illumination_animation(tm, params_t, rb_t, 0,
                                               t_rf.AnimationConfig(output_dir=str(tmp_path / "t"), **cfg))
    assert np.all(again == 0)
    with np.load(tmp_path / "t" / "render_sequence.npz") as z:
        assert np.all(z["rgb"] == 0) and z["rgb"].shape == (1, 64, 3)
