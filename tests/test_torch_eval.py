"""The eval path of the PyTorch port against the JAX package, on the CPU:
the eval-mode forward (the sky of the eval latents, rotations), the
eval-latent loss, chunked renders and the eval batches
(``test_torch_eval_fit.py`` holds the test-time latent fit).

The config is ``test_torch_joint_slice``'s tiny joint config (DDF
visibility over 42 light directions) with the canonical RENI++ decoder and
its converted prior, 6 train and 2 eval latent slots.  The train and eval
latents differ (seeded draws around the prior's mean-sky latent), so a
forward that decodes the wrong group fails.  The scenes are the synthetic
train ring and the eval ring of ``tools/train_sanity.py`` (2 cameras at
π/8, height 0.5), 16 × 16 pixels; a fit step takes 2 × 16 region rays.

Tolerances: outputs, losses and the fitted eval group to 1e-4 relative
(of each array's largest entry), gradients to 1e-3 of scale; the port's
render equal to itself across chunk sizes to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neusky_tpu.configs.neusky_config import neusky_model_config as j_canonical
from neusky_tpu.data.datamanager import DataManager as JDataManager, DataManagerConfig as JDMConfig
from neusky_tpu.data.pixel_sampler import PixelSampler as JPixelSampler, PixelSamplerConfig as JPSConfig
from neusky_tpu.data.synthetic import SyntheticSceneConfig as JSceneConfig, generate_synthetic_scene as j_scene
from neusky_tpu.engine import checkpoint as j_ckpt
from neusky_tpu.engine import eval_loop as j_eval
from neusky_tpu.models.neusky import NeuSkyModel as JModel
from neusky_tpu.models.pipeline import eval_latent_loss_fn as j_eval_loss

from neusky_torch.data.datamanager import DataManager as TDataManager, DataManagerConfig as TDMConfig
from neusky_torch.data.pixel_sampler import PixelSampler as TPixelSampler, PixelSamplerConfig as TPSConfig
from neusky_torch.data.synthetic import SyntheticSceneConfig as TSceneConfig, generate_synthetic_scene as t_scene
from neusky_torch.engine import checkpoint as t_ckpt
from neusky_torch.engine import eval_loop as t_eval
from neusky_torch.models.neusky import NeuSkyModel as TModel
from neusky_torch.models.pipeline import batch_ray_bundle, eval_latent_loss_fn as t_eval_loss
from neusky_torch.ops import hashgrid
from neusky_torch.tree import tree_items, tree_map, unflatten
from test_torch_joint_slice import tiny_joint_config
from torch_parity import flat_jax, jax_forward_draws, jax_to_torch_params, max_rel_err, to_torch_config, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TRAIN_SCENE = dict(num_cameras=6, width=16, height=16)
EVAL_SCENE = dict(num_cameras=2, width=16, height=16, angle_offset=float(np.pi / 8.0), camera_height=0.5)
RAYS = (2, 16)  # images per batch, rays per image: 32 region rays a fit step
RTOL = 1e-4
GRAD_REL = 1e-3


def eval_config():
    canonical = j_canonical(6, 2)
    return dataclasses.replace(tiny_joint_config(False), illumination=canonical.illumination,
                               illumination_prior_dir=canonical.illumination_prior_dir,
                               num_train_data=6, num_eval_data=2)


def _prior_decoder(cfg_t):
    with np.load(t_ckpt.prior_asset_path(cfg_t)) as z:
        flat = {k: jnp.asarray(z[k]) for k in z.files if k.startswith("illumination_decoder/")}
    return unflatten(flat)["illumination_decoder"]


def eval_setup():
    """The JAX and port models of :func:`eval_config` and the same params
    (JAX's init, the converted prior decoder, seeded latents)."""
    cfg_j = eval_config()
    cfg_t = to_torch_config(cfg_j)
    jm, tm = JModel(cfg_j), TModel(cfg_t, device="cpu")
    params_j = dict(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    params_j["illumination_decoder"] = _prior_decoder(cfg_t)
    z_star = t_ckpt.prior_init_latent(cfg_t)
    g = np.random.default_rng(0)
    draw = lambda n: (z_star[None] + 0.3 * g.normal(size=(n, *z_star.shape))).astype(np.float32)
    params_j["illumination_field"] = {"train_latents": jnp.asarray(draw(6)),
                                      "train_scale": jnp.asarray(1.0 + 0.1 * g.normal(size=6), jnp.float32)}
    params_j["eval_latents"] = {"eval_latents": jnp.asarray(draw(2)),
                                "eval_scale": jnp.asarray(1.0 + 0.1 * g.normal(size=2), jnp.float32),
                                "eval_rotation": jnp.ones((2,), jnp.float32)}
    return dict(cfg_j=cfg_j, jm=jm, tm=tm, params_j=params_j, params_t=jax_to_torch_params(params_j))


@pytest.fixture(scope="module")
def setup():
    return eval_setup()


def make_datamanagers():
    """A fresh (JAX, port) pair over the same train and eval scenes."""
    js, je = j_scene(JSceneConfig(**TRAIN_SCENE)), j_scene(JSceneConfig(**EVAL_SCENE))
    ts, te = t_scene(TSceneConfig(**TRAIN_SCENE)), t_scene(TSceneConfig(**EVAL_SCENE))
    jdm = JDataManager(JDMConfig(pixel_sampler=JPSConfig(*RAYS), num_sky_rays=8),
                       js["cameras"], js["images"], js["masks"],
                       eval_cameras=je["cameras"], eval_images=je["images"], eval_masks=je["masks"])
    tdm = TDataManager(TDMConfig(pixel_sampler=TPSConfig(*RAYS), num_sky_rays=8),
                       ts["cameras"], ts["images"], ts["masks"],
                       eval_cameras=te["cameras"], eval_images=te["images"], eval_masks=te["masks"], device="cpu")
    return jdm, tdm


def _fit_batch_pair(image_idx):
    jdm, tdm = make_datamanagers()
    jb = jdm.eval_latent_batch(image_idx)
    tb = t_eval._stack_batches([tdm.eval_latent_batch(image_idx)], "cpu", squeeze=True)
    return jb, tb


def _jax_rays(jb):
    return jb["cameras"].generate_rays_at(jnp.asarray(jb["cam_idx"]), jnp.asarray(jb["pixel_coords"]))


def _eval_group_only(params_t):
    """Detached params whose eval group alone requires gradients."""
    p = tree_map(lambda t: t.detach(), params_t)
    p["eval_latents"] = {k: v.clone().requires_grad_(True) for k, v in p["eval_latents"].items()}
    return p


def _count_scatters(monkeypatch):
    calls = []
    dispatch = hashgrid.scatter_levels
    monkeypatch.setattr(hashgrid, "scatter_levels", lambda r, v, t: calls.append(r.shape) or dispatch(r, v, t))
    return calls


# ---------------------------------------------------------------------------
# the eval-mode forward


def test_eval_forward_uses_eval_latents(setup):
    """``forward(train=False)`` and ``forward(train=True,
    fitting_eval_latents=True)`` decode the sky from the eval latents, as
    JAX does: ``rgb`` and ``hdr_background_colours`` agree to 1e-4, and
    the train latents would not."""
    jm, tm, pj, pt = setup["jm"], setup["tm"], setup["params_j"], setup["params_t"]
    jb, tb = _fit_batch_pair(1)
    rb_j, rb_t = _jax_rays(jb), batch_ray_bundle(tb)
    idx_j, ridx_j = jnp.asarray(jb["image_indices"]), jnp.asarray(jb["ray_image_idx"])
    key = jax.random.PRNGKey(3)
    n = rb_t.num_rays
    cases = {
        "eval": (dict(train=False), {}),
        "fitting": (dict(train=True, fitting_eval_latents=True), jax_forward_draws(setup["cfg_j"], key, n)),
    }
    for name, (kw, draws) in cases.items():
        keys = ("rgb", "hdr_background_colours")
        out_j = jax.jit(lambda p: {k: v for k, v in jm.forward(p, key, rb_j, idx_j, ridx_j, step=jnp.asarray(10.0),
                                                               **kw).items() if k in keys})(pj)
        out_t = tm.forward(pt, rb_t, tb["image_indices"], tb["ray_image_idx"], step=10.0, draws=draws, **kw)
        for k in keys:
            err = max_rel_err(out_t[k].detach().numpy(), out_j[k])
            assert err < RTOL, (name, k, err)
    swapped = {**pt, "eval_latents": {**pt["eval_latents"], "eval_latents": pt["illumination_field"]["train_latents"][:2]}}
    wrong = tm.forward(swapped, rb_t, tb["image_indices"], tb["ray_image_idx"], train=False)
    assert max_rel_err(wrong["hdr_background_colours"].numpy(), out_j["hdr_background_colours"]) > 1e-2


def _rotations(n, seed):
    g = np.random.default_rng(seed)
    q, r = np.linalg.qr(g.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0] *= -1.0
    return q.astype(np.float32)


@pytest.mark.parametrize("per_image", [False, True], ids=["one_3x3", "per_image_Ux3x3"])
def test_rotation_through_the_reni_decoder(setup, per_image):
    """A sky rotation, [3, 3] or one [3, 3] per image, through the RENI
    decoder and through ``sample_illumination`` (2 images, eval mode)."""
    jm, tm, pj, pt = setup["jm"], setup["tm"], setup["params_j"], setup["params_t"]
    g = np.random.default_rng(5)
    m = 40
    dirs = g.normal(size=(m, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    lat = np.asarray(pj["eval_latents"]["eval_latents"])[g.integers(0, 2, m)]
    scale = (1.0 + 0.1 * g.normal(size=m)).astype(np.float32)
    rot = _rotations(m, 1) if per_image else _rotations(1, 1)[0]
    want = jax.jit(jm.illumination.apply)(pj["illumination_decoder"], jnp.asarray(dirs), jnp.asarray(lat),
                                          jnp.asarray(scale), jnp.asarray(rot))["rgb"]
    got = tm.illumination.apply(pt["illumination_decoder"], torch.from_numpy(dirs), torch.from_numpy(lat),
                                torch.from_numpy(scale), torch.from_numpy(rot))["rgb"]
    assert max_rel_err(got.numpy(), want) < RTOL
    unrotated = tm.illumination.apply(pt["illumination_decoder"], torch.from_numpy(dirs), torch.from_numpy(lat),
                                      torch.from_numpy(scale))["rgb"]
    assert max_rel_err(unrotated.numpy(), want) > 1e-2

    jb, tb = _fit_batch_pair(0)
    image_indices, ray_image_idx = np.array([1, 0], np.int32), (np.arange(32) % 2).astype(np.int32)
    rot_u = _rotations(2, 2) if per_image else _rotations(1, 2)[0]
    out_j = jax.jit(lambda p, rb, r: jm.sample_illumination(
        p, None, rb, jnp.asarray(image_indices), jnp.asarray(ray_image_idx), train=False, rotation=r))(
        pj, _jax_rays(jb), jnp.asarray(rot_u))
    out_t = tm.sample_illumination(pt, batch_ray_bundle(tb), torch.from_numpy(image_indices).long(),
                                   torch.from_numpy(ray_image_idx).long(), train=False,
                                   rotation=torch.from_numpy(rot_u))
    for name, a, b in zip(("dirs", "hdr_light", "hdr_background"), out_t, out_j):
        assert max_rel_err(a.numpy(), b) < RTOL, name


# ---------------------------------------------------------------------------
# the eval-latent loss, the render and the fit


def test_eval_latent_loss_matches_jax(setup, monkeypatch):
    """Value, and gradient into the eval group; no other leaf gets one and
    no hash-table gradient is scattered."""
    jm, tm, pj, pt = setup["jm"], setup["tm"], setup["params_j"], setup["params_t"]
    jb, tb = _fit_batch_pair(1)
    key = jax.random.PRNGKey(6)
    total_j, grads_j = jax.jit(jax.value_and_grad(lambda p: j_eval_loss(jm, p, key, jb, jnp.asarray(3.0))))(pj)
    calls = _count_scatters(monkeypatch)
    p = _eval_group_only(pt)
    total_t = t_eval_loss(tm, p, tb, 3.0)
    total_t.backward()
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=RTOL)
    gj = flat_jax(grads_j)
    for k, v in tree_items(p):
        if k.startswith("eval_latents/"):
            if np.abs(gj[k]).max() == 0:
                assert v.grad is None or float(v.grad.abs().max()) == 0, k
            else:
                assert max_rel_err(v.grad.numpy(), gj[k]) < GRAD_REL, (k, max_rel_err(v.grad.numpy(), gj[k]))
        else:
            assert v.grad is None, k
    assert np.abs(gj["eval_latents/eval_latents"]).max() > 0 and calls == []


def test_render_camera_matches_jax(setup, monkeypatch):
    """A 16 × 16 eval image in chunks of 64 (JAX, the port) and of 100 (the
    port, a short last chunk of 56 rays): no chunk boundary shows."""
    jm, tm, pj, pt = setup["jm"], setup["tm"], setup["params_j"], setup["params_t"]
    jdm, tdm = make_datamanagers()
    out_j = j_eval.render_camera(jm, pj, jdm.eval_image_bundle(1)[0], 1, jax.random.PRNGKey(2), chunk_size=64)
    calls = _count_scatters(monkeypatch)
    rb = tdm.eval_image_bundle(1)[0]
    out_a = t_eval.render_camera(tm, pt, rb, 1, chunk_size=64)
    out_b = t_eval.render_camera(tm, pt, rb, 1, chunk_size=100)
    assert sorted(out_a) == sorted(out_j) == sorted(t_eval.RENDER_KEYS) and calls == []
    for k in out_j:
        assert out_a[k].shape == out_j[k].shape == (256, out_j[k].shape[1])
        assert max_rel_err(out_a[k], out_j[k]) < RTOL, (k, max_rel_err(out_a[k], out_j[k]))
        np.testing.assert_allclose(out_b[k], out_a[k], rtol=0, atol=1e-6, err_msg=k)


def test_prior_init_latent_matches_jax(setup):
    """``"auto"`` resolves to the same mean-sky latent on both sides (the
    port reads it from its converted prior asset)."""
    want = j_ckpt.prior_init_latent(setup["cfg_j"])
    got = t_ckpt.prior_init_latent(setup["tm"].config)
    assert want is not None and np.array_equal(got, want)
    assert t_ckpt.prior_init_latent(dataclasses.replace(setup["tm"].config, illumination_prior_dir=None)) is None


def test_average_eval_metrics_renders_every_eval_image(setup):
    tm, pt = setup["tm"], setup["params_t"]
    _, tdm = make_datamanagers()
    avg = t_eval.average_eval_metrics(tm, pt, tdm, chunk_size=128, fit_latents_first=False)
    per = [t_eval.eval_image_metrics(tm, pt, tdm, i, chunk_size=128) for i in range(2)]
    assert sorted(avg) == sorted(["psnr", "ssim", "lpips", "mse", "num_rays_per_sec", "fps"])
    np.testing.assert_allclose(avg["psnr"], np.mean([m["psnr"] for m in per]), rtol=1e-6)
    assert per[0]["outputs"]["rgb"].shape == (256, 3) and avg["num_rays_per_sec"] > 0


# ---------------------------------------------------------------------------
# eval batches


@pytest.mark.parametrize("region", ["left_image_half", "right_image_half", "full_image"])
def test_sample_region_batch_matches_jax(region):
    scene = j_scene(JSceneConfig(**EVAL_SCENE))
    js = JPixelSampler(JPSConfig(*RAYS), scene["cameras"], scene["images"], scene["masks"], seed=3)
    ts = TPixelSampler(TPSConfig(*RAYS), scene["images"], scene["masks"], seed=3)
    for image_row in (1, 0, 1):
        want, got = js.sample_region_batch(image_row, region), ts.sample_region_batch(image_row, region)
        assert sorted(got) == sorted(k for k in want if k != "cameras")
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    xs = got["pixel_coords"][:, 1]
    assert (xs < 8).all() if region == "left_image_half" else (xs > 8).all() if region == "right_image_half" else True


def test_reseed_batch_stream_matches_jax():
    """After ``reseed(step)`` both draw the stream of
    ``default_rng((seed, step))``, whatever they drew before."""
    jdm, tdm = make_datamanagers()
    jdm.next_train(0)
    for step in (7, 1234):
        jdm.reseed(step)
        tdm.reseed(step)
        for _ in range(2):
            want, got = jdm.next_train(step), tdm.next_train(step)
            for k in ("image_indices", "ray_image_idx", "cam_idx", "pixel_coords", "image", "mask",
                      "sky_cam_idx", "sky_pixel_coords"):
                np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert tdm.num_train == 6 and tdm.num_eval == 2
